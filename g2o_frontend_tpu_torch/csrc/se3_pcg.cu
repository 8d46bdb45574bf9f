// The SE3 pose graph's inner PCG for NVIDIA Hopper (sm_90a), CUDA C++ with a
// plain C interface (loaded with ctypes by g2o_frontend_tpu_torch/ops/se3_pcg.py).
//
// Replaces: no Pallas kernel. The JAX package runs this loop as XLA's
// while_loop (g2o_frontend_tpu/solvers/pcg.py `pcg` under
// g2o_frontend_tpu/solvers/pose_graph.py `optimize_se3`). The port ran it
// as CUDA graphs of pcg.BLOCK masked steps, one host read a block: a masked
// step with the chain preconditioner was ~190 dependent small kernels at
// 1,024 poses (cyclic reduction's batched 6x6 products, concatenations and
// stacks, the Hessian-vector product's gathers and sums, dots and axpys).
//
// What it computes: one LM iteration's whole inner PCG, start included
// (x0 = 0, r0 = b, z0 = M^-1 r0, p0 = z0, tol2 = rtol^2 max(r0.z0, 1e-30)),
// then steps while k < max_iters and r.z > tol2, each step as
// solvers/pcg.cg_step with ops/se3_pcg.py's `hvp` and `precondition`. It
// writes x, r, p, r.z and the step count k, as the masked loop leaves its
// carry. The product is taken in block-sparse form: with v' = v on free
// poses and 0 on the others,
//   (H v)_n = (1 + lam) Dp_n v'_n + sum_{e: i(e) = n} B_e v'_j(e)
//             + sum_{e: j(e) = n} B_e^T v'_i(e)     on free poses, else 0,
// B_e = Ji^T W Jj, which the wrapper forms once an LM iteration: the same
// sums as the plain version's edge terms, grouped otherwise (Dp is the
// sum of the edges' Ji^T W Ji and Jj^T W Jj). M^-1 is the block-Jacobi
// inverses or the chain's block-tridiagonal factor
// (solvers/tridiag.cr_factor) solved by cyclic reduction.
//
// What bounds it on this card: one step reads B (144 B an edge), Dp (144 B
// a pose) and the preconditioner (the factor's five 6x6 blocks per odd row
// and level, ~720 B a pose over all levels, or one inverse a pose): ~1.2
// MB a step at 1,024 poses and 2,048 edges, L2-resident (50 MB) across the
// steps. The steps depend on one another through two dot products each and
// cyclic reduction's 2 log2(n) levels: a chain of ~30 dependent phases of
// a few thousand independent items each, so the latency of each phase's
// reads from L2, not bandwidth, bounds it.
//
// Design: one block of kThreads threads a launch walks every step, with
// __syncthreads between dependent phases; no launch, graph node or host
// read inside the loop.
// - The node vectors x, r, p, Hp, the preconditioner's work vector z
//   (n >= NP rows for the chain) and the free mask live in shared memory
//   where they fit, and the edges' 12 product terms too; otherwise in a
//   scratch buffer the wrapper allocates. The wrapper decides from NP, n and
//   EP (ops/se3_pcg.layout).
// - The product in two phases: a thread per (edge, component) forms
//   (B_e v'_j)_c and (B_e^T v'_i)_c and stores them at the edge's rank in
//   the SegmentIndex order of its first and of its second pose (pos_i,
//   pos_j), so that a thread per (pose, component) then adds a contiguous
//   run of each, from +0.0 in that order, with no atomics, beside
//   (1 + lam) Dp_n v'_n.
// - Cyclic reduction in place on z, stride 2^l at level l: the down-sweep a
//   thread per (even row, component), the root, the up-sweep a lane per
//   (odd row, component) in groups of 8 lanes that exchange the row's
//   right-hand side by shuffles (each lane reads and writes only its own
//   component of its row), a barrier after each level. A thread's loads of
//   a level are one row of each 6x6 block: one round trip to L2. The
//   factor's levels come packed in one buffer, level l at 180 (n - n/2^l)
//   floats: dinv, l, u, a, c of its n/2^(l+1) odd rows, then the root's
//   inverse.
// - Dot products: each thread adds its items in a fixed order, then warp
//   shuffles and one pass over the warps' partials, the same tree every
//   launch. So two launches on the same inputs agree bit for bit. The order
//   of the sums is not the plain version's: the kernel agrees with it to
//   float32 rounding, not bit for bit.
// - 512 threads leave 128 registers a thread (1,024 left 64 and spilled
//   ~1 KB a thread); the item loops are unrolled so that a thread's loads
//   of several items are in flight together.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRed = 2 * 32;  // two slots of per-warp partials, used in turn
constexpr int kMaxSmem = 227 * 1024;
constexpr int kTerms = 12;  // an edge's (B v'_j) and (B^T v'_i)

struct Args {
  const float* __restrict__ B;         // (EP, 36) Ji^T W Jj
  const int32_t* __restrict__ ends;    // (EP, 2) poses i, j of each edge
  const int32_t* __restrict__ pos_i;   // (EP,) each edge's rank in the order by first pose
  const int32_t* __restrict__ pos_j;   // (EP,) and by second pose
  const int32_t* __restrict__ offsets_i;  // (NP + 1,) the first poses' runs in that order
  const int32_t* __restrict__ offsets_j;  // (NP + 1,)
  const float* __restrict__ Dp;        // (NP, 36) the undamped block diagonal
  const float* __restrict__ lam;       // (1,)
  const float* __restrict__ free_;     // (NP,) 1 free, 0 fixed or padded
  const float* __restrict__ pre;       // (NP, 36) inverses, or the packed chain factor
  const float* __restrict__ b;         // (NP, 6)
  float* x;                            // (NP, 6) out
  float* r;                            // (NP, 6) out
  float* p;                            // (NP, 6) out
  float* rz;                           // (1,) out
  int64_t* k;                          // (1,) out
  float* scratch;                      // the vectors and terms that are not in shared memory
  int NP, EP, n, chain, max_iters;
  float rtol2;
  int vec_shared, terms_shared;
};

// The sum of every thread's `v`, in the same order every launch, returned
// to every thread. `slot` holds kWarps floats; a slot is written again only
// after a later barrier.
__device__ __forceinline__ float block_sum(float v, float* slot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if (lane == 0) slot[warp] = v;
  __syncthreads();
  float w = lane < kWarps ? slot[lane] : 0.f;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) w += __shfl_down_sync(0xffffffffu, w, off);
  return __shfl_sync(0xffffffffu, w, 0);
}

// The edges' product terms: TI at rank pos_i[e] holds (B_e v'_j)_c, TJ at
// pos_j[e] holds (B_e^T v'_i)_c.
__device__ __forceinline__ void edge_terms(const Args& a, const float* P, const float* F, float* TI, float* TJ) {
#pragma unroll 4
  for (int q = threadIdx.x; q < 6 * a.EP; q += kThreads) {
    const int e = q / 6, c = q - 6 * e;
    const int i = a.ends[2 * e], j = a.ends[2 * e + 1];
    const float* Be = a.B + 36 * e;
    const float fi = F[i], fj = F[j];
    float ti = 0.f, tj = 0.f;
#pragma unroll
    for (int m = 0; m < 6; ++m) {
      ti += Be[6 * c + m] * (P[6 * j + m] * fj);
      tj += Be[6 * m + c] * (P[6 * i + m] * fi);
    }
    TI[6 * a.pos_i[e] + c] = ti;
    TJ[6 * a.pos_j[e] + c] = tj;
  }
}

// Hp = H p for every (pose, component); returns this thread's part of p.Hp.
__device__ __forceinline__ float node_products(const Args& a, float one_lam, const float* P, const float* F,
                                               const float* TI, const float* TJ, float* HP) {
  float part = 0.f;
#pragma unroll 4
  for (int q = threadIdx.x; q < 6 * a.NP; q += kThreads) {
    const int node = q / 6, c = q - 6 * node;
    const float* D = a.Dp + 36 * node + 6 * c;
    const int i0 = a.offsets_i[node], i1 = a.offsets_i[node + 1];
    const int j0 = a.offsets_j[node], j1 = a.offsets_j[node + 1];
    const float f = F[node];
    float dv = 0.f;
#pragma unroll
    for (int m = 0; m < 6; ++m) dv += D[m] * (P[6 * node + m] * f);
    float s1 = 0.f, s2 = 0.f;
    for (int m = i0; m < i1; ++m) s1 += TI[6 * m + c];
    for (int m = j0; m < j1; ++m) s2 += TJ[6 * m + c];
    const float out = f * ((s1 + s2) + one_lam * dv);
    HP[q] = out;
    part += P[q] * out;
  }
  return part;
}

// z = M^-1 r, then a barrier.
__device__ __forceinline__ void precondition(const Args& a, const float* R, float* Z) {
  const int NP6 = 6 * a.NP;
  if (!a.chain) {
#pragma unroll 4
    for (int q = threadIdx.x; q < NP6; q += kThreads) {
      const int node = q / 6, c = q - 6 * node;
      const float* M = a.pre + 36 * node + 6 * c;
      float z = 0.f;
#pragma unroll
      for (int j = 0; j < 6; ++j) z += M[j] * R[6 * node + j];
      Z[q] = z;
    }
    __syncthreads();
    return;
  }
  const int n = a.n;
  for (int q = threadIdx.x; q < 6 * n; q += kThreads) Z[q] = q < NP6 ? R[q] : 0.f;
  __syncthreads();
  const int levels = 31 - __clz(n);
  // down-sweep: even row k of level l (at 2k s) takes a_k ro_{k-1} + c_k ro_k
  for (int l = 0; l < levels; ++l) {
    const int s = 1 << l, h = n >> (l + 1);
    const float* lev = a.pre + static_cast<size_t>(180) * (n - (n >> l));
    const float* A = lev + 3 * 36 * h;
    const float* C = lev + 4 * 36 * h;
#pragma unroll 3
    for (int q = threadIdx.x; q < 6 * h; q += kThreads) {
      const int k = q / 6, c = q - 6 * k;
      const float* Ar = A + 36 * k + 6 * c;
      const float* Cr = C + 36 * k + 6 * c;
      float* ze = Z + 6 * (2 * k * s);
      const float* zo = Z + 6 * ((2 * k + 1) * s);
      const float* zl = Z + 6 * ((2 * k - 1) * s);
      float acc = ze[c];
      if (k > 0) {
        float t = 0.f;
#pragma unroll
        for (int j = 0; j < 6; ++j) t += Ar[j] * zl[j];
        acc = acc + t;
      }
      float t = 0.f;
#pragma unroll
      for (int j = 0; j < 6; ++j) t += Cr[j] * zo[j];
      ze[c] = acc + t;
    }
    __syncthreads();
  }
  {
    const float* root = a.pre + static_cast<size_t>(180) * (n - 1);
    float v = 0.f;
    if (threadIdx.x < 6) {
#pragma unroll
      for (int j = 0; j < 6; ++j) v += root[6 * threadIdx.x + j] * Z[j];
    }
    __syncthreads();
    if (threadIdx.x < 6) Z[threadIdx.x] = v;
    __syncthreads();
  }
  // up-sweep: odd row k of level l (at (2k+1) s) from its even neighbours,
  // a lane per (row, component) in groups of 8 lanes, the row's t shared by
  // shuffles; a warp's lanes run the same trips
  for (int l = levels - 1; l >= 0; --l) {
    const int s = 1 << l, h = n >> (l + 1);
    const float* Dinv = a.pre + static_cast<size_t>(180) * (n - (n >> l));
    const float* Lo = Dinv + 36 * h;
    const float* Uo = Dinv + 72 * h;
    const int items = (8 * h + 31) & ~31;
    const int base = threadIdx.x & 24;
    for (int it = threadIdx.x; it < items; it += kThreads) {
      const int k = it >> 3, c = it & 7;
      const bool live = k < h && c < 6;
      const float* D = Dinv + 36 * k + 6 * c;
      float t = 0.f;
      if (live) {
        const float* Lr = Lo + 36 * k + 6 * c;
        const float* Ur = Uo + 36 * k + 6 * c;
        const float* x0 = Z + 6 * (2 * k * s);
        float lx = 0.f, ux = 0.f;
#pragma unroll
        for (int j = 0; j < 6; ++j) lx += Lr[j] * x0[j];
        if (k + 1 < h) {
          const float* x1 = Z + 6 * ((2 * k + 2) * s);
#pragma unroll
          for (int j = 0; j < 6; ++j) ux += Ur[j] * x1[j];
        }
        t = (Z[6 * ((2 * k + 1) * s) + c] - lx) - ux;
      }
      float v = 0.f;
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        const float tj = __shfl_sync(0xffffffffu, t, base + j);
        if (live) v += D[j] * tj;
      }
      if (live) Z[6 * ((2 * k + 1) * s) + c] = v;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads, 1) se3_pcg_kernel(Args a) {
  extern __shared__ float smem[];
  const int NP6 = 6 * a.NP;
  const size_t vec_floats = static_cast<size_t>(4 * a.NP + a.n) * 6 + a.NP;
  float* red = smem;
  float* X = a.vec_shared ? smem + kRed : a.scratch;
  float* R = X + NP6;
  float* P = R + NP6;
  float* HP = P + NP6;
  float* Z = HP + NP6;
  float* F = Z + 6 * a.n;
  float* TI = a.terms_shared ? smem + kRed + vec_floats : a.scratch + (a.vec_shared ? 0 : vec_floats);
  float* TJ = TI + 6 * static_cast<size_t>(a.EP);
  const float one_lam = 1.f + *a.lam;

  for (int q = threadIdx.x; q < NP6; q += kThreads) {
    X[q] = 0.f;
    R[q] = a.b[q];
  }
  for (int q = threadIdx.x; q < a.NP; q += kThreads) F[q] = a.free_[q];
  __syncthreads();
  precondition(a, R, Z);
  float part = 0.f;
  for (int q = threadIdx.x; q < NP6; q += kThreads) {
    part += R[q] * Z[q];
    P[q] = Z[q];
  }
  float rz = block_sum(part, red + 32);
  const float tol2 = a.rtol2 * fmaxf(rz, 1e-30f);
  int k = 0;
  while (k < a.max_iters && rz > tol2) {
    edge_terms(a, P, F, TI, TJ);
    __syncthreads();
    const float php = block_sum(node_products(a, one_lam, P, F, TI, TJ, HP), red);
    const float alpha = php > 0.f ? rz / php : 0.f;
    for (int q = threadIdx.x; q < NP6; q += kThreads) {
      X[q] = alpha * P[q] + X[q];
      R[q] = -alpha * HP[q] + R[q];
    }
    __syncthreads();
    precondition(a, R, Z);
    part = 0.f;
    for (int q = threadIdx.x; q < NP6; q += kThreads) part += R[q] * Z[q];
    const float rz_new = block_sum(part, red + 32);
    const float beta = rz_new / (rz > 0.f ? rz : 1e-30f);
    for (int q = threadIdx.x; q < NP6; q += kThreads) P[q] = beta * P[q] + Z[q];
    rz = rz_new;
    ++k;
    __syncthreads();
  }
  for (int q = threadIdx.x; q < NP6; q += kThreads) {
    a.x[q] = X[q];
    a.r[q] = R[q];
    a.p[q] = P[q];
  }
  if (threadIdx.x == 0) {
    *a.rz = rz;
    *a.k = k;
  }
}

}  // namespace

// Sets the kernel's dynamic shared memory limit; returns the CUDA error (0 = ok).
extern "C" int se3_pcg_init() {
  return static_cast<int>(
      cudaFuncSetAttribute(se3_pcg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem));
}

// The kernel's threads, shared-memory limit, reduction floats and terms an
// edge, for the wrapper's layout; returns their count.
extern "C" int se3_pcg_constants(int* out) {
  out[0] = kThreads;
  out[1] = kMaxSmem;
  out[2] = kRed;
  out[3] = kTerms;
  return 4;
}

// Enqueues one launch on `stream`; returns cudaGetLastError() (0 = ok).
// Shapes as Args says; n is the chain factor's padded row count (a power
// of two) or NP for the block-Jacobi preconditioner; scratch holds what the
// shared memory does not (ops/se3_pcg.layout), smem_bytes the dynamic
// shared memory.
extern "C" int se3_pcg_launch(const float* B, const int32_t* ends, const int32_t* pos_i, const int32_t* pos_j,
                              const int32_t* offsets_i, const int32_t* offsets_j, const float* Dp, const float* lam,
                              const float* free_, const float* pre, const float* b, float* x, float* r, float* p,
                              float* rz, int64_t* k, float* scratch, int NP, int EP, int n, int chain, int max_iters,
                              float rtol2, int vec_shared, int terms_shared, int smem_bytes, void* stream) {
  if (NP < 1 || EP < 0 || n < NP || (chain && (n < 2 || (n & (n - 1)) != 0)) || (!chain && n != NP) ||
      smem_bytes > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{B, ends, pos_i, pos_j, offsets_i, offsets_j, Dp, lam, free_, pre, b, x, r, p, rz, k, scratch,
         NP, EP, n, chain, max_iters, rtol2, vec_shared, terms_shared};
  se3_pcg_kernel<<<1, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
