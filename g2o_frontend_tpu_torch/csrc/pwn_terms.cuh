// Per-pixel device code shared by the PWN aligner kernels for NVIDIA Hopper
// (sm_90a): fused_aligner.cu (one system, and K candidate systems) and
// linearizer.cu (the z-buffer association's linearize stage).
//
// - linearize_terms: the robust point+normal linearization of one
//   correspondence (linearizer.cpp:17-115, the JAX _linearize_planar /
//   _linearize): 29 terms, Htt 6, Htr 9, Hrr 6, b 6, chi2, inliers;
// - pixel_terms: the exact projective gather association of one current
//   pixel (the JAX _correspondences_gather) followed by linearize_terms;
// - block_row: the deterministic block sum of the 29 terms (warp shuffles,
//   then the block's warps in shared memory), one row per block;
// - reduce_blocks_kernel: a fixed-order f64 pass over the block rows, one
//   output row per blockIdx.y.
//
// The functions above are frozen: kernels 1 and 3 (and the previous batch
// kernel, kept as a timing yardstick) compile from them. The tiled batch
// kernel's own device code follows them:
// - stage_tile: a block's tile of current pixels, 20 planes, into shared
//   memory with coalesced 16 B loads;
// - project_rn: pixel_terms' projection, the same rounding;
// - fetch_rows: the projection and the exact gather of a candidate's
//   reference records into shared memory by cp.async, in flight while the
//   thread computes the candidate before;
// - linearize_add: linearize_terms' terms added into the sums, without
//   the products by the jacobian's zeros;
// - staged_row_add: pixel_terms' gates and linearize_add on a staged
//   pixel and its fetched record;
// - warp_transpose_sum: the 32-value recursive-halving warp sum, 31
//   shuffles, lane j ending with the warp's sum of value j.

#pragma once

#include <cuda_runtime.h>

namespace pwn {

constexpr int kSums = 29;
constexpr int kCurChannels = 20;  // p(0:3) n(3:6) curv(6) valid(7) op(8:14) on(14:20)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kParams = 24;  // Rinv(0:9) tinv(9:12) R(12:21) t(21:24)

struct Geometry {
  int H, W;
  float fx, fy, cx, cy, min_d, max_d;
  float nthr, dthr2, cthr, ratio_lo, ratio_hi, max_chi2;
  int robust;
};

// Row-major (3, 3) matrix times a vector, summed (R0 x + R1 y) + R2 z as the
// plain version's rot_apply does, without contraction.
__device__ __forceinline__ float3 rot_rn(const float* R, float3 v) {
  return make_float3(
      __fadd_rn(__fadd_rn(__fmul_rn(R[0], v.x), __fmul_rn(R[1], v.y)), __fmul_rn(R[2], v.z)),
      __fadd_rn(__fadd_rn(__fmul_rn(R[3], v.x), __fmul_rn(R[4], v.y)), __fmul_rn(R[5], v.z)),
      __fadd_rn(__fadd_rn(__fmul_rn(R[6], v.x), __fmul_rn(R[7], v.y)), __fmul_rn(R[8], v.z)));
}

__device__ __forceinline__ float3 add_rn(float3 a, const float* t) {
  return make_float3(__fadd_rn(a.x, t[0]), __fadd_rn(a.y, t[1]), __fadd_rn(a.z, t[2]));
}

// sym6 (xx, xy, xz, yy, yz, zz) times a vector.
__device__ __forceinline__ float3 sym_apply(const float* o, float3 v) {
  return make_float3(o[0] * v.x + o[1] * v.y + o[2] * v.z,
                     o[1] * v.x + o[3] * v.y + o[4] * v.z,
                     o[2] * v.x + o[4] * v.y + o[5] * v.z);
}

__device__ __forceinline__ float dot3(float3 a, float3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }

__device__ __forceinline__ float comp(float3 a, int i) { return i == 0 ? a.x : (i == 1 ? a.y : a.z); }

// Robust point+normal linearization of one correspondence: p, nr are the
// reference point and normal mapped into the current frame, cp, cn the
// current point and normal, op, on their sym6 information matrices. b and
// chi2 scale by sqrt(max_chi2/chi2) above max_chi2, H does not; with
// robust == 0 the correspondence is dropped above max_chi2 instead.
// acc stays zero where the correspondence is dropped.
__device__ __forceinline__ void linearize_terms(float3 p, float3 nr, float3 cp, float3 cn, const float* op,
                                                const float* on, const Geometry& g, float* acc) {
  const float3 ep = make_float3(p.x - cp.x, p.y - cp.y, p.z - cp.z);
  const float3 en = make_float3(nr.x - cn.x, nr.y - cn.y, nr.z - cn.z);
  const float3 wp = sym_apply(op, ep);
  const float3 wn = sym_apply(on, en);
  const float chi2 = dot3(ep, wp) + dot3(en, wn);
  float kscale = 1.f;
  if (g.robust) {
    if (chi2 > g.max_chi2) kscale = sqrtf(__fdiv_rn(g.max_chi2, fmaxf(chi2, 1e-12f)));
  } else if (!(chi2 <= g.max_chi2)) {
    return;
  }

  // columns of S(p) = -2 hat(p) and S(n): the quaternion-chart jacobian
  const float3 s[3] = {make_float3(0.f, -2.f * p.z, 2.f * p.y), make_float3(2.f * p.z, 0.f, -2.f * p.x),
                       make_float3(-2.f * p.y, 2.f * p.x, 0.f)};
  const float3 t[3] = {make_float3(0.f, -2.f * nr.z, 2.f * nr.y), make_float3(2.f * nr.z, 0.f, -2.f * nr.x),
                       make_float3(-2.f * nr.y, 2.f * nr.x, 0.f)};
  float3 cs[3], ds[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    cs[j] = sym_apply(op, s[j]);
    ds[j] = sym_apply(on, t[j]);
  }
#pragma unroll
  for (int k = 0; k < 6; ++k) acc[k] = op[k];  // Htt upper triangle
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) acc[6 + 3 * i + j] = comp(cs[j], i);  // Htr
  int r = 15;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = i; j < 3; ++j) acc[r++] = dot3(s[i], cs[j]) + dot3(t[i], ds[j]);  // Hrr
  acc[21] = kscale * wp.x;  // b_t
  acc[22] = kscale * wp.y;
  acc[23] = kscale * wp.z;
  const float crx = p.y * wp.z - p.z * wp.y + nr.y * wn.z - nr.z * wn.y;
  const float cry = p.z * wp.x - p.x * wp.z + nr.z * wn.x - nr.x * wn.z;
  const float crz = p.x * wp.y - p.y * wp.x + nr.x * wn.y - nr.y * wn.x;
  acc[24] = 2.f * kscale * crx;  // b_r
  acc[25] = 2.f * kscale * cry;
  acc[26] = 2.f * kscale * crz;
  acc[27] = kscale * chi2;
  acc[28] = 1.f;
}

// The 29 terms of one current pixel against one reference table; acc stays
// zero where any gate fails.
__device__ __forceinline__ void pixel_terms(const float* __restrict__ cur, const float4* __restrict__ ref,
                                            const float* prm, const Geometry& g, int pix, int n, float* acc) {
  float c[kCurChannels];
#pragma unroll
  for (int ch = 0; ch < kCurChannels; ++ch) c[ch] = __ldg(cur + static_cast<size_t>(ch) * n + pix);
  if (!(c[7] > 0.f)) return;  // current pixel invalid
  const float3 cp = make_float3(c[0], c[1], c[2]);
  const float3 cn = make_float3(c[3], c[4], c[5]);

  // project the current point into the reference camera
  const float3 q = add_rn(rot_rn(prm, cp), prm + 9);
  const float d = q.z;
  if (!(d > g.min_d && d < g.max_d)) return;
  const float safe = d == 0.f ? 1e-9f : d;
  const float u = __fadd_rn(__fmul_rn(__fdiv_rn(q.x, safe), g.fx), g.cx);
  const float v = __fadd_rn(__fmul_rn(__fdiv_rn(q.y, safe), g.fy), g.cy);
  const float ur = rintf(u);  // half to even, as jnp.round / torch.round
  const float vr = rintf(v);
  if (!(ur >= 0.f && ur < static_cast<float>(g.W) && vr >= 0.f && vr < static_cast<float>(g.H))) return;
  const int idx = static_cast<int>(vr) * g.W + static_cast<int>(ur);

  // exact gather of the reference record [p(3), n(3), curv, valid]
  const float4 r0 = __ldg(ref + 2 * idx);
  const float4 r1 = __ldg(ref + 2 * idx + 1);
  if (!(r1.w > 0.f)) return;
  const float3 rp = make_float3(r0.x, r0.y, r0.z);
  const float3 rn = make_float3(r0.w, r1.x, r1.y);

  // reference point and normal in the current frame
  const float3 p = add_rn(rot_rn(prm + 12, rp), prm + 21);
  const float3 nr = rot_rn(prm + 12, rn);

  // gates (correspondencefinder.cpp:60-103)
  const float dx = cp.x - p.x, dy = cp.y - p.y, dz = cp.z - p.z;
  const float dist2 = dx * dx + dy * dy + dz * dz;
  const float ratio = __fdiv_rn(fmaxf(r1.z, g.cthr) + 1e-5f, fmaxf(c[6], g.cthr) + 1e-5f);
  const bool mask = dot3(cn, cn) > 0.f && dot3(rn, rn) > 0.f && dot3(cn, nr) >= g.nthr &&
                    dist2 <= g.dthr2 && ratio >= g.ratio_lo && ratio <= g.ratio_hi;
  if (!mask) return;
  linearize_terms(p, nr, cp, cn, c + 8, c + 14, g, acc);
}

// Sums acc over the block into row[0:29]: warp shuffles, then the block's
// warps in a fixed order. Every thread of the block must call it.
__device__ __forceinline__ void block_row(const float* acc, float (*warp_sums)[kSums], float* __restrict__ row) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kSums; ++k) {
    float v = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) warp_sums[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < kSums) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += warp_sums[w][threadIdx.x];
    row[threadIdx.x] = s;
  }
}

// Grid (29, K): block (k, c) sums column k of system c's n_blocks rows in a
// fixed f64 order into out[c * 29 + k]. block_sums is (K, n_blocks, 29).
__global__ void __launch_bounds__(kThreads)
reduce_blocks_kernel(const float* __restrict__ block_sums, int n_blocks, float* __restrict__ out) {
  __shared__ double buf[kThreads];
  const int k = blockIdx.x;
  const float* rows = block_sums + static_cast<size_t>(blockIdx.y) * n_blocks * kSums;
  double s = 0.0;
  for (int b = threadIdx.x; b < n_blocks; b += kThreads) s += static_cast<double>(rows[b * kSums + k]);
  buf[threadIdx.x] = s;
  __syncthreads();
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) buf[threadIdx.x] += buf[threadIdx.x + stride];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.y * kSums + k] = static_cast<float>(buf[0]);
}

inline int blocks_for(int n_pixels) { return (n_pixels + kThreads - 1) / kThreads; }

// -- the tiled batch kernel's device code ------------------------------------

// A resident pixel takes 144 B of shared memory (its 20 planes, its
// records of 2 candidates), so an SM holds ~1,500; 128 threads of 2 pixels
// amortize the warp reduction over 64 pixels and still keep 5 blocks (20
// warps) resident at up to 102 registers a thread.
constexpr int kBatchThreads = 128;                      // threads a block
constexpr int kBatchWarps = kBatchThreads / 32;
constexpr int kBatchPix = 2;                            // current pixels a thread
constexpr int kBatchTile = kBatchThreads * kBatchPix;   // current pixels a block
constexpr int kMaxGroup = 8;                            // candidates a block
constexpr int kBatchMinBlocks = 5;                      // blocks an SM keeps resident
constexpr int kRowStages = 2;                           // candidates whose records are held: computed, in flight

// Shared memory of a block with `group` candidates: each thread's fetched
// reference records (two float4 a pixel, kRowStages candidates), the
// tile's 20 planes, the group's params rows, one 32-value row per
// (candidate, warp).
inline size_t batch_smem_bytes(int group) {
  return sizeof(float4) * kRowStages * kBatchPix * 2 * kBatchThreads +
         sizeof(float) * (static_cast<size_t>(kCurChannels) * kBatchTile + group * (kParams + kBatchWarps * 32));
}

// Copies pixels [base, base + kBatchTile) of the 20 current planes into
// tile[ch * kBatchTile + i], zero past the image's end (valid = 0, so
// those pixels add nothing). With `vec` (cur 16-byte aligned and n a
// multiple of 4) every load is 16 B. Every thread of the block calls it.
__device__ __forceinline__ void stage_tile(const float* __restrict__ cur, int n, int base, bool vec, float* tile) {
  const int count = min(kBatchTile, n - base);
  if (vec) {
    constexpr int kVec = kBatchTile / 4;
    float4* tile4 = reinterpret_cast<float4*>(tile);
    for (int q = threadIdx.x; q < kCurChannels * kVec; q += kBatchThreads) {
      const int ch = q / kVec, i = 4 * (q % kVec);
      tile4[q] = i < count ? __ldg(reinterpret_cast<const float4*>(cur + static_cast<size_t>(ch) * n + base + i))
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int q = threadIdx.x; q < kCurChannels * kBatchTile; q += kBatchThreads) {
      const int ch = q / kBatchTile, i = q % kBatchTile;
      tile[q] = i < count ? __ldg(cur + static_cast<size_t>(ch) * n + base + i) : 0.f;
    }
  }
}

// The reference pixel v * W + u that current point cp projects to under
// prm, or -1 outside the depth range or the image: pixel_terms'
// projection, with the same rounding.
__device__ __forceinline__ int project_rn(float3 cp, const float* prm, const Geometry& g) {
  const float3 q = add_rn(rot_rn(prm, cp), prm + 9);
  const float d = q.z;
  if (!(d > g.min_d && d < g.max_d)) return -1;
  const float safe = d == 0.f ? 1e-9f : d;
  const float u = __fadd_rn(__fmul_rn(__fdiv_rn(q.x, safe), g.fx), g.cx);
  const float v = __fadd_rn(__fmul_rn(__fdiv_rn(q.y, safe), g.fy), g.cy);
  const float ur = rintf(u);  // half to even, as jnp.round / torch.round
  const float vr = rintf(v);
  if (!(ur >= 0.f && ur < static_cast<float>(g.W) && vr >= 0.f && vr < static_cast<float>(g.H))) return -1;
  return static_cast<int>(vr) * g.W + static_cast<int>(ur);
}

// sym_apply for a sym6 o whose entries lie S floats apart.
template <int S>
__device__ __forceinline__ float3 sym_apply_strided(const float* o, float3 v) {
  return make_float3(o[0] * v.x + o[S] * v.y + o[2 * S] * v.z, o[S] * v.x + o[3 * S] * v.y + o[4 * S] * v.z,
                     o[2 * S] * v.x + o[4 * S] * v.y + o[5 * S] * v.z);
}

// Column j of o * S(a), S(a) = -2 hat(a) (columns (0, -2 a.z, 2 a.y),
// (2 a.z, 0, -2 a.x), (-2 a.y, 2 a.x, 0)), for a sym6 o whose entries lie
// S floats apart, without the products by the column's zero.
template <int S>
__device__ __forceinline__ float3 sym_hat_column(const float* o, float3 a, int j) {
  const float ax = 2.f * a.x, ay = 2.f * a.y, az = 2.f * a.z;
  if (j == 0) return make_float3(o[2 * S] * ay - o[S] * az, o[4 * S] * ay - o[3 * S] * az, o[5 * S] * ay - o[4 * S] * az);
  if (j == 1) return make_float3(o[0] * az - o[2 * S] * ax, o[S] * az - o[4 * S] * ax, o[2 * S] * az - o[5 * S] * ax);
  return make_float3(o[S] * ax - o[0] * ay, o[3 * S] * ax - o[S] * ay, o[4 * S] * ax - o[2 * S] * ay);
}

// Column i of S(a) dotted with x, without the product by its zero.
__device__ __forceinline__ float hat_dot(float3 a, int i, float3 x) {
  return i == 0 ? 2.f * a.y * x.z - 2.f * a.z * x.y
                : (i == 1 ? 2.f * a.z * x.x - 2.f * a.x * x.z : 2.f * a.x * x.y - 2.f * a.y * x.x);
}

// linearize_terms' 29 terms of one correspondence added into acc, the
// information matrices op and on read where they are used (entries S
// floats apart): the same terms, but the quaternion-chart jacobian's zeros
// are left out instead of multiplied, b and chi2 come first so that the
// residuals die early, H goes column by column, and each term goes
// straight into its sum. acc is left as it was where the correspondence is
// dropped.
template <int S>
__device__ __forceinline__ void linearize_add(float3 p, float3 nr, float3 cp, float3 cn, const float* op,
                                              const float* on, const Geometry& g, float* acc) {
  const float3 ep = make_float3(p.x - cp.x, p.y - cp.y, p.z - cp.z);
  const float3 en = make_float3(nr.x - cn.x, nr.y - cn.y, nr.z - cn.z);
  const float3 wp = sym_apply_strided<S>(op, ep);
  const float3 wn = sym_apply_strided<S>(on, en);
  const float chi2 = dot3(ep, wp) + dot3(en, wn);
  float kscale = 1.f;
  if (g.robust) {
    if (chi2 > g.max_chi2) kscale = sqrtf(__fdiv_rn(g.max_chi2, fmaxf(chi2, 1e-12f)));
  } else if (!(chi2 <= g.max_chi2)) {
    return;
  }
  acc[21] += kscale * wp.x;  // b_t
  acc[22] += kscale * wp.y;
  acc[23] += kscale * wp.z;
  const float crx = p.y * wp.z - p.z * wp.y + nr.y * wn.z - nr.z * wn.y;
  const float cry = p.z * wp.x - p.x * wp.z + nr.z * wn.x - nr.x * wn.z;
  const float crz = p.x * wp.y - p.y * wp.x + nr.x * wn.y - nr.y * wn.x;
  acc[24] += 2.f * kscale * crx;  // b_r
  acc[25] += 2.f * kscale * cry;
  acc[26] += 2.f * kscale * crz;
  acc[27] += kscale * chi2;
  acc[28] += 1.f;
#pragma unroll
  for (int k = 0; k < 6; ++k) acc[k] += op[k * S];  // Htt upper triangle
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float3 cs = sym_hat_column<S>(op, p, j);
    const float3 ds = sym_hat_column<S>(on, nr, j);
#pragma unroll
    for (int i = 0; i < 3; ++i) acc[6 + 3 * i + j] += comp(cs, i);  // Htr
#pragma unroll
    for (int i = 0; i <= j; ++i) acc[15 + i * (5 - i) / 2 + j] += hat_dot(p, i, cs) + hat_dot(nr, i, ds);  // Hrr
  }
}

// 16 B from global src to shared dst without the registers (cp.async, L2
// only); 16 zero bytes where `ok` is false.
__device__ __forceinline__ void cp_async16(float4* dst, const float4* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Waits until at most N of this thread's committed cp.async groups are
// still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Starts the exact gather of the reference records [p(3), n(3), curv,
// valid] of this thread's pixels of a staged tile (channel ch of pixel i
// at tile[ch * kBatchTile + i]) for one candidate into its own slots,
// rows[(2q + h) * kBatchThreads + threadIdx.x] for pixel q and half h. A
// pixel that is invalid or projects outside the reference image gets
// zeros, so its record reads invalid.
__device__ __forceinline__ void fetch_rows(const float* tile, const float4* __restrict__ ref, const float* prm,
                                           const Geometry& g, float4* rows) {
  constexpr int T = kBatchTile;
#pragma unroll
  for (int q = 0; q < kBatchPix; ++q) {
    const int i = q * kBatchThreads + threadIdx.x;
    int idx = -1;
    if (tile[7 * T + i] > 0.f) idx = project_rn(make_float3(tile[i], tile[T + i], tile[2 * T + i]), prm, g);
    const float4* src = ref + 2 * max(idx, 0);
    cp_async16(rows + 2 * q * kBatchThreads + threadIdx.x, src, idx >= 0);
    cp_async16(rows + (2 * q + 1) * kBatchThreads + threadIdx.x, src + 1, idx >= 0);
  }
}

// pixel_terms' gates and linearize_add for pixel i of a staged tile
// against its fetched record (r0, r1): its 29 terms added into acc where
// every gate passes.
__device__ __forceinline__ void staged_row_add(const float* tile, int i, float4 r0, float4 r1, const float* prm,
                                               const Geometry& g, float* acc) {
  if (!(r1.w > 0.f)) return;  // nothing fetched, or the reference pixel invalid
  const float* c = tile + i;
  constexpr int T = kBatchTile;
  const float3 cp = make_float3(c[0], c[T], c[2 * T]);
  const float3 cn = make_float3(c[3 * T], c[4 * T], c[5 * T]);
  const float3 rp = make_float3(r0.x, r0.y, r0.z);
  const float3 rn = make_float3(r0.w, r1.x, r1.y);

  // reference point and normal in the current frame, then the gates
  const float3 p = add_rn(rot_rn(prm + 12, rp), prm + 21);
  const float3 nr = rot_rn(prm + 12, rn);
  const float dx = cp.x - p.x, dy = cp.y - p.y, dz = cp.z - p.z;
  const float dist2 = dx * dx + dy * dy + dz * dz;
  const float ratio = __fdiv_rn(fmaxf(r1.z, g.cthr) + 1e-5f, fmaxf(c[6 * T], g.cthr) + 1e-5f);
  const bool mask = dot3(cn, cn) > 0.f && dot3(rn, rn) > 0.f && dot3(cn, nr) >= g.nthr &&
                    dist2 <= g.dthr2 && ratio >= g.ratio_lo && ratio <= g.ratio_hi;
  if (!mask) return;
  linearize_add<T>(p, nr, cp, cn, c + 8 * T, c + 14 * T, g, acc);
}

// One step of warp_transpose_sum: each lane keeps the half of v[0:2S] that
// its lane bit S selects, adds its partner's copy of that half into
// v[0:S], and sends the other half (S shuffles).
template <int S>
__device__ __forceinline__ void halve(float* v) {
  const bool upper = threadIdx.x & S;
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const float send = upper ? v[i] : v[i + S];
    const float keep = upper ? v[i + S] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, S);
  }
}

// Sums v[0:32] over the warp by recursive halving, 16 + 8 + 4 + 2 + 1 = 31
// shuffles. Lane j returns the warp's sum of v[j], in an order fixed by
// the lane numbers. v is overwritten.
__device__ __forceinline__ float warp_transpose_sum(float* v) {
  halve<16>(v);
  halve<8>(v);
  halve<4>(v);
  halve<2>(v);
  halve<1>(v);
  return v[0];
}

}  // namespace pwn
