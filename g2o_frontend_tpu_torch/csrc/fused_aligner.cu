// Fused PWN aligner systems for NVIDIA Hopper (sm_90a), CUDA C++ with a plain
// C interface (loaded with ctypes by g2o_frontend_tpu_torch/ops/fused_aligner.py).
//
// Two kernels, one per Pallas TPU kernel they replace, the Gauss-Newton step
// that follows kernel 1 in the aligner's loop, and one yardstick:
//
// - fused_aligner_kernel replaces g2o_frontend_tpu/ops/pallas_aligner.py::_kernel
//   (body _kernel_body, launched by fused_linearize): one Gauss-Newton system
//   for one invT.
// - gauss_newton_step_kernel replaces no TPU kernel: it reduces kernel 1's
//   block rows and updates invT and the next launch's params on the card
//   (see the paragraph on it below).
// - fused_aligner_batch_kernel replaces pallas_aligner.py::_batch_kernel
//   (launched by fused_linearize_batch): K systems, candidate k's reference
//   table and params row against ONE shared current cloud, the loop closer's
//   batched candidate matching.
// - fused_aligner_batch_grid_kernel is the previous design of the batch
//   kernel (one thread per pixel, one block per (candidate, 256 pixels)),
//   kept only to time the batch kernel against; no user path launches it.
//
// Each system is exactly the JAX reference's _correspondences_gather followed
// by _linearize_planar (g2o_frontend_tpu/pwn/aligner.py): for every current
// pixel, map its point into the reference camera, round to the nearest pixel
// (half to even, as jnp.round), fetch the reference point, normal, curvature
// and validity there, apply the four correspondence gates, linearize the
// robust point+normal error, and sum 29 values (Htt 6, Htr 9, Hrr 6, b 6,
// chi2, inliers) in the _linearize_planar order. The per-pixel code is
// pwn_terms.cuh, shared with linearizer.cu.
//
// What bounds them on this card: per pixel a system reads the 20 current
// channels (80 B) and one 32 B reference record, about 112 B per pixel, 34
// MB per system at 640x480, and does ~360 float32 operations. K systems
// must read the current cloud (24.6 MB) once and each fetched reference row
// once: the bytes bound it (3.35 TB/s), the operations (67 TFLOP/s outside
// the tensor cores) come within 1.5x of it.
//
// What the designs do about it:
// - The TPU kernels' band machinery (banded per-tile window, bf16 pairs, tile
//   starts, coverage check) existed because the TPU has no fast arbitrary
//   gather. Here the gather is exact: the wrapper packs each reference once
//   per align into an (H*W, 8) f32 table [p(3), n(3), curv, valid], so one
//   correspondence is two 16 B loads. The reference point is fetched, not
//   rebuilt from depth, so sensor-offset clouds stay right.
// - The current cloud is read as 20 planes, coalesced along W.
// - Kernel 1: one thread per pixel; the 29 sums are reduced by warp
//   shuffles, then across the block's warps in shared memory; each block
//   writes one row of a (n_blocks, 29) scratch. A second kernel reduces the
//   rows in a fixed order in f64, so runs are deterministic.
// - The batch kernel: the previous design ran kernel 1's block for every
//   (candidate, 256 pixels), so each candidate reloaded the 20 current
//   channels from L2 and paid 29 x 5 warp shuffles per 256 pixels, valid or
//   not; two thirds of its time was that work, not its loads. Now a block
//   owns a tile of kBatchTile current pixels (kBatchPix a thread) and a
//   group of at most kMaxGroup candidates. It stages the tile's 20 planes
//   into shared memory once, with 16 B loads, and the group's params rows.
//   For each candidate every thread projects its pixels and starts the
//   gather of their reference records into its own shared-memory slots by
//   cp.async, one candidate ahead, so the loads are in flight while it
//   computes the candidate before without holding registers; it adds its
//   pixels' terms in registers (linearize_add: linearize_terms without the
//   products by the jacobian's zeros), and the warp reduces them once, by
//   recursive halving (31 shuffles: lane j ends with the warp's sum of
//   value j). The warps' rows are summed in shared memory in a fixed order
//   after the last candidate, one row per (candidate, tile) of a (K,
//   n_tiles, 29) scratch, which the same f64 pass reduces: two launches on
//   the same inputs give the same bits. The grid is (tiles, groups)
//   flattened with the group fastest, so the groups of one tile run side
//   by side and read its planes from device memory about once. The wrapper
//   sizes the groups (ops/fused_aligner.py batch_layout) so that the grid
//   fills the card at K = 1 as at K = 21. With the loads hidden, what bounds
//   it is instruction issue: several hundred instructions per pixel and
//   candidate (the projection's and the gates' IEEE divisions, the 6x6
//   terms, the reduction) for the ~360 float operations they compute.
// - Not used: wgmma (the 29 sums are a per-pixel weighted 6x6 product, far
//   below a 64-row tile, and TF32 would break the tolerance on b, which
//   cancels near convergence) and TMA for the gather (the reference rows
//   are data-dependent).
// - The projection and the rotations use __fmul_rn/__fadd_rn/__fdiv_rn so
//   that FMA contraction cannot move a pixel across a rounding boundary
//   relative to the plain PyTorch version.
// - The pose parameters are read from device memory: no host scalar, no
//   synchronisation in the Gauss-Newton loop.
//
// gauss_newton_step_kernel fuses the Gauss-Newton update of the aligner's
// loop (g2o_frontend_tpu/pwn/aligner.py, gn_step and the chart's
// re-orthonormalisation; aligner.cpp:88-117) with kernel 1's reduction, in
// the place of reduce_blocks_kernel inside the loop. Run as ~200 PyTorch
// operations of 6x6 and 4x4 arithmetic, the update cost each iteration ~200
// graph nodes, ten times kernel 1's own time. One block reduces the 29
// columns in reduce_blocks_kernel's fixed f64 order, so the sums keep their
// bits: rounds of 256 block rows are staged into shared memory with
// coalesced loads, warp k owns column k, lane l the partials l + 32 m of
// the 256 that reduce_blocks_kernel's threads hold, strides 128 to 32 of
// its tree add in the lane's registers and strides 16 to 1 by shuffles.
// One block and not a last-block ticket: nothing persists between
// launches, so graphs and captures need no reset. Its thread 0 then does
// the update on the float32 sums as the plain version's tail does: H and b
// as unpack_sums lays them out, damping added to the diagonal, the 6x6
// system solved by LU with partial pivoting, invT <- v2t(dx) invT through
// the unit-quaternion chart (utils/lie.quat2mat), and on an outer
// iteration's last inner step invT <- v2t(t2v(invT)) by the branchless
// Shepperd pivot of mat2quat_full. It writes invT and the next launch's
// params [Rinv, tinv, R, t], which kernel 1 reads from device memory, so
// the loop is two launches an iteration and no host work. The chart, the
// product and the params use __fmul_rn/__fadd_rn/__fdiv_rn, as the
// projection does, since they feed it; the solve may contract.

#include <cstdint>

#include "pwn_terms.cuh"

namespace {

using namespace pwn;

__global__ void __launch_bounds__(kThreads)
fused_aligner_kernel(const float* __restrict__ cur, const float4* __restrict__ ref,
                     const float* __restrict__ params, float* __restrict__ block_sums, Geometry g) {
  __shared__ float prm[kParams];
  __shared__ float warp_sums[kWarps][kSums];
  if (threadIdx.x < kParams) prm[threadIdx.x] = params[threadIdx.x];
  __syncthreads();

  const int n = g.H * g.W;
  const int pix = blockIdx.x * kThreads + threadIdx.x;
  float acc[kSums];
#pragma unroll
  for (int k = 0; k < kSums; ++k) acc[k] = 0.f;
  if (pix < n) pixel_terms(cur, ref, prm, g, pix, n, acc);
  block_row(acc, warp_sums, block_sums + static_cast<size_t>(blockIdx.x) * kSums);
}

// The previous batch design. Grid (K, n_blocks): block (k, b) sums pixel
// tile b of candidate k.
__global__ void __launch_bounds__(kThreads)
fused_aligner_batch_grid_kernel(const float* __restrict__ cur, const float4* __restrict__ refs,
                                const float* __restrict__ params, float* __restrict__ block_sums, Geometry g) {
  __shared__ float prm[kParams];
  __shared__ float warp_sums[kWarps][kSums];
  const int k = blockIdx.x;
  if (threadIdx.x < kParams) prm[threadIdx.x] = params[k * kParams + threadIdx.x];
  __syncthreads();

  const int n = g.H * g.W;
  const int pix = blockIdx.y * kThreads + threadIdx.x;
  const float4* ref = refs + static_cast<size_t>(k) * n * 2;
  float acc[kSums];
#pragma unroll
  for (int s = 0; s < kSums; ++s) acc[s] = 0.f;
  if (pix < n) pixel_terms(cur, ref, prm, g, pix, n, acc);
  block_row(acc, warp_sums, block_sums + (static_cast<size_t>(k) * gridDim.y + blockIdx.y) * kSums);
}

// Block b = tile * groups + j sums candidates [j * group, j * group + group)
// (cut at K) over current pixels [tile * kBatchTile, (tile + 1) * kBatchTile)
// into rows (k, tile) of block_sums (K, n_tiles, 29). Dynamic shared memory:
// batch_smem_bytes(group).
__global__ void __launch_bounds__(kBatchThreads, kBatchMinBlocks)
fused_aligner_batch_kernel(const float* __restrict__ cur, const float4* __restrict__ refs,
                           const float* __restrict__ params, float* __restrict__ block_sums, int K, int group,
                           int groups, bool vec, Geometry g) {
  constexpr int kStage = kBatchPix * 2 * kBatchThreads;  // float4 slots of one candidate's records
  extern __shared__ float4 smem[];
  float4* rows = smem;                                   // [kRowStages][kBatchPix * 2][kBatchThreads]
  float* tile = reinterpret_cast<float*>(rows + kRowStages * kStage);  // [kCurChannels][kBatchTile]
  float* prm = tile + kCurChannels * kBatchTile;         // [group][kParams]
  float* sums = prm + group * kParams;                   // [group][kBatchWarps][32]
  const int t = blockIdx.x / groups;
  const int k0 = (blockIdx.x - t * groups) * group;
  const int nk = min(group, K - k0);
  const int n_tiles = gridDim.x / groups;
  const int n = g.H * g.W;
  stage_tile(cur, n, t * kBatchTile, vec, tile);
  for (int i = threadIdx.x; i < nk * kParams; i += kBatchThreads) prm[i] = params[k0 * kParams + i];
  __syncthreads();

  // candidate j's records are fetched while candidates j - kRowStages + 1
  // .. j - 1 are computed; each thread reads back only its own slots
#pragma unroll
  for (int j = 0; j < kRowStages - 1; ++j) {
    if (j < nk) fetch_rows(tile, refs + static_cast<size_t>(k0 + j) * n * 2, prm + j * kParams, g, rows + j * kStage);
    cp_async_commit();
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int j = 0; j < nk; ++j) {
    const int ahead = j + kRowStages - 1;
    if (ahead < nk)
      fetch_rows(tile, refs + static_cast<size_t>(k0 + ahead) * n * 2, prm + ahead * kParams, g,
                 rows + ahead % kRowStages * kStage);
    cp_async_commit();
    cp_async_wait<kRowStages - 1>();
    const float4* mine = rows + j % kRowStages * kStage + threadIdx.x;
    float acc[32];  // 29 sums, padded to the warp's 32 lanes
#pragma unroll
    for (int s = 0; s < 32; ++s) acc[s] = 0.f;
#pragma unroll
    for (int q = 0; q < kBatchPix; ++q)
      staged_row_add(tile, q * kBatchThreads + threadIdx.x, mine[2 * q * kBatchThreads],
                     mine[(2 * q + 1) * kBatchThreads], prm + j * kParams, g, acc);
    sums[(j * kBatchWarps + warp) * 32 + lane] = warp_transpose_sum(acc);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nk * kSums; i += kBatchThreads) {
    const int j = i / kSums, s = i - j * kSums;
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < kBatchWarps; ++w) total += sums[(j * kBatchWarps + w) * 32 + s];
    block_sums[(static_cast<size_t>(k0 + j) * n_tiles + t) * kSums + s] = total;
  }
}

// -- the Gauss-Newton step ------------------------------------------------------

constexpr int kStepThreads = 32 * 32;  // a warp per column, 29 of 32 busy
constexpr int kStepRows = kThreads;    // block rows a round: reduce_blocks_kernel's partials
constexpr int kStepLoads = (kStepRows * kSums + kStepThreads - 1) / kStepThreads;  // a thread's loads a round
// state: invT (16), params (24), dx (6), the 29 sums
constexpr int kStateInvT = 0, kStateParams = 16, kStateDx = 40, kStateSums = 46, kState = 75;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// utils/lie.quat2mat: qw = sqrt(max(0, 1 - |q|^2)), row-major R.
__device__ void quat2mat(float qx, float qy, float qz, float* R) {
  const float qw = __fsqrt_rn(fmaxf(sub(1.f, add(add(mul(qx, qx), mul(qy, qy)), mul(qz, qz))), 0.f));
  const float ww = mul(qw, qw), xx = mul(qx, qx), yy = mul(qy, qy), zz = mul(qz, qz);
  R[0] = sub(sub(add(ww, xx), yy), zz);
  R[1] = mul(2.f, sub(mul(qx, qy), mul(qw, qz)));
  R[2] = mul(2.f, add(mul(qx, qz), mul(qw, qy)));
  R[3] = mul(2.f, add(mul(qx, qy), mul(qz, qw)));
  R[4] = sub(add(sub(ww, xx), yy), zz);
  R[5] = mul(2.f, sub(mul(qy, qz), mul(qx, qw)));
  R[6] = mul(2.f, sub(mul(qx, qz), mul(qy, qw)));
  R[7] = mul(2.f, add(mul(qy, qz), mul(qx, qw)));
  R[8] = add(sub(sub(ww, xx), yy), zz);
}

// utils/lie.mat2quat: the unit quaternion of the row-major rotation R by
// Shepperd's pivot (the first largest of the four), normalised, qw >= 0;
// returns its imaginary part in q.
__device__ void mat2quat(const float* R, float* q) {
  const float m00 = R[0], m01 = R[1], m02 = R[2], m10 = R[3], m11 = R[4], m12 = R[5], m20 = R[6], m21 = R[7],
              m22 = R[8];
  const float tr = add(add(m00, m11), m22);
  const float pivots[4] = {add(1.f, tr), sub(sub(add(1.f, m00), m11), m22), sub(add(sub(1.f, m00), m11), m22),
                           add(sub(sub(1.f, m00), m11), m22)};
  const float cands[4][4] = {
      {pivots[0], sub(m21, m12), sub(m02, m20), sub(m10, m01)},
      {sub(m21, m12), pivots[1], add(m01, m10), add(m02, m20)},
      {sub(m02, m20), add(m01, m10), pivots[2], add(m12, m21)},
      {sub(m10, m01), add(m02, m20), add(m12, m21), pivots[3]},
  };
  int best = 0;
#pragma unroll
  for (int p = 1; p < 4; ++p)
    if (pivots[p] > pivots[best]) best = p;
  float c[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] = cands[0][i];
#pragma unroll
  for (int p = 1; p < 4; ++p)
    if (best == p)
#pragma unroll
      for (int i = 0; i < 4; ++i) c[i] = cands[p][i];
  const float norm = __fsqrt_rn(add(add(add(mul(c[0], c[0]), mul(c[1], c[1])), mul(c[2], c[2])), mul(c[3], c[3])));
  const float sign = __fdiv_rn(c[0], norm) < 0.f ? -1.f : 1.f;
#pragma unroll
  for (int i = 0; i < 3; ++i) q[i] = sign * __fdiv_rn(c[i + 1], norm);
}

// The Gauss-Newton update of one aligner system: s the 29 sums, invT the
// row-major 4x4 pose; writes invT, params and dx into state.
__device__ void gauss_newton_update(const float* s, const float* __restrict__ invT, float damping,
                                    bool reorthonormalize, float* __restrict__ state) {
  constexpr int kSym[9] = {0, 1, 2, 1, 3, 4, 2, 4, 5};  // sym6 -> row-major 3x3
  float A[6][6], x[6];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      A[i][j] = s[kSym[3 * i + j]];
      A[i][3 + j] = s[6 + 3 * i + j];
      A[3 + j][i] = s[6 + 3 * i + j];
      A[3 + i][3 + j] = s[15 + kSym[3 * i + j]];
    }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    A[i][i] = add(A[i][i], damping);
    x[i] = -s[21 + i];
  }

  // LU with partial pivoting, the first largest pivot, then the two
  // triangular solves
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    int p = k;
#pragma unroll
    for (int i = k + 1; i < 6; ++i)
      if (fabsf(A[i][k]) > fabsf(A[p][k])) p = i;
#pragma unroll
    for (int i = k + 1; i < 6; ++i)
      if (p == i) {
#pragma unroll
        for (int j = 0; j < 6; ++j) {
          const float t = A[k][j];
          A[k][j] = A[i][j];
          A[i][j] = t;
        }
        const float t = x[k];
        x[k] = x[i];
        x[i] = t;
      }
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      const float l = A[i][k] / A[k][k];
#pragma unroll
      for (int j = k + 1; j < 6; ++j) A[i][j] -= l * A[k][j];
      x[i] -= l * x[k];
    }
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float v = x[i];
#pragma unroll
    for (int j = i + 1; j < 6; ++j) v -= A[i][j] * x[j];
    x[i] = v / A[i][i];
  }

  // invT <- v2t(dx) invT
  float R[9], M[16];
  quat2mat(x[3], x[4], x[5], R);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      M[4 * i + j] = add(add(add(mul(R[3 * i], invT[j]), mul(R[3 * i + 1], invT[4 + j])),
                             mul(R[3 * i + 2], invT[8 + j])),
                         mul(x[i], invT[12 + j]));
#pragma unroll
  for (int j = 0; j < 4; ++j) M[12 + j] = invT[12 + j];

  if (reorthonormalize) {  // invT <- v2t(t2v(invT)), the translation kept
    float q[3];
    const float Rm[9] = {M[0], M[1], M[2], M[4], M[5], M[6], M[8], M[9], M[10]};
    mat2quat(Rm, q);
    quat2mat(q[0], q[1], q[2], R);
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) M[4 * i + j] = R[3 * i + j];
    M[12] = M[13] = M[14] = 0.f;
    M[15] = 1.f;
  }

  // params [Rinv, tinv, R, t] of the new invT (ops/fused_aligner.py params_from_invT)
  float* prm = state + kStateParams;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      prm[3 * i + j] = M[4 * j + i];
      prm[12 + 3 * i + j] = M[4 * i + j];
    }
    prm[9 + i] = -add(add(mul(M[i], M[3]), mul(M[4 + i], M[7])), mul(M[8 + i], M[11]));
    prm[21 + i] = M[4 * i + 3];
  }
#pragma unroll
  for (int k = 0; k < 16; ++k) state[kStateInvT + k] = M[k];
#pragma unroll
  for (int k = 0; k < 6; ++k) state[kStateDx + k] = x[k];
}

// One block of kStepThreads: the 29 sums of block_sums (n_blocks, 29) in
// reduce_blocks_kernel's order, then thread 0's Gauss-Newton update of
// invT. state: kState floats, laid out as kState* says.
__global__ void __launch_bounds__(kStepThreads)
gauss_newton_step_kernel(const float* __restrict__ block_sums, int n_blocks, const float* __restrict__ invT,
                         float damping, int reorthonormalize, float* __restrict__ state) {
  __shared__ float rows[kStepRows * kSums];
  __shared__ float sums[kSums];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // part[m]: reduce_blocks_kernel's partial of thread lane + 32 m over column `warp`
  double part[kStepRows / 32];
#pragma unroll
  for (int m = 0; m < kStepRows / 32; ++m) part[m] = 0.0;
  for (int base = 0; base < n_blocks; base += kStepRows) {
    // the round's loads all in flight at once, before the previous round's
    // rows are released
    const int count = min(kStepRows, n_blocks - base) * kSums;
    const float* src = block_sums + static_cast<size_t>(base) * kSums;
    float v[kStepLoads];
#pragma unroll
    for (int j = 0; j < kStepLoads; ++j) {
      const int i = threadIdx.x + j * kStepThreads;
      v[j] = i < count ? src[i] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kStepLoads; ++j) {
      const int i = threadIdx.x + j * kStepThreads;
      if (i < count) rows[i] = v[j];
    }
    __syncthreads();
    if (warp < kSums)
#pragma unroll
      for (int m = 0; m < kStepRows / 32; ++m)
        if (base + lane + 32 * m < n_blocks) part[m] += static_cast<double>(rows[(lane + 32 * m) * kSums + warp]);
  }
  if (warp < kSums) {
    // reduce_blocks_kernel's tree: buf[i] += buf[i + stride], stride 128 .. 1
#pragma unroll
    for (int m = 0; m < 4; ++m) part[m] += part[m + 4];
#pragma unroll
    for (int m = 0; m < 2; ++m) part[m] += part[m + 2];
    double v = part[0] + part[1];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) {
      sums[warp] = static_cast<float>(v);
      state[kStateSums + warp] = sums[warp];
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) gauss_newton_update(sums, invT, damping, reorthonormalize != 0, state);
}

Geometry geometry(int H, int W, float fx, float fy, float cx, float cy, float min_d, float max_d, float nthr,
                  float dthr2, float cthr, float ratio_lo, float ratio_hi, float max_chi2, int robust) {
  return Geometry{H, W, fx, fy, cx, cy, min_d, max_d, nthr, dthr2, cthr, ratio_lo, ratio_hi, max_chi2, robust};
}

}  // namespace

// Rows of the block-sum scratch each system needs for an image of n_pixels.
extern "C" int fused_aligner_blocks(int n_pixels) { return blocks_for(n_pixels); }

// The batch kernel's threads a block, tile (current pixels a block) and
// most candidates a block; the wrapper's layout must use the same.
extern "C" int fused_aligner_batch_threads() { return kBatchThreads; }
extern "C" int fused_aligner_batch_tile() { return kBatchTile; }
extern "C" int fused_aligner_batch_max_group() { return kMaxGroup; }

// Enqueues both kernels on `stream` and returns cudaGetLastError() (0 = ok).
// cur: (20, H, W) f32; ref: (H*W, 8) f32, 16-byte aligned; params: (24,) f32;
// block_sums: (fused_aligner_blocks(H*W), 29) f32 scratch; out: (29,) f32.
extern "C" int fused_aligner_launch(const float* cur, const float* ref, const float* params,
                                    float* block_sums, float* out, int H, int W, float fx, float fy,
                                    float cx, float cy, float min_d, float max_d, float nthr,
                                    float dthr2, float cthr, float ratio_lo, float ratio_hi,
                                    float max_chi2, int robust, void* stream) {
  const int blocks = blocks_for(H * W);
  const Geometry g = geometry(H, W, fx, fy, cx, cy, min_d, max_d, nthr, dthr2, cthr, ratio_lo, ratio_hi,
                              max_chi2, robust);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  fused_aligner_kernel<<<blocks, kThreads, 0, s>>>(cur, reinterpret_cast<const float4*>(ref), params,
                                                   block_sums, g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_blocks_kernel<<<dim3(kSums, 1), kThreads, 0, s>>>(block_sums, blocks, out);
  return static_cast<int>(cudaGetLastError());
}

// Floats of a Gauss-Newton step's state: invT (16), params (24), dx (6), sums (29).
extern "C" int gauss_newton_state_floats() { return kState; }

// Enqueues gauss_newton_step_kernel alone on `stream`; returns
// cudaGetLastError(). block_sums: (n_blocks, 29) f32 rows; invT: (4, 4) f32;
// state: (gauss_newton_state_floats(),) f32, not overlapping invT.
extern "C" int gauss_newton_step_launch(const float* block_sums, int n_blocks, const float* invT, float damping,
                                        int reorthonormalize, float* state, void* stream) {
  if (n_blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  gauss_newton_step_kernel<<<1, kStepThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      block_sums, n_blocks, invT, damping, reorthonormalize, state);
  return static_cast<int>(cudaGetLastError());
}

// One Gauss-Newton step of the aligner: kernel 1 at `params`, then
// gauss_newton_step_kernel on its block rows and invT; returns
// cudaGetLastError(). The arguments are fused_aligner_launch's, `out`
// replaced by invT, damping, reorthonormalize and state as above.
extern "C" int fused_aligner_step_launch(const float* cur, const float* ref, const float* params, const float* invT,
                                         float* block_sums, float* state, int H, int W, float damping,
                                         int reorthonormalize, float fx, float fy, float cx, float cy, float min_d,
                                         float max_d, float nthr, float dthr2, float cthr, float ratio_lo,
                                         float ratio_hi, float max_chi2, int robust, void* stream) {
  const int blocks = blocks_for(H * W);
  const Geometry g = geometry(H, W, fx, fy, cx, cy, min_d, max_d, nthr, dthr2, cthr, ratio_lo, ratio_hi,
                              max_chi2, robust);
  fused_aligner_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      cur, reinterpret_cast<const float4*>(ref), params, block_sums, g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return gauss_newton_step_launch(block_sums, blocks, invT, damping, reorthonormalize, state, stream);
}

// K systems against one shared current cloud; returns cudaGetLastError().
// cur: (20, H, W) f32; refs: (K, H*W, 8) f32, 16-byte aligned; params:
// (K, 24) f32; block_sums: (K, n_tiles, 29) f32 scratch with n_tiles =
// ceil(H*W / fused_aligner_batch_tile()); out: (K, 29) f32. `group`
// candidates a block, 1 <= group <= fused_aligner_batch_max_group().
extern "C" int fused_aligner_batch_launch(const float* cur, const float* refs, const float* params,
                                          float* block_sums, float* out, int K, int group, int H, int W,
                                          float fx, float fy, float cx, float cy, float min_d, float max_d,
                                          float nthr, float dthr2, float cthr, float ratio_lo,
                                          float ratio_hi, float max_chi2, int robust, void* stream) {
  if (K < 1 || group < 1 || group > kMaxGroup) return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t attr = cudaFuncSetAttribute(
      fused_aligner_batch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(batch_smem_bytes(kMaxGroup)));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int n = H * W;
  const int tiles = (n + kBatchTile - 1) / kBatchTile;
  const int groups = (K + group - 1) / group;
  const bool vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(cur) % 16 == 0;
  const Geometry g = geometry(H, W, fx, fy, cx, cy, min_d, max_d, nthr, dthr2, cthr, ratio_lo, ratio_hi,
                              max_chi2, robust);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  fused_aligner_batch_kernel<<<tiles * groups, kBatchThreads, batch_smem_bytes(group), s>>>(
      cur, reinterpret_cast<const float4*>(refs), params, block_sums, K, group, groups, vec, g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_blocks_kernel<<<dim3(kSums, K), kThreads, 0, s>>>(block_sums, tiles, out);
  return static_cast<int>(cudaGetLastError());
}

// The previous batch design, the same contract with block_sums (K,
// fused_aligner_blocks(H*W), 29) and no group; returns cudaGetLastError().
extern "C" int fused_aligner_batch_grid_launch(const float* cur, const float* refs, const float* params,
                                               float* block_sums, float* out, int K, int H, int W, float fx,
                                               float fy, float cx, float cy, float min_d, float max_d,
                                               float nthr, float dthr2, float cthr, float ratio_lo,
                                               float ratio_hi, float max_chi2, int robust, void* stream) {
  const int blocks = blocks_for(H * W);
  const Geometry g = geometry(H, W, fx, fy, cx, cy, min_d, max_d, nthr, dthr2, cthr, ratio_lo, ratio_hi,
                              max_chi2, robust);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  fused_aligner_batch_grid_kernel<<<dim3(K, blocks), kThreads, 0, s>>>(
      cur, reinterpret_cast<const float4*>(refs), params, block_sums, g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_blocks_kernel<<<dim3(kSums, K), kThreads, 0, s>>>(block_sums, blocks, out);
  return static_cast<int>(cudaGetLastError());
}
