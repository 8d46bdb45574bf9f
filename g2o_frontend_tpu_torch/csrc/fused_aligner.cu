// Fused PWN aligner systems for NVIDIA Hopper (sm_90a), CUDA C++ with a plain
// C interface (loaded with ctypes by g2o_frontend_tpu_torch/ops/fused_aligner.py).
//
// Two kernels, one per Pallas TPU kernel they replace, and one yardstick:
//
// - fused_aligner_kernel replaces g2o_frontend_tpu/ops/pallas_aligner.py::_kernel
//   (body _kernel_body, launched by fused_linearize): one Gauss-Newton system
//   for one invT.
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
