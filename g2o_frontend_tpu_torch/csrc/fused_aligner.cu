// Fused PWN aligner systems for NVIDIA Hopper (sm_90a), CUDA C++ with a plain
// C interface (loaded with ctypes by g2o_frontend_tpu_torch/ops/fused_aligner.py).
//
// Two kernels, one per Pallas TPU kernel they replace:
//
// - fused_aligner_kernel replaces g2o_frontend_tpu/ops/pallas_aligner.py::_kernel
//   (body _kernel_body, launched by fused_linearize): one Gauss-Newton system
//   for one invT.
// - fused_aligner_batch_kernel replaces pallas_aligner.py::_batch_kernel
//   (launched by fused_linearize_batch): K systems, candidate k's reference
//   table and params row against ONE shared current cloud, the loop closer's
//   batched candidate matching.
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
// What bounds them: memory. Per pixel a system reads the 20 current channels
// (80 B) and one 32 B reference record: about 112 B per pixel, 34 MB per
// system at 640x480, against ~300 flops per pixel. K systems must read the
// current cloud (24.6 MB) once and K reference tables (9.8 MB each).
//
// What the design does about it:
// - The TPU kernels' band machinery (banded per-tile window, bf16 pairs, tile
//   starts, coverage check) existed because the TPU has no fast arbitrary
//   gather. Here the gather is exact: the wrapper packs each reference once
//   per align into an (H*W, 8) f32 table [p(3), n(3), curv, valid], so one
//   correspondence is two 16 B loads. The reference point is fetched, not
//   rebuilt from depth, so sensor-offset clouds stay right.
// - The current cloud is read as 20 planes, coalesced along W.
// - One thread per pixel; the 29 sums are reduced by warp shuffles, then
//   across the block's warps in shared memory; each block writes one row of
//   a (K, n_blocks, 29) scratch. A second kernel reduces the rows in a fixed
//   order in f64, so runs are deterministic.
// - In the batch kernel the candidate is blockIdx.x, the fastest-varying
//   grid index: the K candidates of one pixel tile are scheduled side by
//   side, so the tile's current channels come from device memory about once
//   and from L2 for the other K - 1 candidates.
// - The projection and the rotations use __fmul_rn/__fadd_rn/__fdiv_rn so
//   that FMA contraction cannot move a pixel across a rounding boundary
//   relative to the plain PyTorch version.
// - The pose parameters are read from device memory: no host scalar, no
//   synchronisation in the Gauss-Newton loop.

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

// Grid (K, n_blocks): block (k, b) sums pixel tile b of candidate k.
__global__ void __launch_bounds__(kThreads)
fused_aligner_batch_kernel(const float* __restrict__ cur, const float4* __restrict__ refs,
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

Geometry geometry(int H, int W, float fx, float fy, float cx, float cy, float min_d, float max_d, float nthr,
                  float dthr2, float cthr, float ratio_lo, float ratio_hi, float max_chi2, int robust) {
  return Geometry{H, W, fx, fy, cx, cy, min_d, max_d, nthr, dthr2, cthr, ratio_lo, ratio_hi, max_chi2, robust};
}

}  // namespace

// Rows of the block-sum scratch each system needs for an image of n_pixels.
extern "C" int fused_aligner_blocks(int n_pixels) { return blocks_for(n_pixels); }

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
// (K, 24) f32; block_sums: (K, fused_aligner_blocks(H*W), 29) f32 scratch;
// out: (K, 29) f32.
extern "C" int fused_aligner_batch_launch(const float* cur, const float* refs, const float* params,
                                          float* block_sums, float* out, int K, int H, int W, float fx,
                                          float fy, float cx, float cy, float min_d, float max_d,
                                          float nthr, float dthr2, float cthr, float ratio_lo,
                                          float ratio_hi, float max_chi2, int robust, void* stream) {
  const int blocks = blocks_for(H * W);
  const Geometry g = geometry(H, W, fx, fy, cx, cy, min_d, max_d, nthr, dthr2, cthr, ratio_lo, ratio_hi,
                              max_chi2, robust);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  fused_aligner_batch_kernel<<<dim3(K, blocks), kThreads, 0, s>>>(
      cur, reinterpret_cast<const float4*>(refs), params, block_sums, g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_blocks_kernel<<<dim3(kSums, K), kThreads, 0, s>>>(block_sums, blocks, out);
  return static_cast<int>(cudaGetLastError());
}
