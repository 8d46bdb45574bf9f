// PWN linearize stage of the z-buffer association for NVIDIA Hopper (sm_90a),
// CUDA C++ with a plain C interface (loaded with ctypes by
// g2o_frontend_tpu_torch/ops/linearizer.py).
//
// Replaces the Pallas TPU kernel g2o_frontend_tpu/ops/pallas_linearizer.py::
// _linearize_kernel (launched by linearize_pallas), which computes the
// function of the JAX reference's _linearize (g2o_frontend_tpu/pwn/aligner.py):
// the 29 Gauss-Newton sums (Htt 6, Htr 9, Hrr 6, b 6, chi2, inliers) of
// correspondences that are already associated. Inputs per pixel: the mask,
// the reference point and normal already mapped into the current frame (as
// the Pallas kernel takes them: the caller's remap is the one its gates
// used), and the current point, normal and sym6 information matrices from
// the (20, H, W) current planes.
// b and chi2 carry the asymmetric robust scale (H does not); with robust == 0
// a correspondence above max_chi2 is dropped instead.
//
// What bounds it: memory. Per pixel it needs the mask (1 B), the reference
// point and normal (24 B) and 18 current channels (72 B): 97 B per pixel,
// 29.8 MB at 640x480, against ~200 flops per pixel.
//
// What the design does about it: one thread per pixel reads every plane
// coalesced along W; a masked-out pixel reads one byte and nothing else. The
// per-pixel linearization is pwn_terms.cuh's linearize_terms, the code the
// fused aligner kernels run after their gather. The TPU kernel summed
// (n_tiles, 29) partials outside the kernel; here the block rows are reduced
// as in the fused aligner: warp shuffles, shared memory, then a fixed-order
// f64 pass, so runs are deterministic.

#include "pwn_terms.cuh"

namespace {

using namespace pwn;

__global__ void __launch_bounds__(kThreads)
linearize_kernel(const unsigned char* __restrict__ mask, const float* __restrict__ rp,
                 const float* __restrict__ rn, const float* __restrict__ cur, float* __restrict__ block_sums,
                 Geometry g) {
  __shared__ float warp_sums[kWarps][kSums];

  const int n = g.H * g.W;
  const int pix = blockIdx.x * kThreads + threadIdx.x;
  float acc[kSums];
#pragma unroll
  for (int k = 0; k < kSums; ++k) acc[k] = 0.f;
  if (pix < n && __ldg(mask + pix)) {
    const float3 p = make_float3(__ldg(rp + pix), __ldg(rp + n + pix), __ldg(rp + 2 * n + pix));
    const float3 nr = make_float3(__ldg(rn + pix), __ldg(rn + n + pix), __ldg(rn + 2 * n + pix));
    float c[kCurChannels];
#pragma unroll
    for (int ch = 0; ch < 6; ++ch) c[ch] = __ldg(cur + static_cast<size_t>(ch) * n + pix);
#pragma unroll
    for (int ch = 8; ch < kCurChannels; ++ch) c[ch] = __ldg(cur + static_cast<size_t>(ch) * n + pix);
    linearize_terms(p, nr, make_float3(c[0], c[1], c[2]), make_float3(c[3], c[4], c[5]), c + 8, c + 14, g, acc);
  }
  block_row(acc, warp_sums, block_sums + static_cast<size_t>(blockIdx.x) * kSums);
}

}  // namespace

// Rows of the block-sum scratch the caller allocates for an image of n_pixels.
extern "C" int linearizer_blocks(int n_pixels) { return blocks_for(n_pixels); }

// Enqueues both kernels on `stream` and returns cudaGetLastError() (0 = ok).
// mask: (H, W) bool as bytes; rp, rn: (3, H, W) f32 in the current frame;
// cur: (20, H, W) f32; block_sums: (linearizer_blocks(H*W), 29) f32 scratch;
// out: (29,) f32.
extern "C" int linearizer_launch(const unsigned char* mask, const float* rp, const float* rn, const float* cur,
                                 float* block_sums, float* out, int H, int W, float max_chi2, int robust,
                                 void* stream) {
  const int blocks = blocks_for(H * W);
  Geometry g{};
  g.H = H;
  g.W = W;
  g.max_chi2 = max_chi2;
  g.robust = robust;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  linearize_kernel<<<blocks, kThreads, 0, s>>>(mask, rp, rn, cur, block_sums, g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_blocks_kernel<<<dim3(kSums, 1), kThreads, 0, s>>>(block_sums, blocks, out);
  return static_cast<int>(cudaGetLastError());
}
