// Gather probes for NVIDIA Hopper (sm_90a), CUDA C++ with a plain C
// interface (loaded with ctypes by g2o_frontend_tpu_torch/ops/gather_probe.py).
//
// Replaces the Pallas TPU kernels of scripts/profile_pallas_gather.py, which
// asked whether Mosaic lowers a dynamic gather inside a kernel (one VMEM
// block each, no grid, f32 data, int32 indices):
//   k_a  (calls :47 and :61)  take_along_axis along lanes:    out[r,c] = x[r, i[r,c]]
//   k_b2 (call :80)           take_along_axis along sublanes: out[r,c] = x[i[r,c], c]
//   k_c  (call :103)          flat gather:                    out[r,c] = x.ravel()[i[r,c]]
// k_c gathers all columns of i and keeps the first `cols`; here the flat
// entry point reads only the columns it writes.
//
// Semantics are jnp.take_along_axis's: an index in [-n, -1] counts from the
// end, any index outside [-n, n) gives NaN (its fill mode). torch.gather
// raises on such indices instead, so the plain version does the same wrap
// and fill.
//
// What bounds it: bytes. Each output is one 4 B index read, one 4 B value
// read and one 4 B write, with no arithmetic. At the TPU shapes (4 to 36 KB
// in all) its time is launch latency; at the aligner's widths (640x480x8
// f32 table, one index per table scalar) it is the gather's memory rate.
//
// Design: one device function for a strided gather (gather_one), one
// kernel that maps an output element to its base and stride, and three C
// entry points that set them. One thread per output element; neighbouring
// threads write neighbouring outputs and read neighbouring indices.
//
// A fourth entry point measures what the flat gather cannot: the gather of
// fused_aligner_batch_kernel (csrc/fused_aligner.cu) in its own pattern,
// without its arithmetic. projective_gather_sum_kernel has kernel 2's grid
// and loads: every current pixel's 20 channels, its projection into each
// candidate's reference image and, where it lands, the 32 B reference row
// there. The projection is pixel_terms' (pwn_terms.cuh), written out again
// in project_pixel below: factored into a function that pixel_terms calls,
// it changed the aligner kernels' compiled code (80 registers became 64,
// with spills), so their source is left as it was. There is no index array
// and no output array: each candidate's loads are reduced to
// two integers, the rows fetched and the wrapping sum of the bit patterns
// of every value loaded, which a plain version reproduces exactly. Its
// time against kernel 2's on the same inputs splits kernel 2's time into
// memory traffic and the rest (the linearization and the 29-sum reduction).

#include <cuda_runtime.h>

#include "pwn_terms.cuh"

namespace {

constexpr int kThreads = 256;

// x[base + stride * i] for i in [-n, n), a negative i counting from the end;
// NaN (0x7fc00000, the fill of jnp.take_along_axis) for any other i.
__device__ __forceinline__ float gather_one(const float* __restrict__ x, long long base, long long stride,
                                            long long n, int i) {
  const long long j = i < 0 ? i + n : static_cast<long long>(i);
  if (j < 0 || j >= n) return __int_as_float(0x7fc00000);
  return __ldg(x + base + stride * j);
}

// out (rows, cols), row-major; the index of out[r, c] is idx[r * idx_cols + c]
// and its value x[r * row_base + c * col_base + stride * index].
__global__ void __launch_bounds__(kThreads)
gather_kernel(const float* __restrict__ x, const int* __restrict__ idx, float* __restrict__ out, int rows, int cols,
              int idx_cols, long long row_base, long long col_base, long long stride, long long n) {
  const long long o = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (o >= static_cast<long long>(rows) * cols) return;
  const long long r = o / cols, c = o % cols;
  out[o] = gather_one(x, r * row_base + c * col_base, stride, n, __ldg(idx + r * idx_cols + c));
}

int launch(const float* x, const int* idx, float* out, int rows, int cols, int idx_cols, long long row_base,
           long long col_base, long long stride, long long n, void* stream) {
  const long long total = static_cast<long long>(rows) * cols;
  if (total == 0) return 0;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  gather_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, idx, out, rows, cols, idx_cols, row_base, col_base, stride, n);
  return static_cast<int>(cudaGetLastError());
}

// The reference pixel v * W + u that current pixel c (its 20 channels)
// projects to, or -1 where it is invalid, its depth in the reference camera
// is out of range or it lands outside the image: pixel_terms' projection
// (pwn_terms.cuh), the plain version's fused_aligner.project_to_reference.
__device__ __forceinline__ int project_pixel(const float* c, const float* prm, const pwn::Geometry& g) {
  if (!(c[7] > 0.f)) return -1;
  const float3 q = pwn::add_rn(pwn::rot_rn(prm, make_float3(c[0], c[1], c[2])), prm + 9);
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

// Grid (K, blocks): block (k, b) covers pixel tile b against candidate k,
// as in fused_aligner_batch_kernel. out (K, 2), zeroed by the launcher:
// [rows fetched, wrapping sum of the bits of every value loaded].
__global__ void __launch_bounds__(kThreads)
projective_gather_sum_kernel(const float* __restrict__ cur, const float4* __restrict__ refs,
                             const float* __restrict__ params, unsigned* __restrict__ out, pwn::Geometry g) {
  __shared__ float prm[pwn::kParams];
  __shared__ unsigned warp_sums[kThreads / 32][2];
  const int k = blockIdx.x;
  if (threadIdx.x < pwn::kParams) prm[threadIdx.x] = params[k * pwn::kParams + threadIdx.x];
  __syncthreads();

  const int n = g.H * g.W;
  const int pix = blockIdx.y * kThreads + threadIdx.x;
  unsigned rows = 0, bits = 0;
  if (pix < n) {
    float c[pwn::kCurChannels];
#pragma unroll
    for (int ch = 0; ch < pwn::kCurChannels; ++ch) {
      c[ch] = __ldg(cur + static_cast<size_t>(ch) * n + pix);
      bits += __float_as_uint(c[ch]);
    }
    const int idx = project_pixel(c, prm, g);
    if (idx >= 0) {
      const float4* ref = refs + static_cast<size_t>(k) * n * 2;
      const float4 r0 = __ldg(ref + 2 * idx);
      const float4 r1 = __ldg(ref + 2 * idx + 1);
      bits += __float_as_uint(r0.x) + __float_as_uint(r0.y) + __float_as_uint(r0.z) + __float_as_uint(r0.w) +
              __float_as_uint(r1.x) + __float_as_uint(r1.y) + __float_as_uint(r1.z) + __float_as_uint(r1.w);
      rows = 1;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    rows += __shfl_down_sync(0xffffffffu, rows, off);
    bits += __shfl_down_sync(0xffffffffu, bits, off);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    warp_sums[warp][0] = rows;
    warp_sums[warp][1] = bits;
  }
  __syncthreads();
  if (threadIdx.x < 2) {
    unsigned s = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) s += warp_sums[w][threadIdx.x];
    atomicAdd(out + 2 * k + threadIdx.x, s);
  }
}

}  // namespace

// Each entry point enqueues one kernel on `stream` and returns
// cudaGetLastError() (0 = ok). All arrays are contiguous; x f32, idx int32.

// x (rows, n), idx (rows, cols) -> out (rows, cols): out[r,c] = x[r, idx[r,c]].
extern "C" int gather_lanes_launch(const float* x, const int* idx, float* out, int rows, int n, int cols,
                                   void* stream) {
  return launch(x, idx, out, rows, cols, cols, n, 0, 1, n, stream);
}

// x (n, cols), idx (rows, cols) -> out (rows, cols): out[r,c] = x[idx[r,c], c].
extern "C" int gather_sublanes_launch(const float* x, const int* idx, float* out, int n, int rows, int cols,
                                      void* stream) {
  return launch(x, idx, out, rows, cols, cols, 0, 1, cols, n, stream);
}

// x (n,) (any array, flattened), idx (rows, idx_cols) -> out (rows, cols),
// cols <= idx_cols: out[r,c] = x[idx[r,c]].
extern "C" int gather_flat_launch(const float* x, long long n, const int* idx, int idx_cols, float* out, int rows,
                                  int cols, void* stream) {
  return launch(x, idx, out, rows, cols, idx_cols, 0, 0, 1, n, stream);
}

// cur (20, H, W) f32, refs (K, H*W, 8) f32 (16-byte aligned), params (K, 24)
// f32 -> out (K, 2) uint32: the rows fetched and the wrapping bit sum of
// every value loaded, per candidate (see projective_gather_sum_kernel).
extern "C" int projective_gather_sum_launch(const float* cur, const float* refs, const float* params, unsigned* out,
                                            int K, int H, int W, float fx, float fy, float cx, float cy,
                                            float min_d, float max_d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(unsigned) * 2 * K, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const pwn::Geometry g{H, W, fx, fy, cx, cy, min_d, max_d, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0};
  const int blocks = (H * W + kThreads - 1) / kThreads;
  projective_gather_sum_kernel<<<dim3(K, blocks), kThreads, 0, s>>>(cur, reinterpret_cast<const float4*>(refs),
                                                                  params, out, g);
  return static_cast<int>(cudaGetLastError());
}
