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

}  // namespace pwn
