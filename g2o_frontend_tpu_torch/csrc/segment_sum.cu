// Deterministic segment sum: out[s, c] = sum of values[order[k], c] for k in
// [offsets[s], offsets[s + 1]), added in k order from 0, with no atomics.
//
// Replaces: jax.ops.segment_sum (an XLA operation, not a Pallas kernel; for
// example g2o_frontend_tpu/solvers/pose_graph.py:174-186), which the port
// first wrote as a float32 index_add_. On the card index_add_ is an
// atomicAdd per element, so the order of the adds, and the rounding of the
// sums, changes from run to run; the LM solvers then part from run to run.
//
// Order: `order` is a stable argsort of the segment index (built once per
// index by ops/segment_sum.SegmentIndex), so each segment's rows are added
// in their original order. That is the order of the CPU's index_add_, which
// adds row by row into zeros: on the same inputs this kernel equals the CPU
// plain version bit for bit. The additions are plain adds (no FMA can
// contract them: nothing is multiplied).
//
// Bound: bytes. Each input is read once and the output written once:
// values E*C*4 B, order E*4 B, offsets (n+1)*4 B, out n*C*4 B, over the
// card's 3.35 TB/s; one add per value read is far below the float32 rate.
//
// Design: one thread per (segment, column), the column fastest, so the
// threads of one segment read one contiguous row of C values together. A
// thread starts the loads of UNROLL rows before it adds them, so a long
// segment (BA's ~800 rows a camera) keeps several loads in flight while the
// adds stay in row order. Short and empty segments (the Schur arrow's
// 1.07 M (pose, landmark) slots, mostly empty) cost one offsets read.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 8;

template <typename T>
__global__ void __launch_bounds__(THREADS) segment_sum_kernel(const T* __restrict__ values,
                                                              const int32_t* __restrict__ order,
                                                              const int32_t* __restrict__ offsets,
                                                              T* __restrict__ out, int64_t n, int C) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (t >= n * C) return;
  const int64_t s = t / C;
  const int c = static_cast<int>(t - s * C);
  int k = __ldg(offsets + s);
  const int k1 = __ldg(offsets + s + 1);
  T acc = T(0);
  for (; k + UNROLL <= k1; k += UNROLL) {
    T v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) v[u] = __ldg(values + static_cast<int64_t>(__ldg(order + k + u)) * C + c);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) acc = acc + v[u];
  }
  for (; k < k1; ++k) acc = acc + __ldg(values + static_cast<int64_t>(__ldg(order + k)) * C + c);
  out[t] = acc;
}

template <typename T>
int launch(const void* values, const void* order, const void* offsets, void* out, int64_t n, int C,
           void* stream) {
  const int64_t total = n * C;
  if (total <= 0) return 0;
  const int64_t blocks = (total + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  segment_sum_kernel<T><<<static_cast<unsigned>(blocks), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(values), static_cast<const int32_t*>(order), static_cast<const int32_t*>(offsets),
      static_cast<T*>(out), n, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// values (E, C) row-major; order (E,) int32; offsets (n + 1,) int32; out (n, C).
// Returns cudaGetLastError() after the launch (0 when n * C is 0: no launch).
int segment_sum_f32_launch(const void* values, const void* order, const void* offsets, void* out, int64_t n, int C,
                           void* stream) {
  return launch<float>(values, order, offsets, out, n, C, stream);
}

int segment_sum_f64_launch(const void* values, const void* order, const void* offsets, void* out, int64_t n, int C,
                           void* stream) {
  return launch<double>(values, order, offsets, out, n, C, stream);
}

}  // extern "C"
