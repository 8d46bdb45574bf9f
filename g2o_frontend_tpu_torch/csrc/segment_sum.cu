// Deterministic segment sum: out[s, c] = sum of values[order[k], c] for k in
// [offsets[s], offsets[s + 1]), added in k order from +0.0, with no atomics.
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
// plain version bit for bit, in float32 and float64. The adds are
// __fadd_rn / __dadd_rn, which the compiler never contracts or reorders.
// The rows of the dump slot (offsets[n] onwards) are never read.
//
// Why no tree: a float sum rounds after every add, so its bits depend on the
// order of the adds. A tree, a warp-shuffle reduction, partial sums combined
// afterwards or atomics would each give other bits than the CPU's. So every
// (segment, column) is added by one thread, in k order. The order fixes the
// adds, not the loads: those may run in any order and in parallel.
//
// Bound: bytes. Each input read once and the output written once: values
// E*C*w B (w = 4 or 8), order E*4 B, offsets (n+1)*4 B, out n*C*w B, over
// the card's 3.35 TB/s; one add per value is far below the float rates. A
// long segment is also bound by its chain of dependent adds (~5 ns a row
// here), which no order-keeping design can shorten.
//
// Design: one launch a sum (the solvers are bound by the host's launches),
// two paths; which one a segment takes is decided on the device, from its
// length L = offsets[s+1] - offsets[s] and the index's lengths, with no
// host read.
//
// - Long segments (L >= long_min, 32 rows; but L >= medium_min, 128 rows,
//   where more segments have 32 rows than there are long blocks: a long
//   block would then walk them one after another, where short-path threads
//   walk them side by side): SegmentIndex keeps the segments sorted by
//   length, longest first (`ids`, and their lengths `lengths`), built on
//   the device with no host read, so lengths[G] tells every thread which
//   threshold holds. The last G blocks of the grid take list entries
//   l, l + G, ... while they are long,
//   and cut each segment into chunks of up to R rows. A chunk's order
//   entries, then its rows, are copied into shared memory with cp.async,
//   thread t taking rows t, t + 256, ..., in pieces of 16, 8 or 4 bytes
//   (the widest the row's size and the pointer's alignment allow); the
//   order entries two chunks ahead of the rows, the rows two chunks ahead
//   of the adds. Then C threads, one a column, add the staged chunk in row
//   order, the shared-memory loads of the next 4 rows issued before the
//   adds of the current 4. So a segment's loads are many and in flight
//   together, where the previous design had one thread walk the segment 8
//   rows at a time with two dependent loads a row; the running sum stays in
//   the adding thread's register across chunks. One thread steps the walk
//   over the list and keeps its state in shared memory. TMA is not the tool
//   here: on sm_90 it copies boxes of a tensor and has no gather of rows at
//   arbitrary indices.
// - Short segments: the first blocks each take 256 (or 1,024) consecutive
//   outputs. In a dense sum a thread adds one output's rows in k order,
//   UNROLL loads ahead of their adds, as the previous design did; the C
//   threads of a segment read its offsets through L1 (staging them in
//   shared memory behind a barrier measured slower). In a sparse sum (no
//   more rows than segments, at least 2^20 outputs: the Schur arrow's 1.07 M
//   (pose, landmark) slots, a fusion's 614,400 slots) a thread takes 16
//   bytes of consecutive outputs, adds their rows in step so that their
//   loads are in flight together, and writes them with one 16-byte store.
//   No 64-bit division per thread. The long blocks follow the short ones
//   in the grid: where no segment is long they read one list entry and
//   leave (the sums measured slower when the last short blocks took the
//   long work as well).
//
// Resources: 40 registers a thread (six blocks of 256 threads an SM; at 32
// the long path spills), 48 in the sparse sums' instantiation (five
// blocks; at 40 it spills), and, for the long path, shared memory for the
// walk, 3 chunks of order entries and 3 of rows (up to 16 KB each, 6 KB
// when the short blocks are many), set by the wrapper; over 48 KB needs
// segment_sum_init's cudaFuncSetAttribute. segment_sum_constants gives the
// wrapper this file's geometry, so the two cannot part.
//
// The previous design (one thread per (segment, column) over all segments)
// stays as segment_sum_previous_*_launch, the yardstick this kernel is
// timed against; nothing else launches it.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int NSTAGE = 3;         // staged chunks of rows: NSTAGE - 1 in flight while one is added
constexpr int NORD = 3;           // staged chunks of order entries: those of chunks q + 2 .. q + 4
constexpr int NREC = NSTAGE + 3;  // chunk records: those of chunks q .. q + 5
constexpr int RPT = 2;            // rows of a chunk one thread copies, at most
constexpr int UNROLL = 8;         // rows loaded ahead of their adds, short path (and the previous design)
constexpr int SMEM_UNROLL = 4;    // staged rows loaded ahead of the current ones' adds, long path
constexpr int MIN_BLOCKS = 6;     // blocks an SM the registers must allow (40 registers)
constexpr int MIN_BLOCKS_SPARSE = 5;  // the same for the sparse sums' kernel (48 registers: at 40 it spills)
constexpr int VEC_BYTES = 16;     // bytes of outputs a short-path thread takes in a sparse sum
constexpr int WALKER = THREADS - 1;  // the thread that steps a long block's walk (not in the adders' warp)
constexpr int MAX_SMEM = 227 * 1024;
constexpr int FIRST = 1, LAST = 2;

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }

template <int W>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (W == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
  } else if constexpr (W == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One chunk of a long segment: its rows k .. k + count - 1 of `order`.
// count 0 marks the end of the block's list.
struct Chunk {
  int s, k, count, flags;
};

// What a long block walks: list entries first, first + G, ... of the
// segments by length (`ids`, `lengths`; a segment starts at offsets[id])
// while they are long (long_threshold), each cut into chunks of up to R
// rows.
struct LongArgs {
  const int64_t* ids;
  const int32_t* lengths;
  const int32_t* offsets;
  int n, G, long_min, R, first;
};

// The rows from which a segment is long: long_min, or medium_min where
// more segments have long_min rows than there are long blocks (the list is
// longest first, so lengths[G] is the (G + 1)-th longest). Read only by
// threads whose segment has long_min rows or more.
__device__ __forceinline__ int long_threshold(const int32_t* lengths, int n, int G, int long_min, int medium_min) {
  return G < n && __ldg(lengths + G) >= long_min ? medium_min : long_min;
}

// A list entry: a segment and its (start, length).
struct Entry {
  int id;
  int2 span;
};

__device__ __forceinline__ Entry entry_at(const LongArgs& a, long long i) {
  if (i >= a.n) return Entry{-1, make_int2(0, 0)};
  const int id = static_cast<int>(__ldg(a.ids + i));
  return Entry{id, make_int2(__ldg(a.offsets + id), __ldg(a.lengths + i))};
}

// The walk's state, kept in shared memory between steps by the one thread
// that steps it.
struct alignas(16) Walk {
  long long i;           // list entry of the current segment
  int s, k, end, fresh;  // current segment (-1: none left), its next row, its end; k is its first row
};

// shared memory of a long block before its order entries and rows
constexpr int LONG_HEAD = NREC * sizeof(Chunk) + sizeof(Walk);

// entry e becomes the walk's current segment (none below a.long_min rows,
// the block's threshold: the list is longest first)
__device__ __forceinline__ void take(const LongArgs& a, Walk& w, const Entry& e) {
  w.s = e.span.y >= a.long_min ? e.id : -1;
  w.k = e.span.x;
  w.end = e.span.x + e.span.y;
  w.fresh = 1;
}

// The current chunk of the walk; then step to the next one.
__device__ __forceinline__ Chunk step(const LongArgs& a, Walk& w) {
  Chunk c{-1, 0, 0, 0};
  if (w.s < 0) return c;
  c.s = w.s;
  c.k = w.k;
  c.count = min(a.R, w.end - w.k);
  c.flags = (w.fresh ? FIRST : 0) | (w.k + c.count >= w.end ? LAST : 0);
  w.k += c.count;
  w.fresh = 0;
  if (w.k >= w.end) {
    w.i += a.G;
    take(a, w, entry_at(a, w.i));
  }
  return c;
}

// acc + rows[0] + rows[C] + ... + rows[(count - 1) * C], one add after the
// other; the shared-memory loads of the next SMEM_UNROLL rows are issued
// before the adds of the current ones.
template <typename T>
__device__ __forceinline__ T add_rows(T acc, const T* rows, int count, int C) {
  int r = 0;
  if (count >= 2 * SMEM_UNROLL) {
    T cur[SMEM_UNROLL], nxt[SMEM_UNROLL];
#pragma unroll
    for (int u = 0; u < SMEM_UNROLL; ++u) cur[u] = rows[u * C];
    for (r = SMEM_UNROLL; r + SMEM_UNROLL <= count; r += SMEM_UNROLL) {
#pragma unroll
      for (int u = 0; u < SMEM_UNROLL; ++u) nxt[u] = rows[(r + u) * C];
#pragma unroll
      for (int u = 0; u < SMEM_UNROLL; ++u) acc = add(acc, cur[u]);
#pragma unroll
      for (int u = 0; u < SMEM_UNROLL; ++u) cur[u] = nxt[u];
    }
#pragma unroll
    for (int u = 0; u < SMEM_UNROLL; ++u) acc = add(acc, cur[u]);
  }
  for (; r < count; ++r) acc = add(acc, rows[r * C]);
  return acc;
}

template <int W>
__device__ __forceinline__ void copy_row(unsigned char* dst, const unsigned char* src, int pieces) {
  for (int p = 0; p < pieces; ++p) cp_async<W>(dst + p * W, src + p * W);
}

// Long path: one block's long segments, staged through shared memory;
// `first` is the block's first list entry (loaded by the WALKER thread
// only). Step q adds chunk q, copies the rows of chunk q + 2 (their order
// entries staged two steps before), copies the order entries of chunk
// q + 4, and the WALKER thread writes the record of chunk q + 5. One
// cp.async group a step; waiting for all but the newest lands the rows of
// chunk q and the order entries of chunk q + 2.
template <typename T>
__device__ void long_block(const T* __restrict__ values, const int32_t* __restrict__ order, const LongArgs& a,
                           const Entry& first, T* __restrict__ out, int C, int W, int stage_bytes,
                           unsigned char* smem) {
  Chunk* rec = reinterpret_cast<Chunk*>(smem);
  Walk* walk = reinterpret_cast<Walk*>(smem + NREC * sizeof(Chunk));
  int32_t* ord = reinterpret_cast<int32_t*>(smem + LONG_HEAD);
  unsigned char* stages = smem + LONG_HEAD + ((NORD * a.R * 4 + 15) & ~15);
  const int tid = threadIdx.x;
  const int row_bytes = C * static_cast<int>(sizeof(T));
  const int pieces = row_bytes / W;
  const unsigned char* src_base = reinterpret_cast<const unsigned char*>(values);

  // this thread's order entries of chunk c (rows tid, tid + THREADS, ...) into slot q % NORD
  auto copy_order = [&](const Chunk& c, int q) {
    int32_t* slot = ord + (q % NORD) * a.R;
    for (int r = tid; r < c.count; r += THREADS) cp_async<4>(slot + r, order + c.k + r);
  };
  // this thread's rows of chunk c (the same rows) into stage q % NSTAGE
  auto copy_rows = [&](const Chunk& c, int q) {
    const int32_t* slot = ord + (q % NORD) * a.R;
    unsigned char* stage = stages + (q % NSTAGE) * stage_bytes;
    for (int r = tid; r < c.count; r += THREADS) {
      const unsigned char* src = src_base + static_cast<int64_t>(slot[r]) * row_bytes;
      if (W == 16) {
        copy_row<16>(stage + r * row_bytes, src, pieces);
      } else if (W == 8) {
        copy_row<8>(stage + r * row_bytes, src, pieces);
      } else {
        copy_row<4>(stage + r * row_bytes, src, pieces);
      }
    }
  };

  if (tid == WALKER) {
    Walk w;
    w.i = a.first;
    take(a, w, first);
    for (int q = 0; q < NREC - 1; ++q) rec[q] = step(a, w);
    *walk = w;
  }
  __syncthreads();
  if (rec[0].count == 0) return;  // no long segment for this block (uniform)
  // prologue: the order entries of chunks 0 .. 2, then the rows of chunks 0
  // and 1 and the order entries of chunk 3
  for (int q = 0; q < NORD; ++q) copy_order(rec[q], q);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  copy_rows(rec[0], 0);
  cp_async_commit();
  copy_rows(rec[1], 1);
  copy_order(rec[3], 3);
  cp_async_commit();

  T acc = T(0);
  for (int q = 0;; ++q) {
    cp_async_wait<1>();  // this thread's rows of chunk q and order entries of chunk q + 2 have landed
    __syncthreads();     // everyone's have; step q - 1 is done
    const Chunk cur = rec[q % NREC];
    if (cur.count == 0) break;
    copy_rows(rec[(q + 2) % NREC], q + 2);   // into the stage chunk q - 1 held
    copy_order(rec[(q + 4) % NREC], q + 4);  // into the slot chunk q + 1's entries held
    cp_async_commit();
    if (tid == WALKER) {  // in the last warp: a switch's loads overlap the adds of the first
      Walk w = *walk;
      rec[(q + 5) % NREC] = step(a, w);
      *walk = w;
    }
    if (tid < C) {
      const T* rows = reinterpret_cast<const T*>(stages + (q % NSTAGE) * stage_bytes) + tid;
      if (cur.flags & FIRST) acc = T(0);
      acc = add_rows(acc, rows, cur.count, C);
      if (cur.flags & LAST) out[static_cast<int64_t>(cur.s) * C + tid] = acc;
    }
  }
}

__device__ __forceinline__ int64_t div_by(int64_t x, int C, int64_t total) {
  return total <= 0xffffffffLL ? static_cast<int64_t>(static_cast<uint32_t>(x) / static_cast<uint32_t>(C)) : x / C;
}

// Short path, dense sums: output tile * THREADS + threadIdx.x, its
// segment's rows added in k order, UNROLL loads ahead of their adds; the
// outputs of long segments are left to the long blocks.
template <typename T>
__device__ void short_one(const T* __restrict__ values, const int32_t* __restrict__ order,
                          const int32_t* __restrict__ offsets, const int32_t* __restrict__ lengths, T* __restrict__ out,
                          int64_t total, int C, int n, int G, int long_min, int medium_min, int64_t tile) {
  const int64_t o = tile * THREADS + threadIdx.x;
  if (o >= total) return;
  const int64_t j = div_by(o, C, total);
  const int c = static_cast<int>(o - j * C);
  int k = __ldg(offsets + j);
  const int k1 = __ldg(offsets + j + 1);
  if (k1 - k >= long_min && k1 - k >= long_threshold(lengths, n, G, long_min, medium_min)) return;
  T acc = T(0);
  for (; k + UNROLL <= k1; k += UNROLL) {
    T v[UNROLL];
#pragma unroll
    for (int r = 0; r < UNROLL; ++r) v[r] = __ldg(values + static_cast<int64_t>(__ldg(order + k + r)) * C + c);
#pragma unroll
    for (int r = 0; r < UNROLL; ++r) acc = add(acc, v[r]);
  }
  for (; k < k1; ++k) acc = add(acc, __ldg(values + static_cast<int64_t>(__ldg(order + k)) * C + c));
  out[o] = acc;
}

template <typename T, int V>
struct Vec;
template <>
struct Vec<float, 4> {
  static __device__ void store(float* p, const float* a) { *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]); }
};
template <>
struct Vec<double, 2> {
  static __device__ void store(double* p, const double* a) { *reinterpret_cast<double2*>(p) = make_double2(a[0], a[1]); }
};

// Short path, sparse sums: V consecutive outputs a thread. Their offsets
// are loaded at once, their rows added in step (row t of each at once), so
// their loads are in flight together, and the V sums go out in one store
// when none of them is a long segment's.
template <typename T, int V>
__device__ void short_vec(const T* __restrict__ values, const int32_t* __restrict__ order,
                          const int32_t* __restrict__ offsets, const int32_t* __restrict__ lengths, T* __restrict__ out,
                          int64_t total, int C, int n, int G, int long_min, int medium_min, int64_t tile) {
  const int64_t o0 = (tile * THREADS + threadIdx.x) * V;
  if (o0 >= total) return;
  const int64_t j0 = div_by(o0, C, total);
  const int c0 = static_cast<int>(o0 - j0 * C);
  int k[V], k1[V];  // output u's rows k[u] .. k1[u] - 1 of `order`; k1[u] = -1: a long segment's
#pragma unroll
  for (int u = 0; u < V; ++u) {
    k[u] = k1[u] = 0;
    if (o0 + u < total) {
      const int64_t j = j0 + (c0 + u) / C;
      k[u] = __ldg(offsets + j);
      k1[u] = __ldg(offsets + j + 1);
    }
  }
  bool all = o0 + V <= total;
  int rows = 0;
#pragma unroll
  for (int u = 0; u < V; ++u) {
    if (k1[u] - k[u] >= long_min && k1[u] - k[u] >= long_threshold(lengths, n, G, long_min, medium_min)) {
      k1[u] = -1;
      all = false;
    }
    rows = max(rows, k1[u] - k[u]);
  }
  T acc[V];
#pragma unroll
  for (int u = 0; u < V; ++u) acc[u] = T(0);
  for (int t = 0; t < rows; ++t) {
    T v[V];
#pragma unroll
    for (int u = 0; u < V; ++u)
      v[u] = k[u] + t < k1[u] ? __ldg(values + static_cast<int64_t>(__ldg(order + k[u] + t)) * C + (c0 + u) % C)
                              : T(0);
#pragma unroll
    for (int u = 0; u < V; ++u)
      if (k[u] + t < k1[u]) acc[u] = add(acc[u], v[u]);
  }
  if (all) {
    Vec<T, V>::store(out + o0, acc);
  } else {
#pragma unroll
    for (int u = 0; u < V; ++u)
      if (o0 + u < total && k1[u] >= 0) out[o0 + u] = acc[u];
  }
}

// Blocks 0 .. short_blocks - 1 take a short tile each; the G after them,
// the long list from entries 0 .. G - 1. What the short path reads comes
// first among the parameters (within the first 64 bytes).
template <typename T, int V>
__global__ void __launch_bounds__(THREADS, V > 1 ? MIN_BLOCKS_SPARSE : MIN_BLOCKS)
    segment_sum_kernel(const T* __restrict__ values, const int32_t* __restrict__ order,
                       const int32_t* __restrict__ offsets, T* __restrict__ out, int64_t n, int C, int short_blocks,
                       int long_min, int medium_min, const int32_t* __restrict__ lengths,
                       const int64_t* __restrict__ ids, int G, int R, int W, int stage_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = static_cast<int>(blockIdx.x);
  const int segments = static_cast<int>(n);
  if (b < short_blocks) {
    if constexpr (V == 1) {
      short_one<T>(values, order, offsets, lengths, out, n * C, C, segments, G, long_min, medium_min, b);
    } else {
      short_vec<T, V>(values, order, offsets, lengths, out, n * C, C, segments, G, long_min, medium_min, b);
    }
  } else {
    // only the WALKER thread reads the threshold and the first entry
    const bool walker = threadIdx.x == WALKER;
    const LongArgs a{ids, lengths, offsets, segments, G,
                     walker ? long_threshold(lengths, segments, G, long_min, medium_min) : long_min, R,
                     b - short_blocks};
    const Entry first = walker ? entry_at(a, a.first) : Entry{-1, make_int2(0, 0)};
    long_block<T>(values, order, a, first, out, C, W, stage_bytes, smem);
  }
}

template <typename T>
int set_smem_limit() {
  constexpr int VEC = VEC_BYTES / sizeof(T);
  int err = static_cast<int>(
      cudaFuncSetAttribute(segment_sum_kernel<T, 1>, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM));
  if (err == 0 && VEC > 1)
    err = static_cast<int>(
        cudaFuncSetAttribute(segment_sum_kernel<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM));
  return err;
}

// Layout as ops/segment_sum.layout gives it; the checks keep a wrong one
// from launching.
template <typename T>
int launch(const void* values, const void* order, const void* offsets, const void* ids, const void* lengths, void* out,
           int64_t n, int C, int long_min, int medium_min, int G, int R, int W, int stage_bytes, int V, int smem,
           void* stream) {
  const int64_t total = n * C;
  if (total <= 0) return 0;
  constexpr int VEC = VEC_BYTES / sizeof(T);
  const int row_bytes = C * static_cast<int>(sizeof(T));
  if ((V != 1 && V != VEC) || G < 0 || smem < 0 || smem > MAX_SMEM || medium_min < long_min)
    return static_cast<int>(cudaErrorInvalidValue);
  if (G > 0 && (C > THREADS || (W != 4 && W != 8 && W != 16) || W < static_cast<int>(sizeof(T)) ||
                row_bytes % W != 0 || R < 1 || R > THREADS * RPT || stage_bytes < R * row_bytes ||
                stage_bytes % 16 != 0 || LONG_HEAD + ((NORD * R * 4 + 15) & ~15) + NSTAGE * stage_bytes > smem))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t short_blocks = (total + THREADS * V - 1) / (THREADS * V);
  const int64_t blocks = short_blocks + G;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* v = static_cast<const T*>(values);
  const auto* o = static_cast<const int32_t*>(order);
  const auto* f = static_cast<const int32_t*>(offsets);
  const auto* d = static_cast<const int64_t*>(ids);
  const auto* len = static_cast<const int32_t*>(lengths);
  auto* y = static_cast<T*>(out);
  const auto grid = static_cast<unsigned>(blocks);
  const int sb = static_cast<int>(short_blocks);
  if (V == 1) {
    segment_sum_kernel<T, 1><<<grid, THREADS, smem, s>>>(v, o, f, y, n, C, sb, long_min, medium_min, len, d, G, R, W,
                                                          stage_bytes);
  } else {
    segment_sum_kernel<T, VEC><<<grid, THREADS, smem, s>>>(v, o, f, y, n, C, sb, long_min, medium_min, len, d, G, R, W,
                                                            stage_bytes);
  }
  return static_cast<int>(cudaGetLastError());
}

// The previous design: one thread per (segment, column) over all
// segments, UNROLL loads ahead of their adds.
template <typename T>
__global__ void __launch_bounds__(THREADS) segment_sum_previous_kernel(const T* __restrict__ values,
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
int launch_previous(const void* values, const void* order, const void* offsets, void* out, int64_t n, int C,
                    void* stream) {
  const int64_t total = n * C;
  if (total <= 0) return 0;
  const int64_t blocks = (total + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  segment_sum_previous_kernel<T><<<static_cast<unsigned>(blocks), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(values), static_cast<const int32_t*>(order), static_cast<const int32_t*>(offsets),
      static_cast<T*>(out), n, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Lets every instantiation take up to MAX_SMEM of dynamic shared memory;
// called once, before any launch (and outside any stream capture).
int segment_sum_init() {
  const int err = set_smem_limit<float>();
  return err != 0 ? err : set_smem_limit<double>();
}

// The geometry ops/segment_sum.layout must share with this file: THREADS,
// RPT, NSTAGE, NORD, LONG_HEAD, VEC_BYTES and MAX_SMEM, into out[0 .. 6].
// Returns the number of values.
int segment_sum_constants(int* out) {
  const int values[] = {THREADS, RPT, NSTAGE, NORD, LONG_HEAD, VEC_BYTES, MAX_SMEM};
  for (int i = 0; i < 7; ++i) out[i] = values[i];
  return 7;
}

// values (E, C) row-major; order (E,) int32; offsets (n + 1,) int32; ids
// (n,) int64 and lengths (n,) int32, the segments longest first and their
// lengths, from SegmentIndex; out (n, C). The layout (long_min .. smem) is
// ops/segment_sum.layout's. Returns cudaGetLastError() after the launch (0
// when n * C is 0: no launch), or cudaErrorInvalidValue for a layout the
// kernel does not take.
int segment_sum_f32_launch(const void* values, const void* order, const void* offsets, const void* ids,
                           const void* lengths, void* out, int64_t n, int C, int long_min, int medium_min, int G, int R,
                           int W, int stage_bytes, int V, int smem, void* stream) {
  return launch<float>(values, order, offsets, ids, lengths, out, n, C, long_min, medium_min, G, R, W, stage_bytes, V,
                       smem, stream);
}

int segment_sum_f64_launch(const void* values, const void* order, const void* offsets, const void* ids,
                           const void* lengths, void* out, int64_t n, int C, int long_min, int medium_min, int G, int R,
                           int W, int stage_bytes, int V, int smem, void* stream) {
  return launch<double>(values, order, offsets, ids, lengths, out, n, C, long_min, medium_min, G, R, W, stage_bytes, V,
                        smem, stream);
}

// The previous design, for timing only.
int segment_sum_previous_f32_launch(const void* values, const void* order, const void* offsets, void* out, int64_t n,
                                    int C, void* stream) {
  return launch_previous<float>(values, order, offsets, out, n, C, stream);
}

int segment_sum_previous_f64_launch(const void* values, const void* order, const void* offsets, void* out, int64_t n,
                                    int C, void* stream) {
  return launch_previous<double>(values, order, offsets, out, n, C, stream);
}

}  // extern "C"
