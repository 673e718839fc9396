// Device code shared by kernels B3 (element_gather.cu) and B4
// (lane_select.cu): the read of scattered 4-byte elements, many to a
// thread, on Hopper.  B1 (window_sample.cu) uses its one-wave grid.
//
// On the H100 both kernels read one element at each of M scattered
// positions of a table far larger than the 50 MB L2, and the time is the
// latency of those reads: a thread that loads one id, then one element,
// then stores, keeps one read in flight and waits out two round trips to
// device memory.  Here each thread takes V consecutive elements per step
// of a grid-stride walk: it loads their ids with vector loads (16 bytes
// for V >= 4), issues all V element loads (ld.global.nc) before it uses
// any, then stores the V results with vector stores.  The grid is sized
// from the SM count and the kernel's occupancy, so the walk has no
// half-empty last wave.  Ids that are not aligned for vector loads (a view
// that starts mid-vector) are taken one by one at the head and at the
// tail of the same launch.
//
// Float results follow the TPU kernels' lane sums, which add zeros to the
// selected element: __fadd_rn(v, 0.0f) turns -0.0 into +0.0 and leaves
// every other value as it is (the intrinsic is never folded or
// contracted).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

// The walk: ids a thread takes per step, and threads a block.  Measured
// at the products hops (walk_sweep.py, which rebuilds the kernels with
// these macros set; PERF.md): V = 4 at 128 threads.
#ifndef QTT_WALK_V
#define QTT_WALK_V 4
#endif
#ifndef QTT_WALK_THREADS
#define QTT_WALK_THREADS 128
#endif

namespace qtt {

constexpr int kPerThread = QTT_WALK_V;
constexpr int kThreads = QTT_WALK_THREADS;
static_assert(kPerThread == 1 || kPerThread == 2 || kPerThread % 4 == 0,
              "ids a thread per step: 1, 2 or a multiple of 4");
static_assert(kThreads % 32 == 0 && kThreads <= 1024,
              "threads a block: a multiple of 32, at most 1024");

template <typename T>
__device__ __forceinline__ T from_word(uint32_t w);

template <>
__device__ __forceinline__ int32_t from_word<int32_t>(uint32_t w) {
  return static_cast<int32_t>(w);
}

// the lane sum's +0.0
template <>
__device__ __forceinline__ float from_word<float>(uint32_t w) {
  return __fadd_rn(__uint_as_float(w), 0.0f);
}

__device__ __forceinline__ uint32_t to_word(int32_t v) {
  return static_cast<uint32_t>(v);
}
__device__ __forceinline__ uint32_t to_word(float v) {
  return __float_as_uint(v);
}

// table[off[j]] for the V elements of one step, 0 where !ok[j], through
// the read-only path (ld.global.nc): all loads are issued before any
// result is used.
template <typename T, int V>
__device__ __forceinline__ void read_elements(const T* __restrict__ table,
                                              const int64_t (&off)[V],
                                              const bool (&ok)[V],
                                              T (&out)[V]) {
  static_assert(sizeof(T) == 4, "4-byte elements only");
  const uint32_t* words = reinterpret_cast<const uint32_t*>(table);
  uint32_t w[V];
#pragma unroll
  for (int j = 0; j < V; ++j) w[j] = ok[j] ? __ldg(words + off[j]) : 0u;
#pragma unroll
  for (int j = 0; j < V; ++j) out[j] = from_word<T>(w[j]);
}

// Bytes to which a step's V words are aligned for vector access.
template <int V>
constexpr int kAlign = V * 4 >= 16 ? 16 : V * 4;

// Elements before the first kAlign-aligned one at p, at most m.
template <int V>
__device__ __forceinline__ int64_t head_of(const void* p, int64_t m) {
  const int64_t a = static_cast<int64_t>(reinterpret_cast<uintptr_t>(p) %
                                         kAlign<V>);
  const int64_t h = ((kAlign<V> - a) % kAlign<V>) / 4;
  return h < m ? h : m;
}

template <int V>
__device__ __forceinline__ bool aligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % kAlign<V> == 0;
}

// V consecutive ids from p, by vector loads where vec.
template <int V>
__device__ __forceinline__ void load_ids(const int32_t* __restrict__ p,
                                         bool vec, int32_t (&o)[V]) {
  if constexpr (V % 4 == 0) {
    if (vec) {
#pragma unroll
      for (int j = 0; j < V; j += 4) {
        const int4 q = __ldg(reinterpret_cast<const int4*>(p + j));
        o[j] = q.x; o[j + 1] = q.y; o[j + 2] = q.z; o[j + 3] = q.w;
      }
      return;
    }
  } else if constexpr (V == 2) {
    if (vec) {
      const int2 q = __ldg(reinterpret_cast<const int2*>(p));
      o[0] = q.x; o[1] = q.y;
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < V; ++j) o[j] = __ldg(p + j);
}

// V consecutive results to p, by vector stores where vec.
template <typename T, int V>
__device__ __forceinline__ void store_vals(T* __restrict__ p, bool vec,
                                           const T (&v)[V]) {
  if constexpr (V % 4 == 0) {
    if (vec) {
#pragma unroll
      for (int j = 0; j < V; j += 4)
        *reinterpret_cast<uint4*>(p + j) = make_uint4(
            to_word(v[j]), to_word(v[j + 1]), to_word(v[j + 2]),
            to_word(v[j + 3]));
      return;
    }
  } else if constexpr (V == 2) {
    if (vec) {
      *reinterpret_cast<uint2*>(p) = make_uint2(to_word(v[0]),
                                                to_word(v[1]));
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < V; ++j) p[j] = v[j];
}

// The grid-stride walk over m elements whose first h are taken one by one:
// step(i) for each V-element step starting at element i, one(i) for each
// element of the head and of the tail (fewer than V).
template <int V, class Step, class One>
__device__ __forceinline__ void walk(int64_t m, int64_t h, Step step,
                                     One one) {
  const int64_t steps = (m - h) / V;
  const int64_t t = blockIdx.x * static_cast<int64_t>(blockDim.x)
                    + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t s = t; s < steps; s += stride) step(h + s * V);
  const int64_t tail = h + steps * V;
  if (t < h) one(t);
  if (t < m - tail) one(tail + t);
}

// Blocks for the walk of `steps` steps (one a thread) at Threads a block:
// at most as many as are resident at once (SMs times the kernel's blocks
// per SM), so the walk runs in one wave.  The occupancy is looked up once
// per kernel and device.
template <auto Kernel, int Threads = kThreads>
cudaError_t grid_for(int64_t steps, unsigned* blocks) {
  constexpr int kDevices = 16;
  static std::atomic<int> resident[kDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  int cap = dev < kDevices ? resident[dev].load() : 0;
  if (cap == 0) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Kernel,
                                                      Threads, 0);
    if (e != cudaSuccess) return e;
    cap = sms * (per_sm > 0 ? per_sm : 1);
    if (dev < kDevices) resident[dev].store(cap);
  }
  const int64_t need = (steps + Threads - 1) / Threads;
  *blocks = static_cast<unsigned>(need < 1 ? 1 : (need < cap ? need : cap));
  return cudaSuccess;
}

}  // namespace qtt
