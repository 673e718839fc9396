// Kernel B3: element gather over a flat table of n 4-byte elements (int32
// or fp32), each id clamped into the table:
//   element_gather:       out[i] = flat[clamp(idx[i], 0, n - 1)]
//   element_gather_pair:  lo[i]  = flat[clamp(idx[i], 0, n - 1)],
//                         hi[i]  = flat[clamp(idx[i] + 1, 0, n - 1)]
// (idx[i] + 1 in 64 bits, so no id wraps).
//
// Replaces quiver_tpu/ops/pallas/sample_gather_kernel.py::
// pallas_element_gather, which DMAs the whole 512-byte, 128-lane row that
// covers each element into VMEM (128 copies in flight per group, double
// buffered) and selects the lane with a one-hot sum, because the TPU's
// scalar loads serialize.  It is the sampler's indptr and indices read
// under gather_mode="pallas": the pair entry reads a hop's start and end
// (indptr[s], indptr[s + 1]) in one launch, the single entry its draws
// from indices.
//
// What bounds it on the H100: scattered reads.  The least time counts the
// distinct 32-byte sectors the reads touch, the ids read and the results
// written once: 0.0090 ms for products' hop 3 (0.0019 ms for the pair
// read, 0.0071 for the indices read).  But the card reports an L2 fetch
// granularity of 64 bytes (cudaLimitMaxL2FetchGranularity), so a
// scattered read moves about twice the sector count from device memory,
// and a launch costs a few microseconds however small (about 0.0055 ms
// for 1,024 ids).  The design (element_gather.cuh): each thread walks V
// consecutive ids per step with 16-byte loads, issues all its V (pair:
// 2V) element loads before it uses any, and stores with 16-byte stores,
// in a grid sized to one wave of resident blocks.  The pair's two words
// usually share a sector, so one thread reads both, and a launch and the
// second pass over indptr go.
//
// The measured choice (walk_sweep.py at the three products hops, NVIDIA
// H100 80GB HBM3 at 700 W; PERF.md): V = 4 and 128 threads a block
// (element_gather.cuh).  At hop 3 the walks of V in {1, 2, 4, 8} at 128,
// 256 and 512 threads read indices in 0.0147-0.0164 ms and the pair in
// 0.0072-0.0078 ms, except V = 8 at 512 threads (pair 0.0100); V = 4 at
// 128 was the fastest indices read and tied V = 2 at 128 on the sum over
// the hops.  The loads per thread barely matter; the pair launch gave the
// measured gain (the one-wave grid's share was not measured alone).  An
// L2 evict-first hint on the indices loads made the indices read slower
// alone and is not used.

#include "element_gather.cuh"

namespace {

using qtt::kPerThread;
using qtt::kThreads;

template <typename T>
__global__ void element_gather_kernel(const T* __restrict__ table, int64_t n,
                                      const int32_t* __restrict__ idx,
                                      T* __restrict__ out, int64_t m) {
  constexpr int V = kPerThread;
  const int64_t h = qtt::head_of<V>(idx, m);
  const bool vec_out = qtt::aligned<V>(out + h);
  auto clamp = [n](int64_t j) { return j < 0 ? 0 : (j >= n ? n - 1 : j); };
  qtt::walk<V>(
      m, h,
      [&](int64_t i) {
        int32_t id[V];
        qtt::load_ids<V>(idx + i, true, id);
        int64_t off[V];
        bool ok[V];
#pragma unroll
        for (int j = 0; j < V; ++j) {
          off[j] = clamp(id[j]);
          ok[j] = true;
        }
        T v[V];
        qtt::read_elements<T, V>(table, off, ok, v);
        qtt::store_vals<T, V>(out + i, vec_out, v);
      },
      [&](int64_t i) {
        const int64_t off[1] = {clamp(idx[i])};
        const bool ok[1] = {true};
        T v[1];
        qtt::read_elements<T, 1>(table, off, ok, v);
        out[i] = v[0];
      });
}

template <typename T>
__global__ void element_gather_pair_kernel(const T* __restrict__ table,
                                           int64_t n,
                                           const int32_t* __restrict__ idx,
                                           T* __restrict__ lo,
                                           T* __restrict__ hi, int64_t m) {
  constexpr int V = kPerThread;
  const int64_t h = qtt::head_of<V>(idx, m);
  const bool vec_lo = qtt::aligned<V>(lo + h);
  const bool vec_hi = qtt::aligned<V>(hi + h);
  auto clamp = [n](int64_t j) { return j < 0 ? 0 : (j >= n ? n - 1 : j); };
  qtt::walk<V>(
      m, h,
      [&](int64_t i) {
        int32_t id[V];
        qtt::load_ids<V>(idx + i, true, id);
        int64_t off[2 * V];
        bool ok[2 * V];
#pragma unroll
        for (int j = 0; j < V; ++j) {
          off[j] = clamp(id[j]);
          off[V + j] = clamp(static_cast<int64_t>(id[j]) + 1);
          ok[j] = ok[V + j] = true;
        }
        T v[2 * V];
        qtt::read_elements<T, 2 * V>(table, off, ok, v);
        T a[V], b[V];
#pragma unroll
        for (int j = 0; j < V; ++j) {
          a[j] = v[j];
          b[j] = v[V + j];
        }
        qtt::store_vals<T, V>(lo + i, vec_lo, a);
        qtt::store_vals<T, V>(hi + i, vec_hi, b);
      },
      [&](int64_t i) {
        const int64_t off[2] = {clamp(idx[i]),
                                clamp(static_cast<int64_t>(idx[i]) + 1)};
        const bool ok[2] = {true, true};
        T v[2];
        qtt::read_elements<T, 2>(table, off, ok, v);
        lo[i] = v[0];
        hi[i] = v[1];
      });
}

template <typename T>
cudaError_t launch(const void* table, int64_t n, const void* idx, void* out,
                   int64_t m, cudaStream_t stream) {
  unsigned blocks = 0;
  cudaError_t e = qtt::grid_for<element_gather_kernel<T>>(
      (m + kPerThread - 1) / kPerThread, &blocks);
  if (e != cudaSuccess) return e;
  element_gather_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(table), n, static_cast<const int32_t*>(idx),
      static_cast<T*>(out), m);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_pair(const void* table, int64_t n, const void* idx,
                        void* lo, void* hi, int64_t m, cudaStream_t stream) {
  unsigned blocks = 0;
  cudaError_t e = qtt::grid_for<element_gather_pair_kernel<T>>(
      (m + kPerThread - 1) / kPerThread, &blocks);
  if (e != cudaSuccess) return e;
  element_gather_pair_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(table), n, static_cast<const int32_t*>(idx),
      static_cast<T*>(lo), static_cast<T*>(hi), m);
  return cudaGetLastError();
}

}  // namespace

// is_float: 1 for fp32 tables, 0 for int32 ones.
extern "C" int element_gather(const void* table, int64_t n, const void* idx,
                              void* out, int64_t m, int is_float,
                              void* stream) {
  if (m <= 0) return static_cast<int>(cudaGetLastError());
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      is_float ? launch<float>(table, n, idx, out, m, s)
               : launch<int32_t>(table, n, idx, out, m, s));
}

extern "C" int element_gather_pair(const void* table, int64_t n,
                                   const void* idx, void* lo, void* hi,
                                   int64_t m, int is_float, void* stream) {
  if (m <= 0) return static_cast<int>(cudaGetLastError());
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      is_float ? launch_pair<float>(table, n, idx, lo, hi, m, s)
               : launch_pair<int32_t>(table, n, idx, lo, hi, m, s));
}
