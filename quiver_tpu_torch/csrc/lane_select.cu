// Kernel B4: lane select over rows of 128 4-byte elements (int32 or fp32),
// 0 for a lane outside [0, 128):
//   lane_select_rows:  out[i] = table[clamp(row[i], 0, R - 1), lane[i]]
//                      over the [R, 128] table itself (the row gather
//                      fused in);
//   lane_select:       out[i] = rows[i, lanes[i]] over gathered rows
//                      [M, 128], the TPU kernel's own interface.
//
// Replaces quiver_tpu/ops/pallas/element_gather_kernel.py::lane_select,
// which reduces blocks of 1,024 rows [1024, 128] to one lane each with a
// one-hot sum.  It is the lane half of ops/fastgather.py::
// element_gather(fused=True), the sampler's gather_mode="lanes_fused".
// On the TPU the jnp.take row gather in front of it fuses into the
// kernel's input stream, so the [M, 128] rows stream through VMEM and
// never land in device memory.
//
// What bounds it on the H100: scattered reads, as B3.  The function
// needs one element of each selected row, one 32-byte sector (of which the
// card fetches 64 bytes: its L2 fetch granularity), never the 512-byte
// row; the least time counts the distinct sectors touched, the row and
// lane ids read and the results written once.  The design:
// lane_select_rows reads each selected element straight from the table,
// so the [M, 128] rows (461 MB at products' hop 3, 128 times the payload)
// are neither written nor read; it is B3's read (element_gather.cuh: V
// ids a thread per step, all loads in flight before any use, one wave of
// resident blocks) with a row clamp and a lane test in place of the flat
// clamp.  lane_select is the same kernel with row i for element i; it
// stays for the two-step path and for parity with the TPU kernel.
//
// The measured choice: B3's walk (element_gather.cuh), V = 4 and 128
// threads a block; at hop 3's 901,120 draws every walk of the sweep
// (walk_sweep.py, NVIDIA H100 80GB HBM3 at 700 W; PERF.md) took
// 0.0175-0.0185 ms.

#include "element_gather.cuh"

namespace {

using qtt::kPerThread;
using qtt::kThreads;
constexpr int kLanes = 128;

// row == nullptr: element i's row is i (rows [m, 128], r_max == m).
template <typename T>
__global__ void lane_select_kernel(const T* __restrict__ table, int64_t r_max,
                                   const int32_t* __restrict__ row,
                                   const int32_t* __restrict__ lane,
                                   T* __restrict__ out, int64_t m) {
  constexpr int V = kPerThread;
  const int64_t h = qtt::head_of<V>(lane, m);
  const bool vec_row = row != nullptr && qtt::aligned<V>(row + h);
  const bool vec_out = qtt::aligned<V>(out + h);
  auto offset = [r_max](int64_t r, int32_t l, bool* ok) {
    r = r < 0 ? 0 : (r >= r_max ? r_max - 1 : r);
    *ok = static_cast<uint32_t>(l) < static_cast<uint32_t>(kLanes);
    return r * kLanes + (*ok ? l : 0);
  };
  qtt::walk<V>(
      m, h,
      [&](int64_t i) {
        int32_t l[V], r[V];
        qtt::load_ids<V>(lane + i, true, l);
        if (row != nullptr) {
          qtt::load_ids<V>(row + i, vec_row, r);
        } else {
#pragma unroll
          for (int j = 0; j < V; ++j) r[j] = 0;
        }
        int64_t off[V];
        bool ok[V];
#pragma unroll
        for (int j = 0; j < V; ++j)
          off[j] = offset(row != nullptr ? r[j] : i + j, l[j], &ok[j]);
        T v[V];
        qtt::read_elements<T, V>(table, off, ok, v);
        qtt::store_vals<T, V>(out + i, vec_out, v);
      },
      [&](int64_t i) {
        int64_t off[1];
        bool ok[1];
        off[0] = offset(row != nullptr ? row[i] : i, lane[i], &ok[0]);
        T v[1];
        qtt::read_elements<T, 1>(table, off, ok, v);
        out[i] = v[0];
      });
}

template <typename T>
cudaError_t launch(const void* table, int64_t r_max, const void* row,
                   const void* lane, void* out, int64_t m,
                   cudaStream_t stream) {
  unsigned blocks = 0;
  cudaError_t e = qtt::grid_for<lane_select_kernel<T>>(
      (m + kPerThread - 1) / kPerThread, &blocks);
  if (e != cudaSuccess) return e;
  lane_select_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(table), r_max, static_cast<const int32_t*>(row),
      static_cast<const int32_t*>(lane), static_cast<T*>(out), m);
  return cudaGetLastError();
}

int run(const void* table, int64_t r_max, const void* row, const void* lane,
        void* out, int64_t m, int is_float, void* stream) {
  if (m <= 0) return static_cast<int>(cudaGetLastError());
  if (r_max <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      is_float ? launch<float>(table, r_max, row, lane, out, m, s)
               : launch<int32_t>(table, r_max, row, lane, out, m, s));
}

}  // namespace

// is_float: 1 for fp32 tables, 0 for int32 ones.
extern "C" int lane_select_rows(const void* table, int64_t rows,
                                const void* row, const void* lane, void* out,
                                int64_t m, int is_float, void* stream) {
  return run(table, rows, row, lane, out, m, is_float, stream);
}

extern "C" int lane_select(const void* rows, const void* lanes, void* out,
                           int64_t m, int is_float, void* stream) {
  return run(rows, m, nullptr, lanes, out, m, is_float, stream);
}
