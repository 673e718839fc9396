// Kernel B4: lane select, out[i] = rows[i, lanes[i]] over rows [M, 128] of
// 4-byte elements (int32 or fp32); a lane outside [0, 128) selects 0.
//
// Replaces quiver_tpu/ops/pallas/element_gather_kernel.py::lane_select,
// which streams blocks of 1,024 rows [1024, 128] through VMEM and reduces
// each to one lane with a one-hot sum.  It is the lane half of
// ops/fastgather.py::element_gather(fused=True), the sampler's
// gather_mode="lanes_fused"; the row gather before it is index_select in
// the caller, as JAX leaves it to jnp.take.
//
// What bounds it on the H100: the latency of one read per row.  Each row
// is 512 bytes, but the function needs one element of it, one 32-byte
// sector of device memory; the least time counts one sector per row plus
// lanes read and out written once.  The design: one thread per row reads
// the selected element alone and never streams the row through the SM
// (the TPU kernel moves all 128 lanes), over any M (the TPU kernel needs
// a multiple of 1,024).  The [M, 128] input itself is 128 times the
// payload; that is the "lanes_fused" design, and removing it means
// fusing the row gather in, which is B3's job.
//
// Float results follow the TPU kernel's lane sum, which adds zeros to the
// selected element: __fadd_rn(v, 0.0f) turns -0.0 into +0.0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;

template <typename T>
__device__ __forceinline__ T lane_sum_result(T v) { return v; }

template <>
__device__ __forceinline__ float lane_sum_result<float>(float v) {
  return __fadd_rn(v, 0.0f);
}

template <typename T>
__global__ void lane_select_kernel(const T* __restrict__ rows,
                                   const int32_t* __restrict__ lanes,
                                   T* __restrict__ out, int64_t m) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= m) return;
  const int32_t lane = lanes[i];
  T v = T(0);
  if (static_cast<uint32_t>(lane) < static_cast<uint32_t>(kLanes))
    v = __ldg(rows + i * kLanes + lane);
  out[i] = lane_sum_result<T>(v);
}

template <typename T>
cudaError_t launch(const void* rows, const void* lanes, void* out, int64_t m,
                   cudaStream_t stream) {
  const int threads = 256;
  const int64_t blocks = (m + threads - 1) / threads;
  lane_select_kernel<T><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      static_cast<const T*>(rows), static_cast<const int32_t*>(lanes),
      static_cast<T*>(out), m);
  return cudaGetLastError();
}

}  // namespace

// is_float: 1 for fp32 rows, 0 for int32 ones.
extern "C" int lane_select(const void* rows, const void* lanes, void* out,
                           int64_t m, int is_float, void* stream) {
  if (m <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(is_float ? launch<float>(rows, lanes, out, m, s)
                                   : launch<int32_t>(rows, lanes, out, m, s));
}
