// Kernel B3: element gather, out[i] = flat[clamp(idx[i], 0, n - 1)] over a
// flat table of n 4-byte elements (int32 or fp32).
//
// Replaces quiver_tpu/ops/pallas/sample_gather_kernel.py::
// pallas_element_gather, which DMAs the whole 512-byte, 128-lane row that
// covers each element into VMEM (128 copies in flight per group, double
// buffered) and selects the lane with a one-hot sum, because the TPU's
// scalar loads serialize.  It is the sampler's indptr and indices read
// under gather_mode="pallas".
//
// What bounds it on the H100: the latency of random reads.  The elements
// are scattered over a table far larger than the 50 MB L2 (ogbn-products'
// indices are 495 MB), so each read costs one 32-byte sector from device
// memory; the least time counts one sector per element plus idx read and
// out written once.  The design: one thread per element reads that
// element alone -- no 512-byte row moves, and only the payload is written.
// Blocks of 256 threads over any element count (no padding to the TPU
// kernel's 1,024-element block) keep hundreds of thousands of independent
// loads in flight, which is how the latency is hidden.  Offsets are 64-bit.
//
// Float results follow the TPU kernel's lane sum, which adds zeros to the
// selected element: __fadd_rn(v, 0.0f) turns -0.0 into +0.0 as that sum
// does and leaves every other value as it is (the intrinsic is never
// folded or contracted).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__device__ __forceinline__ T lane_sum_result(T v) { return v; }

template <>
__device__ __forceinline__ float lane_sum_result<float>(float v) {
  return __fadd_rn(v, 0.0f);
}

template <typename T>
__global__ void element_gather_kernel(const T* __restrict__ table, int64_t n,
                                      const int32_t* __restrict__ idx,
                                      T* __restrict__ out, int64_t m) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= m) return;
  int64_t j = idx[i];
  j = j < 0 ? 0 : (j >= n ? n - 1 : j);
  out[i] = lane_sum_result<T>(__ldg(table + j));
}

template <typename T>
cudaError_t launch(const void* table, int64_t n, const void* idx, void* out,
                   int64_t m, cudaStream_t stream) {
  const int threads = 256;
  const int64_t blocks = (m + threads - 1) / threads;
  element_gather_kernel<T><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      static_cast<const T*>(table), n, static_cast<const int32_t*>(idx),
      static_cast<T*>(out), m);
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
  return static_cast<int>(is_float ? launch<float>(table, n, idx, out, m, s)
                                   : launch<int32_t>(table, n, idx, out, m, s));
}
