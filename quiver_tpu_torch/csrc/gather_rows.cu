// Kernel B2: feature-row gather, out[i, :] = table[idx[i], :].
//
// Replaces quiver_tpu/ops/pallas/gather_kernel.py::gather_rows, which keeps
// four row DMAs in flight per grid program over blocks of 256 rows.
//
// What bounds it on the H100: memory bandwidth.  It does no arithmetic;
// it reads each gathered row once and writes it once, so the least time is
// (rows read + rows written + indices) / 3.35 TB/s.  The design: one warp
// per output row, its 32 lanes copying consecutive vector units of the row
// so each warp-wide load and store is contiguous.  Blocks of 8 warps give
// the card tens of thousands of independent rows in flight, which is how
// the scattered row starts are hidden.  Any row count works (the TPU
// kernel needed a multiple of 256), and row offsets are 64-bit.
//
// Vector width: the wrapper picks the widest of 16, 8, 4, 2 or 1 bytes
// that divides the row's byte size and both base addresses.  A 602-wide
// fp32 row is 2,408 bytes, not a multiple of 16, so it moves as 301
// 8-byte units; no lane ever reads past its row.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename V>
__global__ void gather_rows_kernel(const V* __restrict__ table,
                                   const int32_t* __restrict__ idx,
                                   V* __restrict__ out, int64_t n_rows,
                                   int64_t units) {
  const int64_t row =
      (blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x) >> 5;
  if (row >= n_rows) return;
  const int lane = threadIdx.x & 31;
  const V* src = table + static_cast<int64_t>(idx[row]) * units;
  V* dst = out + row * units;
  for (int64_t u = lane; u < units; u += 32) dst[u] = src[u];
}

template <typename V>
cudaError_t launch(const void* table, const void* idx, void* out,
                   int64_t n_rows, int64_t row_bytes, cudaStream_t stream) {
  const int threads = 256;  // 8 rows per block
  const int64_t blocks = (n_rows * 32 + threads - 1) / threads;
  gather_rows_kernel<V><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      static_cast<const V*>(table), static_cast<const int32_t*>(idx),
      static_cast<V*>(out), n_rows, row_bytes / static_cast<int64_t>(sizeof(V)));
  return cudaGetLastError();
}

}  // namespace

extern "C" int gather_rows(const void* table, const void* idx, void* out,
                           int64_t n_rows, int64_t row_bytes, int vec_bytes,
                           void* stream) {
  if (n_rows <= 0 || row_bytes <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vec_bytes) {
    case 16: return static_cast<int>(launch<uint4>(table, idx, out, n_rows, row_bytes, s));
    case 8: return static_cast<int>(launch<uint2>(table, idx, out, n_rows, row_bytes, s));
    case 4: return static_cast<int>(launch<uint32_t>(table, idx, out, n_rows, row_bytes, s));
    case 2: return static_cast<int>(launch<uint16_t>(table, idx, out, n_rows, row_bytes, s));
    case 1: return static_cast<int>(launch<uint8_t>(table, idx, out, n_rows, row_bytes, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
