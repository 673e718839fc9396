// Kernel B5: the paged store's ragged page gather, with the rank take
// behind it, in one pass:
//
//   r = rank[i];  b = r / block
//   out[i, :] = frames[blk_pages[b * ppb + row_lp[r]], row_off[r], :]
//
// for every i < n_out.  Each output row is written once, in the caller's
// order; pad rows of the plan are never read.
//
// Replaces quiver_tpu/ops/pallas/page_gather_kernel.py::page_gather and
// the jnp.take(out, rank) that quiver_tpu/feature.py::_paged_fn runs
// after it.  The TPU kernel copies every distinct page of a block into
// VMEM (four page DMAs in flight) and then selects rows from VMEM: on the
// TPU a page-sized copy is the cheap transaction.  That does not carry to
// this card.  At Reddit width a page is 64 rows of 2,408 bytes
// (154,112 bytes), barely one page per block in the 227 KB of shared
// memory, and a row uses 1/64 of its page, so staging pages would read up
// to 64 times the bytes needed.
//
// What bounds it on the H100: memory bandwidth, as kernel B2.  It reads
// each gathered row once and writes it once, so the least time is
// (distinct rows read + rows written + plan entries read) / 3.35 TB/s.
// The design is B2's: one warp per output row, its 32 lanes copying
// consecutive vector units so each warp-wide load and store is
// contiguous; the four plan loads of a row are the same address for all
// lanes.  The wrapper picks the widest unit of 16, 8, 4, 2 or 1 bytes
// dividing the row size and both base addresses (8 bytes for a 602-wide
// fp32 row, 4 for bf16).  Offsets are 64-bit: F * R * D * itemsize passes
// 2^31 bytes on real tables.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename V>
__global__ void page_gather_kernel(const V* __restrict__ frames,
                                   const int32_t* __restrict__ blk_pages,
                                   const int32_t* __restrict__ row_lp,
                                   const int32_t* __restrict__ row_off,
                                   const int32_t* __restrict__ rank,
                                   V* __restrict__ out, int64_t n_out,
                                   int64_t page_rows, int64_t units,
                                   int64_t block, int64_t ppb) {
  const int64_t row =
      (blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x) >> 5;
  if (row >= n_out) return;
  const int lane = threadIdx.x & 31;
  const int64_t r = rank[row];
  const int64_t frame = blk_pages[(r / block) * ppb + row_lp[r]];
  const V* src = frames + (frame * page_rows + row_off[r]) * units;
  V* dst = out + row * units;
  for (int64_t u = lane; u < units; u += 32) dst[u] = src[u];
}

template <typename V>
cudaError_t launch(const void* frames, const int32_t* blk_pages,
                   const int32_t* row_lp, const int32_t* row_off,
                   const int32_t* rank, void* out, int64_t n_out,
                   int64_t page_rows, int64_t row_bytes, int64_t block,
                   int64_t ppb, cudaStream_t stream) {
  const int threads = 256;  // 8 rows per block
  const int64_t blocks = (n_out * 32 + threads - 1) / threads;
  page_gather_kernel<V><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      static_cast<const V*>(frames), blk_pages, row_lp, row_off, rank,
      static_cast<V*>(out), n_out, page_rows,
      row_bytes / static_cast<int64_t>(sizeof(V)), block, ppb);
  return cudaGetLastError();
}

}  // namespace

extern "C" int page_gather(const void* frames, const void* blk_pages,
                           const void* row_lp, const void* row_off,
                           const void* rank, void* out, int64_t n_out,
                           int64_t page_rows, int64_t row_bytes,
                           int64_t block, int64_t ppb, int vec_bytes,
                           void* stream) {
  if (n_out <= 0 || row_bytes <= 0) return static_cast<int>(cudaGetLastError());
  if (block <= 0 || ppb <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* bp = static_cast<const int32_t*>(blk_pages);
  const int32_t* lp = static_cast<const int32_t*>(row_lp);
  const int32_t* off = static_cast<const int32_t*>(row_off);
  const int32_t* rk = static_cast<const int32_t*>(rank);
  switch (vec_bytes) {
    case 16: return static_cast<int>(launch<uint4>(frames, bp, lp, off, rk, out, n_out, page_rows, row_bytes, block, ppb, s));
    case 8: return static_cast<int>(launch<uint2>(frames, bp, lp, off, rk, out, n_out, page_rows, row_bytes, block, ppb, s));
    case 4: return static_cast<int>(launch<uint32_t>(frames, bp, lp, off, rk, out, n_out, page_rows, row_bytes, block, ppb, s));
    case 2: return static_cast<int>(launch<uint16_t>(frames, bp, lp, off, rk, out, n_out, page_rows, row_bytes, block, ppb, s));
    case 1: return static_cast<int>(launch<uint8_t>(frames, bp, lp, off, rk, out, n_out, page_rows, row_bytes, block, ppb, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
