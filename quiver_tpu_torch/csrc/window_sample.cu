// Kernel B1: one fused uniform sampling hop.
//
// Replaces quiver_tpu/ops/pallas/window_sample_kernel.py::pallas_window_sample
// (body _make_kernel).  For seed b with window [start, start + deg) of the
// CSR indices, slot j draws the counter-hash uniform at counter b*k + j,
// keyed by the folded words (k0, k1), maps it to the stratified position
// pos (quiver_tpu/ops/sample.py::_stratified_positions) and writes
//   nbrs[b, j] = indices[start + pos]   (-1 where masked)
//   mask[b, j] = j < min(deg, k)
//   eid[b, j]  = start + pos            (-1 where masked)
//   counts[b]  = min(deg, k)
// in the same launch.
//
// What bounds it on the H100: memory latency.  Per draw it does ~40
// integer and fp32 operations but makes two dependent loads (indptr, then
// indices at a data-dependent position), each a scattered 4-byte read; the
// bytes moved are small, so the card waits on load latency, not on
// bandwidth or arithmetic.  The design keeps enough independent loads in
// flight to hide it: one thread per (b, j), so a 2048-seed hop of fanout 25
// has 51,200 threads and neighbouring threads of one seed hit the same
// indptr line.  The TPU kernel's VMEM window copy, its U-row limit and the
// fallback for long rows (_fit_split) exist only because of TPU memory and
// have no counterpart: every read goes straight to global memory.
//
// Exactness: draws must equal the JAX package's bit for bit, so the fp32
// stratum bounds are a correctly rounded multiply and then a correctly
// rounded divide (__fmul_rn, __fdiv_rn: no contraction into an FMA, no
// approximate division); the build also passes -fmad=false -prec-div=true.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kHashPhi = 0x9E3779B9u;
constexpr uint32_t kHashMul1 = 0x85EBCA6Bu;
constexpr uint32_t kHashMul2 = 0xC2B2AE35u;

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x = (x ^ (x >> 16)) * kHashMul1;
  x = (x ^ (x >> 13)) * kHashMul2;
  return x ^ (x >> 16);
}

__device__ __forceinline__ int64_t clamp64(int64_t v, int64_t hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

__global__ void window_sample_kernel(
    const int32_t* __restrict__ indptr, int64_t indptr_len,
    const int32_t* __restrict__ indices, int64_t indices_len,
    const int32_t* __restrict__ seeds, const uint8_t* __restrict__ seed_mask,
    int64_t n_seeds, int k, uint32_t k0, uint32_t k1,
    int32_t* __restrict__ nbrs, uint8_t* __restrict__ mask,
    int32_t* __restrict__ counts, int32_t* __restrict__ eid) {
  const int64_t t = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (t >= n_seeds * k) return;
  const int64_t b = t / k;
  const int j = static_cast<int>(t - b * k);

  // window of the seed; reads clip to the padded table like the JAX gathers
  const int64_t s = seeds[b];
  const int32_t start = indptr[clamp64(s, indptr_len - 1)];
  int32_t deg = indptr[clamp64(s + 1, indptr_len - 1)] - start;
  if (seed_mask != nullptr && !seed_mask[b]) deg = 0;
  const int32_t cnt = deg < k ? deg : k;
  if (j == 0) counts[b] = cnt;

  // counter-hash uniform (quiver_tpu/ops/sample.py::_hash_uniform)
  uint32_t x = (static_cast<uint32_t>(b) * static_cast<uint32_t>(k) +
                static_cast<uint32_t>(j)) * kHashPhi;
  x = fmix32(x ^ k0);
  x = fmix32(x ^ k1);
  const float u = __fmul_rn(__uint2float_rn(x >> 8), 1.0f / 16777216.0f);

  // stratified position, op for op
  const float degf = __int2float_rn(deg);
  const float kf = __int2float_rn(k);
  const float lo = floorf(__fdiv_rn(__fmul_rn(__int2float_rn(j), degf), kf));
  const float hi =
      floorf(__fdiv_rn(__fmul_rn(__int2float_rn(j + 1), degf), kf));
  const float strat =
      __fadd_rn(lo, floorf(__fmul_rn(u, fmaxf(__fsub_rn(hi, lo), 1.0f))));
  int32_t pos = deg <= k ? j : static_cast<int32_t>(strat);
  const int32_t last = deg - 1 > 0 ? deg - 1 : 0;
  pos = pos < last ? pos : last;

  const bool m = j < cnt;
  const int32_t idx = start + pos;
  const int64_t o = b * k + j;
  nbrs[o] = m ? indices[clamp64(idx, indices_len - 1)] : -1;
  eid[o] = m ? idx : -1;
  mask[o] = m ? 1 : 0;
}

}  // namespace

extern "C" int window_sample(const void* indptr, int64_t indptr_len,
                             const void* indices, int64_t indices_len,
                             const void* seeds, const void* seed_mask,
                             int64_t n_seeds, int k, uint32_t k0, uint32_t k1,
                             void* nbrs, void* mask, void* counts, void* eid,
                             void* stream) {
  const int64_t total = n_seeds * k;
  if (total > 0) {
    const int threads = 256;
    const int64_t blocks = (total + threads - 1) / threads;
    window_sample_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(indptr), indptr_len,
        static_cast<const int32_t*>(indices), indices_len,
        static_cast<const int32_t*>(seeds),
        static_cast<const uint8_t*>(seed_mask), n_seeds, k, k0, k1,
        static_cast<int32_t*>(nbrs), static_cast<uint8_t*>(mask),
        static_cast<int32_t*>(counts), static_cast<int32_t*>(eid));
  }
  return static_cast<int>(cudaGetLastError());
}
