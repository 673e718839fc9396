// Kernel B1: one fused uniform sampling hop.
//
// Replaces quiver_tpu/ops/pallas/window_sample_kernel.py::pallas_window_sample
// (body _make_kernel).  For seed b with window [start, start + deg) of the
// CSR indices, draw t = b*k + j takes a uniform at counter t, maps it to
// the stratified position pos (quiver_tpu/ops/sample.py::
// _stratified_positions) and reads indices[start + pos].  The uniform
// source is a template argument, picked at launch by `rng`:
//   0, the hash instance: the counter hash keyed by the folded words
//      (k0, k1), JAX's sample_rng="hash" draw (its Pallas kernel's);
//   1, the threefry instance: threefry.cuh's cipher keyed by the hop
//      key's raw words (k0, k1), element t of JAX's
//      jax.random.uniform(key, (B, k)), so a uniform "blocked[:U]" hop
//      under sample_rng="key" is this one launch and draws what JAX's
//      keyed "xla" hop draws (JAX itself runs XLA's threefry and a
//      gather there: its Pallas kernel fuses the hash only).
// A template, not a runtime branch, so the hash instance carries none of
// the cipher's code: its registers and occupancy are its own.
// One launch writes any of these outputs (a null pointer is not
// written):
//   literal entry (window_sample):
//     nbrs[t]   = indices[start + pos]   (-1 where masked)
//     mask[t]   = j < min(deg, k)
//     eid[t]    = start + pos            (-1 where masked)
//     counts[b] = min(deg, k)            (0 for a masked seed)
//   pipeline entry (window_sample_frontier), over frontier[:t0]:
//     frontier[t0 + t] = indices[start + pos]   (0 where masked)
//     fmask[t0 + t]    = the mask
//     nbr_local[t]     = t0 + t                 (0 where masked)
//     eid[t], counts[b] as above
// so the multi-hop pipeline's frontier tail, its mask tail and the block's
// local ids need no other kernel (quiver_tpu_torch/sampler.py).
//
// What bounds it on the H100: scattered reads.  Each draw reads indices at
// a data-dependent position (one sector of a table far larger than the
// 50 MB L2, fetched 64 bytes at a time) behind a chain of two dependent
// loads (the seed id, then its two indptr words).  The design:
// - Draws are packed densely, 32 consecutive draws a warp, so stores are
//   coalesced and no lane idles whatever k is.  The seeds a warp's draws
//   belong to (at most 32) are read once each, by one lane apiece: the
//   seed id, its mask byte and its indptr pair, both words issued before
//   either is used, as B3's pair entry does.  Each lane then takes its
//   seed's start and degree from that lane by __shfl_sync.
// - Index math is 32-bit: the wrapper refuses B*k >= 2**31, and t / k is a
//   multiply-high by a magic number made on the host (ops/cuda/
//   window_sample.py::div_magic), not a runtime 64-bit divide.
// - One wave of resident blocks walks the draws by grid stride; the
//   occupancy is looked up once per device (element_gather.cuh).
// Measured on the H100 (chip_smoke.py; PERF.md): a hop takes the time of
// B3's two launches over the same reads, and a 32-byte L2 fetch limit does
// not move it, so the reads bound it, not the per-draw work.  Where the
// design saves time is the pipeline entry: a hop of the pipeline is one
// launch and no other device operation.
// The threefry instance adds 75 integer operations a draw (threefry.cuh)
// to the same reads.  The warp's 32 draws are ciphered at one place, at
// the top of the step, by all 32 lanes converged and before the window
// read, which does not depend on them: the cipher's integer issue
// overlaps the latency of the seed-then-indptr load chain.  Measured on
// the H100 (PERF.md): the threefry instance takes the hash instance's
// time, with the same 36 registers.
// The TPU kernel's VMEM window copy, its U-row limit and the fallback for
// long rows (_fit_split) exist only because of TPU memory and have no
// counterpart: every read goes straight to global memory.
//
// Exactness: draws must equal the JAX package's bit for bit, so the fp32
// stratum bounds are a correctly rounded multiply and then a correctly
// rounded divide (__fmul_rn, __fdiv_rn: no contraction into an FMA, no
// approximate division); the build also passes -fmad=false -prec-div=true.
// Reads clamp into the padded tables as the JAX gathers clip.

#include <cuda_runtime.h>
#include <stdint.h>

#include "element_gather.cuh"
#include "threefry.cuh"

namespace {

constexpr int kBlock = 256;
constexpr unsigned kFullWarp = 0xFFFFFFFFu;
constexpr uint32_t kHashPhi = 0x9E3779B9u;
constexpr uint32_t kHashMul1 = 0x85EBCA6Bu;
constexpr uint32_t kHashMul2 = 0xC2B2AE35u;

// Output pointers; a null one is not written.  frontier and fmask point
// at the hop's tail (element t0 of the pipeline's buffers).
struct Outputs {
  int32_t* nbrs;
  uint8_t* mask;
  int32_t* eid;
  int32_t* counts;
  int32_t* frontier;
  uint8_t* fmask;
  int32_t* nbr_local;
  int32_t t0;
};

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x = (x ^ (x >> 16)) * kHashMul1;
  x = (x ^ (x >> 13)) * kHashMul2;
  return x ^ (x >> 16);
}

__device__ __forceinline__ int64_t clamp64(int64_t v, int64_t hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

// counter-hash uniform (quiver_tpu/ops/sample.py::_hash_uniform)
__device__ __forceinline__ float hash_uniform(uint32_t t, uint32_t k0,
                                              uint32_t k1) {
  uint32_t x = t * kHashPhi;
  x = fmix32(x ^ k0);
  x = fmix32(x ^ k1);
  return __fmul_rn(__uint2float_rn(x >> 8), 1.0f / 16777216.0f);
}

// n / k for n < 2**31 (Granlund-Montgomery, round-up variant)
__device__ __forceinline__ uint32_t div_k(uint32_t n, uint32_t mul,
                                          uint32_t shift) {
  return (__umulhi(n, mul) + n) >> shift;
}

template <bool kThreefry>
__global__ void __launch_bounds__(kBlock) window_sample_kernel(
    const int32_t* __restrict__ indptr, int64_t indptr_len,
    const int32_t* __restrict__ indices, int64_t indices_len,
    const int32_t* seeds, const uint8_t* seed_mask, uint32_t total, int k,
    uint32_t k_mul, uint32_t k_shift, uint32_t k0, uint32_t k1,
    Outputs out) {
  const uint32_t lane = threadIdx.x & 31u;
  const uint32_t stride = gridDim.x * static_cast<uint32_t>(kBlock);
  // every lane of a warp runs the same steps, so the shuffles see all 32
  for (uint32_t base = (blockIdx.x * kBlock + threadIdx.x) & ~31u;
       base < total; base += stride) {
    const uint32_t t = base + lane;
    // the threefry instance ciphers the warp's 32 draws here, converged
    float u_key = 0.0f;
    if constexpr (kThreefry) u_key = qtt::threefry_uniform_at(k0, k1, t);
    const uint32_t b = div_k(t, k_mul, k_shift);
    const int32_t j = static_cast<int32_t>(t - b * static_cast<uint32_t>(k));
    const uint32_t b0 = div_k(base, k_mul, k_shift);
    const uint32_t b_last =
        div_k(min(base + 31u, total - 1u), k_mul, k_shift);

    // lane L reads the window of seed b0 + L once
    int32_t w_start = 0, w_deg = 0;
    if (b0 + lane <= b_last) {
      const uint32_t sb = b0 + lane;
      const int64_t s = seeds[sb];
      const bool live = seed_mask == nullptr || seed_mask[sb] != 0;
      const int32_t lo = __ldg(indptr + clamp64(s, indptr_len - 1));
      const int32_t hi = __ldg(indptr + clamp64(s + 1, indptr_len - 1));
      w_start = lo;
      w_deg = live ? hi - lo : 0;
    }
    const uint32_t src = (b - b0) & 31u;
    const int32_t start = __shfl_sync(kFullWarp, w_start, src);
    const int32_t deg = __shfl_sync(kFullWarp, w_deg, src);
    if (t >= total) continue;

    const int32_t cnt = deg < k ? deg : k;
    if (j == 0 && out.counts != nullptr) out.counts[b] = cnt;

    const float u = kThreefry ? u_key : hash_uniform(t, k0, k1);

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
    const int32_t nbr = m ? __ldg(indices + clamp64(idx, indices_len - 1)) : 0;
    if (out.nbrs != nullptr) out.nbrs[t] = m ? nbr : -1;
    if (out.mask != nullptr) out.mask[t] = m ? 1 : 0;
    if (out.eid != nullptr) out.eid[t] = m ? idx : -1;
    if (out.frontier != nullptr) out.frontier[t] = nbr;
    if (out.fmask != nullptr) out.fmask[t] = m ? 1 : 0;
    if (out.nbr_local != nullptr)
      out.nbr_local[t] = m ? out.t0 + static_cast<int32_t>(t) : 0;
  }
}

template <bool kThreefry>
cudaError_t launch_as(const int32_t* indptr, int64_t indptr_len,
                      const int32_t* indices, int64_t indices_len,
                      const int32_t* seeds, const uint8_t* seed_mask,
                      uint32_t total, int k, uint32_t k_mul, uint32_t k_shift,
                      uint32_t k0, uint32_t k1, const Outputs& out,
                      cudaStream_t s) {
  unsigned blocks = 0;
  cudaError_t e =
      qtt::grid_for<window_sample_kernel<kThreefry>, kBlock>(total, &blocks);
  if (e != cudaSuccess) return e;
  window_sample_kernel<kThreefry><<<blocks, kBlock, 0, s>>>(
      indptr, indptr_len, indices, indices_len, seeds, seed_mask, total, k,
      k_mul, k_shift, k0, k1, out);
  return cudaGetLastError();
}

}  // namespace

// (k_mul, k_shift) divide by k (div_magic); rng 0 draws the counter hash of
// the folded words (k0, k1), rng 1 threefry of the raw key words; frontier
// and fmask point at the hop's tail; t0 is the frontier length before the
// hop.
extern "C" int window_sample(const void* indptr, int64_t indptr_len,
                             const void* indices, int64_t indices_len,
                             const void* seeds, const void* seed_mask,
                             int64_t n_seeds, int k, uint32_t k_mul,
                             uint32_t k_shift, uint32_t k0, uint32_t k1,
                             int rng, void* nbrs, void* mask, void* counts,
                             void* eid, void* frontier, void* fmask,
                             void* nbr_local, int32_t t0, void* stream) {
  const int64_t total = n_seeds * k;
  if (rng != 0 && rng != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (total <= 0) return static_cast<int>(cudaGetLastError());
  if (k < 1 || total > INT32_MAX || t0 < 0 || total > INT32_MAX - t0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Outputs out{static_cast<int32_t*>(nbrs),
                    static_cast<uint8_t*>(mask),
                    static_cast<int32_t*>(eid),
                    static_cast<int32_t*>(counts),
                    static_cast<int32_t*>(frontier),
                    static_cast<uint8_t*>(fmask),
                    static_cast<int32_t*>(nbr_local),
                    t0};
  auto* const launch = rng == 1 ? &launch_as<true> : &launch_as<false>;
  return static_cast<int>(launch(
      static_cast<const int32_t*>(indptr), indptr_len,
      static_cast<const int32_t*>(indices), indices_len,
      static_cast<const int32_t*>(seeds),
      static_cast<const uint8_t*>(seed_mask), static_cast<uint32_t>(total),
      k, k_mul, k_shift, k0, k1, out, static_cast<cudaStream_t>(stream)));
}
