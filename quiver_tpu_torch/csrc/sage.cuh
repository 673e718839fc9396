// The element helpers GraphSAGE's kernels share (sage_mean.cu, sage_act.cu,
// sage_act_mean.cu): conversions that round as PyTorch's ops round on the
// card, one load or store of a vector, the hidden layer's activation for
// one element, forward and backward, and the means' warp-a-target layout:
//
//   r    = relu(a + b)
//   y    = (r * keep) * scale
//   code = !(r <= 0) | (keep != 0) << 1          (one byte an element)
//   dx   = code & 1 ? (dy * scale) * (code >> 1) : +0
//
// sage_act.cu says why each op rounds as it does.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace qtt {
namespace sage {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v) {
  if constexpr (std::is_same<T, float>::value) return v;
  else return __float2bfloat16_rn(v);
}

// v rounded to T and back: what PyTorch holds after an op in T.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_float(from_float<T>(v));
}

// The unsigned type of BYTES bytes: one load or store.
template <int BYTES> struct Raw;
template <> struct Raw<16> { typedef uint4 type; };
template <> struct Raw<8> { typedef uint2 type; };
template <> struct Raw<4> { typedef uint32_t type; };
template <> struct Raw<2> { typedef uint16_t type; };
template <> struct Raw<1> { typedef uint8_t type; };

// E values of U at p, in one load through the non-coherent path.
template <typename U, int E>
__device__ __forceinline__ void load(const U* p, U (&out)[E]) {
  typedef typename Raw<E * sizeof(U)>::type R;
  const R r = __ldg(reinterpret_cast<const R*>(p));
  const U* v = reinterpret_cast<const U*>(&r);
#pragma unroll
  for (int e = 0; e < E; ++e) out[e] = v[e];
}

// E values of U to p, in one store.
template <typename U, int E>
__device__ __forceinline__ void store(U* p, const U (&in)[E]) {
  typedef typename Raw<E * sizeof(U)>::type R;
  R r;
  U* v = reinterpret_cast<U*>(&r);
#pragma unroll
  for (int e = 0; e < E; ++e) v[e] = in[e];
  *reinterpret_cast<R*>(p) = r;
}

// One element forward: y and its byte.
template <typename T>
__device__ __forceinline__ void act(T a, T b, T k, float scale, T& y,
                                    uint8_t& c) {
  const float s = round_to<T>(__fadd_rn(to_float(a), to_float(b)));
  const float r = isnan(s) ? s : fmaxf(s, 0.0f);  // clamp_min(s, 0)
  const float kf = to_float(k);
  const float m = round_to<T>(__fmul_rn(r, kf));
  y = from_float<T>(__fmul_rn(m, scale));
  c = static_cast<uint8_t>((r <= 0.0f ? 0 : 1) | (kf != 0.0f ? 2 : 0));
}

// One element backward.
template <typename T>
__device__ __forceinline__ T act_grad(T dy, uint8_t c, float scale) {
  const float g = round_to<T>(__fmul_rn(to_float(dy), scale));
  const float m = __fmul_rn(g, (c & 2) ? 1.0f : 0.0f);
  return from_float<T>((c & 1) ? m : 0.0f);
}

// The warp-a-target layout of sage_mean.cu and sage_act_mean.cu.

constexpr unsigned FULL = 0xffffffffu;

// The warp's target in blocks of THREADS threads, or -1 past the last.
template <int THREADS>
__device__ __forceinline__ int64_t warp_target(int64_t t) {
  const int64_t w =
      (static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x) >> 5;
  return w < t ? w : -1;
}

inline int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

// Whether unit bytes is no load unit for rows of row_bytes: 4, 8 or 16
// that divides the row, and 2 for bf16 too.
inline bool bad_unit(int unit, int bf, int64_t row_bytes) {
  return (unit != 2 && unit != 4 && unit != 8 && unit != 16) ||
         (!bf && unit == 2) || row_bytes % unit != 0;
}

}  // namespace sage
}  // namespace qtt
