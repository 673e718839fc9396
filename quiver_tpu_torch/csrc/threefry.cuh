// The threefry-2x32 uniform of one counter: element i of JAX's
// jax.random.uniform(key, shape, float32) for the key's raw words
// (k0, k1), bit for bit as JAX 0.9 makes it with jax_threefry_partitionable
// on (its default):
//   (x0, x1) = (i >> 32, i & 0xFFFFFFFF)       iota_2x32_shape
//   (y0, y1) = threefry2x32(k0, k1, x0, x1)    20 rounds, 5 injections
//   bits     = y0 ^ y1                         32-bit random bits
//   u        = float((bits >> 9) | 0x3F800000) - 1.0f
// Everything is integer arithmetic but the last subtraction, which is
// exact (the float lies in [1, 2)); it is written __fsub_rn so that no
// contraction or fast-math flag can touch it.
//
// The one device cipher of the port, as utils/rng.py::threefry_rounds is
// the host's: threefry_uniform.cu writes it for every element of a shape,
// window_sample.cu (kernel B1's keyed instance) draws it in registers at
// each draw's counter.  Each call costs 75 integer operations: 2
// injections of the counter, 20 rounds of an add, a funnel-shift rotate
// and an xor, 5 key injections of two adds each (the key word plus its
// round number folds into a per-thread constant once inlined), then the
// xor, shift and or of the mantissa.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace qtt {

__device__ __forceinline__ uint32_t threefry_rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

#define QTT_THREEFRY_ROUND(r) \
  x0 += x1;                   \
  x1 = threefry_rotl(x1, r) ^ x0;

// jax.random.uniform's element at counter i under the raw key (k0, k1).
// Inlined at a 32-bit counter, the high word is the constant 0.
__device__ __forceinline__ float threefry_uniform_at(uint32_t k0, uint32_t k1,
                                                     uint64_t i) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = static_cast<uint32_t>(i >> 32) + k0;
  uint32_t x1 = static_cast<uint32_t>(i) + k1;
  QTT_THREEFRY_ROUND(13) QTT_THREEFRY_ROUND(15)
  QTT_THREEFRY_ROUND(26) QTT_THREEFRY_ROUND(6)
  x0 += k1; x1 += k2 + 1u;
  QTT_THREEFRY_ROUND(17) QTT_THREEFRY_ROUND(29)
  QTT_THREEFRY_ROUND(16) QTT_THREEFRY_ROUND(24)
  x0 += k2; x1 += k0 + 2u;
  QTT_THREEFRY_ROUND(13) QTT_THREEFRY_ROUND(15)
  QTT_THREEFRY_ROUND(26) QTT_THREEFRY_ROUND(6)
  x0 += k0; x1 += k1 + 3u;
  QTT_THREEFRY_ROUND(17) QTT_THREEFRY_ROUND(29)
  QTT_THREEFRY_ROUND(16) QTT_THREEFRY_ROUND(24)
  x0 += k1; x1 += k2 + 4u;
  QTT_THREEFRY_ROUND(13) QTT_THREEFRY_ROUND(15)
  QTT_THREEFRY_ROUND(26) QTT_THREEFRY_ROUND(6)
  x0 += k2; x1 += k0 + 5u;
  const uint32_t bits = ((x0 ^ x1) >> 9) | 0x3F800000u;
  return __fsub_rn(__uint_as_float(bits), 1.0f);
}

#undef QTT_THREEFRY_ROUND

}  // namespace qtt
