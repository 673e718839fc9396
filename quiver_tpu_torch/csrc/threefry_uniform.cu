// Threefry uniforms: out[i] = jax.random.uniform(key, shape)[i], fp32,
// for the row-major flat index i < n of any shape.
//
// Replaces no TPU kernel.  The JAX package computes these uniforms in
// XLA (quiver_tpu/ops/sample.py::_uniform, jax.random.uniform) at every
// draw site of a sampling hop under sample_rng="key".  The port gives
// them one launch: in plain torch a hop would run some 150 elementwise
// launches, since torch emulates uint32 in int64 (an add, a mask, two
// shifts, an or and an xor for each of the 20 rounds).  A uniform
// "blocked[:U]" hop does not come here: kernel B1's keyed instance
// (window_sample.cu) draws the same cipher in registers.  This kernel
// serves the other keyed draw sites: the "pallas", "xla" and "lanes*"
// hops, the weighted hop and the overlay hop.
//
// What it computes, bit for bit as JAX 0.9 does with
// jax_threefry_partitionable on (its default), is the cipher of
// threefry.cuh (qtt::threefry_uniform_at) at every flat index i < n.
//
// What bounds it on the H100: integer issue, not memory.  Each element
// takes 75 integer operations (2 injections of the counter, 20 rounds of
// an add, a funnel-shift rotate and an xor, 5 key injections of two adds
// each, since the key word plus its round number is a per-thread
// constant, then the xor, shift and or of the mantissa) and writes 4
// bytes: 75 operations against 4 bytes, far above the card's ratio of
// int32 issue (64 lanes an SM, 16.75e12 operations/s) to memory
// (3.35e12 B/s).  The design: one element a thread in a grid-stride
// loop of 256-thread blocks; the key schedule is per-thread constants;
// rotations are single funnel shifts; the store is coalesced.  No
// shared memory, no synchronisation.

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

__global__ void threefry_uniform_kernel(uint32_t k0, uint32_t k1,
                                        float* __restrict__ out, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < n; i += stride)
    out[i] = qtt::threefry_uniform_at(k0, k1, static_cast<uint64_t>(i));
}

}  // namespace

extern "C" {

// Uniforms at out[0 .. n) under the key (k0, k1), on `stream`; returns
// cudaGetLastError() after the launch.  n > 0.
int threefry_uniform(uint32_t k0, uint32_t k1, void* out, int64_t n,
                     void* stream) {
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  // a grid-stride loop covers any n; 2^20 blocks keep every SM busy
  if (blocks > (int64_t{1} << 20)) blocks = int64_t{1} << 20;
  threefry_uniform_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      k0, k1, static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
