// GraphSAGE's masked neighbour mean and its gradient, for SAGEConv:
//
//   mean[t, :] = (sum over valid slots j, in slot order, of x[nbr[t, j], :])
//                / max(count_t, 1)
//   grad_x[nbr[t, j], :] += grad_mean[t, :] / max(count_t, 1), valid j
//
// where slot j of target t is valid when mask[t, j] is set, count_t is the
// number of valid slots and nbr is clamped to x's rows.  x is fp32 or bf16;
// the sum runs in fp32 and, for bf16, is rounded to bf16 once before the
// division by the count (itself rounded to bf16), as PyTorch's bf16 sum and
// divide round.  Masked slots are skipped, not multiplied by zero, so a
// non-finite row behind a masked slot reaches neither the mean nor its
// gradient.
//
// Replaces no TPU kernel: the JAX package leaves the aggregation to XLA
// (quiver_tpu/models/layers.py: an index, a masked sum, a divide).  On the
// card the same five lines of PyTorch materialise the gathered [T, k, D]
// rows, multiply them by a broadcast mask, sum and divide, and autograd
// expands the gradient back and runs an atomic index_add into a zero-filled
// [N, D], beside a second zero-filled [N, D] for the self rows' slice.
//
// What bounds it on the H100: device memory.  It does a quarter of an
// operation a byte.  At ogbn-products' fused step (dedup="none": each row
// of x is one slot's, so every valid row is read once) the forward must
// read each valid slot's row once and write [T, D]: layer 0 (180,224
// targets, k = 5, 100 wide) about 0.39 GB, layer 1 (16,384, 10, 256) about
// 0.16 GB, layer 2 (1,024, 15, 256) 0.02 GB; 0.17 ms at 3.35 TB/s for the
// three.  The backward must write grad_x [N, D] once and read grad_mean and
// the self rows' gradient: about 0.22 GB for layer 1.
//
// What the design does about it:
//
// 1. A warp a target.  Its lanes load 32 slots' indices and mask bytes at
//    once (one coalesced load each), a ballot gives the valid slots, and a
//    shuffle hands each valid slot's row to every lane.
// 2. Bytes in flight.  A lane owns S units of the row (16-byte units where
//    the row and x's address allow: 25 units for 100 fp32, 64 for 256; 8,
//    4 or 2 bytes elsewhere, such as Reddit's 2,408-byte rows) and issues
//    the loads of up to FLIGHT valid slots before it adds any, so up to
//    FLIGHT * S * 16 bytes a lane are in flight.  Rows of more than 64
//    units take several passes over the slots.
// 3. Rows are read through the non-coherent path (ld.global.nc): x does
//    not change under the kernel.  The mean is written in the row's units,
//    coalesced.  No shared memory is used.
// 4. The backward scatters with vector reductions (red.global.add of
//    float4 and float2 on sm_90, bf16x2 pairs for bf16), one a unit and
//    valid slot, and skips masked slots, so the padding's zero gradients do
//    not contend on row 0.  The self rows' gradient is copied into
//    grad_x[:t] and the rest zeroed before the scatter, so one [N, D]
//    buffer is written where autograd wrote two and added them.  The adds
//    are atomic because a row may take several slots (dedup="hop"); where
//    each row takes one, the result is exact.
//
// Every size is a compile-time constant.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "sage.cuh"

namespace {

using namespace qtt::sage;

constexpr int THREADS = 256;  // 8 warps a block, a target a warp
constexpr int FLIGHT = 8;     // valid slots whose loads a lane issues at once

// Target t's slots j0 .. j0 + 31: the lane's slot's row (clamped to x's n
// rows; 0 where masked) and the ballot of the valid slots.
struct Slots {
  const int32_t* nbr;   // [T, k]
  const uint8_t* mask;  // [T, k] bool
  int64_t t;
  int k;
  int n;

  __device__ __forceinline__ unsigned chunk(int64_t tg, int j0, int lane,
                                            int& row) const {
    const int j = j0 + lane;
    bool valid = false;
    row = 0;
    if (j < k) {
      const int64_t i = tg * k + j;
      valid = mask[i] != 0;
      if (valid) {
        const int r = nbr[i];
        row = r < 0 ? 0 : (r >= n ? n - 1 : r);
      }
    }
    return __ballot_sync(FULL, valid);
  }
};

// x's rows are nv units of V (E elements of T each); a lane owns units
// base + lane + 32 s, s < S, of each row.
template <typename T, typename V, int S>
__global__ void __launch_bounds__(THREADS)
    sage_mean_fwd(const V* __restrict__ x, Slots slots, V* __restrict__ out,
                  int64_t nv) {
  constexpr int E = sizeof(V) / sizeof(T);
  const int64_t t = warp_target<THREADS>(slots.t);
  if (t < 0) return;  // the whole warp
  const int lane = threadIdx.x & 31;
  for (int64_t base = 0; base < nv; base += 32 * S) {
    const int64_t u0 = base + lane;  // this lane's first unit
    float acc[S][E];
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int e = 0; e < E; ++e) acc[s][e] = 0.0f;
    int count = 0;
    for (int j0 = 0; j0 < slots.k; j0 += 32) {
      int row;
      unsigned left = slots.chunk(t, j0, lane, row);
      count += __popc(left);
      while (left) {  // the same on every lane
        V buf[FLIGHT][S];
        int got = 0;
#pragma unroll
        for (int q = 0; q < FLIGHT; ++q) {
          if (left) {
            const int j = __ffs(static_cast<int>(left)) - 1;
            left &= left - 1;
            const int r = __shfl_sync(FULL, row, j);
            const V* src = x + static_cast<int64_t>(r) * nv + u0;
#pragma unroll
            for (int s = 0; s < S; ++s)
              if (u0 + 32 * s < nv) buf[q][s] = __ldg(src + 32 * s);
            got = q + 1;
          }
        }
        // in slot order
#pragma unroll
        for (int q = 0; q < FLIGHT; ++q) {
          if (q < got) {
#pragma unroll
            for (int s = 0; s < S; ++s) {
              if (u0 + 32 * s < nv) {
                const T* v = reinterpret_cast<const T*>(&buf[q][s]);
#pragma unroll
                for (int e = 0; e < E; ++e) acc[s][e] += to_float(v[e]);
              }
            }
          }
        }
      }
    }
    const float cnt = round_to<T>(static_cast<float>(count > 0 ? count : 1));
    V* dst = out + t * nv + u0;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (u0 + 32 * s < nv) {
        V u;
        T* o = reinterpret_cast<T*>(&u);
#pragma unroll
        for (int e = 0; e < E; ++e)
          o[e] = from_float<T>(__fdiv_rn(round_to<T>(acc[s][e]), cnt));
        dst[32 * s] = u;
      }
    }
  }
}

// *dst += v, element by element, as one vector reduction where sm_90 has
// one (float4, float2), bf16x2 pairs for bf16.
template <typename T, typename V>
__device__ __forceinline__ void red_add(V* dst, const V& v) {
  if constexpr (std::is_same<T, float>::value) {
    const float* f = reinterpret_cast<const float*>(&v);
    float* d = reinterpret_cast<float*>(dst);
    if constexpr (sizeof(V) == 16)
      atomicAdd(reinterpret_cast<float4*>(d),
                make_float4(f[0], f[1], f[2], f[3]));
    else if constexpr (sizeof(V) == 8)
      atomicAdd(reinterpret_cast<float2*>(d), make_float2(f[0], f[1]));
    else
      atomicAdd(d, f[0]);
  } else if constexpr (sizeof(V) == 2) {
    atomicAdd(reinterpret_cast<bf16*>(dst),
              *reinterpret_cast<const bf16*>(&v));
  } else {
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < static_cast<int>(sizeof(V) / 4); ++i)
      atomicAdd(reinterpret_cast<__nv_bfloat162*>(dst) + i, p[i]);
  }
}

template <typename T, typename V, int S>
__global__ void __launch_bounds__(THREADS)
    sage_mean_bwd(const V* __restrict__ grad, Slots slots, V* __restrict__ gx,
                  int64_t nv) {
  constexpr int E = sizeof(V) / sizeof(T);
  const int64_t t = warp_target<THREADS>(slots.t);
  if (t < 0) return;  // the whole warp
  const int lane = threadIdx.x & 31;
  int row0;
  const unsigned valid0 = slots.chunk(t, 0, lane, row0);
  int count = __popc(valid0);
  for (int j0 = 32; j0 < slots.k; j0 += 32) {
    int r;
    count += __popc(slots.chunk(t, j0, lane, r));
  }
  if (count == 0) return;  // the whole warp
  const float cnt = round_to<T>(static_cast<float>(count));
  for (int64_t base = 0; base < nv; base += 32 * S) {
    const int64_t u0 = base + lane;
    V g[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (u0 + 32 * s < nv) {
        const V u = __ldg(grad + t * nv + u0 + 32 * s);
        const T* in = reinterpret_cast<const T*>(&u);
        T* o = reinterpret_cast<T*>(&g[s]);
#pragma unroll
        for (int e = 0; e < E; ++e)
          o[e] = from_float<T>(__fdiv_rn(to_float(in[e]), cnt));
      }
    }
    for (int j0 = 0; j0 < slots.k; j0 += 32) {
      int row = row0;
      unsigned left = j0 == 0 ? valid0 : slots.chunk(t, j0, lane, row);
      while (left) {  // the same on every lane
        const int j = __ffs(static_cast<int>(left)) - 1;
        left &= left - 1;
        const int r = __shfl_sync(FULL, row, j);
        V* dst = gx + static_cast<int64_t>(r) * nv + u0;
#pragma unroll
        for (int s = 0; s < S; ++s)
          if (u0 + 32 * s < nv) red_add<T>(dst + 32 * s, g[s]);
      }
    }
  }
}

bool misaligned(const void* p, int unit) {
  return reinterpret_cast<uintptr_t>(p) % unit != 0;
}

// One kernel of the pair, by element type, unit and units a lane.
template <bool FWD>
int launch(const void* in, Slots slots, void* out, int64_t row_bytes,
           int unit, int bf, cudaStream_t s) {
  const int64_t nv = row_bytes / unit;
  const unsigned blocks = static_cast<unsigned>(cdiv(slots.t * 32, THREADS));
#define QTT_SM_GO(T, V, S)                                                 \
  do {                                                                     \
    if (FWD)                                                               \
      sage_mean_fwd<T, V, S><<<blocks, THREADS, 0, s>>>(                   \
          static_cast<const V*>(in), slots, static_cast<V*>(out), nv);     \
    else                                                                   \
      sage_mean_bwd<T, V, S><<<blocks, THREADS, 0, s>>>(                   \
          static_cast<const V*>(in), slots, static_cast<V*>(out), nv);     \
  } while (0)
#define QTT_SM_S(T, V) \
  do {                 \
    if (nv <= 32)      \
      QTT_SM_GO(T, V, 1); \
    else               \
      QTT_SM_GO(T, V, 2); \
  } while (0)
  if (bf) {
    switch (unit) {
      case 16: QTT_SM_S(bf16, uint4); break;
      case 8: QTT_SM_S(bf16, uint2); break;
      case 4: QTT_SM_S(bf16, uint32_t); break;
      default: QTT_SM_S(bf16, uint16_t); break;
    }
  } else {
    switch (unit) {
      case 16: QTT_SM_S(float, uint4); break;
      case 8: QTT_SM_S(float, uint2); break;
      default: QTT_SM_S(float, uint32_t); break;
    }
  }
#undef QTT_SM_S
#undef QTT_SM_GO
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out [t, row_bytes / element] = the masked mean of x's rows at nbr (int32
// [t, k], clamped to [0, n)) where mask ([t, k] bool); x [n, row_bytes /
// element] is fp32, or bf16 when bf.  unit (4, 8
// or 16, and 2 for bf16) divides row_bytes and x's and out's addresses.
extern "C" int sage_mean(const void* x, int64_t n, const void* nbr,
                         const void* mask, int64_t t, int k, void* out,
                         int64_t row_bytes, int unit, int bf, void* stream) {
  if (t <= 0 || row_bytes <= 0) return static_cast<int>(cudaGetLastError());
  if (bad_unit(unit, bf, row_bytes) || misaligned(x, unit) ||
      misaligned(out, unit) || k < 0 || n > INT32_MAX || (k > 0 && n <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const Slots slots{static_cast<const int32_t*>(nbr),
                    static_cast<const uint8_t*>(mask), t, k,
                    static_cast<int>(n)};
  return launch<true>(x, slots, out, row_bytes, unit, bf,
                      static_cast<cudaStream_t>(stream));
}

// grad_x [n, row_bytes / element] = the gradient of sage_mean's x from
// grad ([t, row_bytes / element], the mean's gradient) and grad_self ([t,
// ...], the gradient of x's first t rows, or null): grad_self copied into
// grad_x's first t rows and the rest zeroed, then grad / count added into
// each valid slot's row.  unit divides row_bytes and the three addresses.
extern "C" int sage_mean_backward(const void* grad, const void* grad_self,
                                  const void* nbr, const void* mask,
                                  int64_t t, int k,
                                  void* grad_x, int64_t n, int64_t row_bytes,
                                  int unit, int bf, void* stream) {
  if (n <= 0 || row_bytes <= 0) return static_cast<int>(cudaGetLastError());
  if (bad_unit(unit, bf, row_bytes) || misaligned(grad, unit) ||
      misaligned(grad_x, unit) ||
      (grad_self != nullptr && misaligned(grad_self, unit)) || k < 0 ||
      t < 0 || n > INT32_MAX || (grad_self != nullptr && t > n))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  char* gx = static_cast<char*>(grad_x);
  const int64_t self_bytes = grad_self != nullptr ? t * row_bytes : 0;
  cudaError_t err = cudaSuccess;
  if (self_bytes)
    err = cudaMemcpyAsync(gx, grad_self, self_bytes, cudaMemcpyDeviceToDevice,
                          s);
  if (err == cudaSuccess && n * row_bytes > self_bytes)
    err = cudaMemsetAsync(gx + self_bytes, 0, n * row_bytes - self_bytes, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (t == 0) return static_cast<int>(cudaGetLastError());
  const Slots slots{static_cast<const int32_t*>(nbr),
                    static_cast<const uint8_t*>(mask), t, k,
                    static_cast<int>(n)};
  return launch<false>(grad, slots, grad_x, row_bytes, unit, bf, s);
}
