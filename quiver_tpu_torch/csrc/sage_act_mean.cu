// A hidden GraphSAGE layer's activation in training fused with the next
// layer's neighbour mean, over a positional block, and its gradient:
//
//   y[r]      = relu(a[r] + b[r]) * keep[r] * scale       (never written)
//   code[r]   = sage.cuh's byte of ReLU's gate and the keep bit
//   x_self[t] = y[t]
//   mean[t]   = (sum over valid slots j, in slot order, of y[T + t k + j])
//               / max(count_t, 1)
//
// for the rows r < N = T (1 + k) of the addends a, b and the keep mask
// ([N, D]) and the next layer's block ([T, k] mask).  In a positional
// block (the no-dedup pipelines') slot j of target t names row T + t k + j
// and no other slot names it, so each row of y is read once, by its own
// target: either as target t's self row (r = t < T) or as one of its
// slots.  The forward therefore takes the mean straight from the addends,
// and the backward writes each row's gradient once:
//
//   dy[r] = grad_self[t]                     r = t < T
//         = +0 + grad_mean[t] / count_t      r a valid slot's row of t
//         = +0                               r a masked slot's row
//   dx[r] = sage.cuh's act_grad(dy[r], code[r])   for both a and b
//
// This is the chain it replaces, bit for bit: sage_act.cu's forward (y and
// the code), sage_mean.cu's forward over y (the valid slots added in slot
// order in fp32, rounded once to T, divided by the count rounded to T) and
// the self rows y[:T]; in the backward sage_mean.cu's (grad_self copied
// into the first T rows, the rest zeroed, grad_mean / count_t rounded to T
// and added atomically into each valid slot's row, here once onto +0, so
// -0 becomes +0, and an fp32 add of atom.add.f32, which flushes a
// subnormal addend to zero) then sage_act.cu's.  For bf16 the quotient is
// rounded to bf16 and added by atom.add.noftz.bf16x2, which keeps
// subnormals.  y and its gradient dy, [N, D] each, are never written.
//
// Replaces no TPU kernel: the JAX package leaves the activation and the
// aggregation to XLA (quiver_tpu/models/sage.py, layers.py).  It replaces
// the port's sage_act and sage_mean kernels where a block is positional.
//
// What bounds it on the H100: device memory.  At ogbn-products' layer 0
// to 1 (T = 16,384, k = 10, so N = 180,224 rows of 256 fp32) the forward
// reads a, b and keep (553.6 MB) and writes the code (46.1 MB), x_self and
// mean (16.8 MB each): 633 MB, 0.189 ms at 3.35 TB/s, where sage_act_fwd
// wrote y (184.5 MB) and sage_mean_fwd read it back.  The backward reads
// grad_self, grad_mean (33.6 MB) and the code (46.1 MB) and writes dx
// (184.5 MB): 264 MB, 0.079 ms, where sage_mean_bwd's copy, fill and
// atomic adds wrote dy and sage_act_bwd read it back.
//
// What the design does about it:
//
// 1. A warp a target, as sage_mean.cu: its lanes load 32 slots' mask
//    bytes at once and a ballot gives the valid slots.  A lane owns S units
//    of a row (16-byte units where the row and every address allow: 64 for
//    256 fp32, 32 for 256 bf16, 25 for 100 fp32; 8, 4 or 2 bytes
//    elsewhere) and the E code bytes of each unit.  Rows of more than 64
//    units take several passes over the target's rows.
// 2. Bytes in flight.  The forward issues the loads of a, b and keep for
//    up to 4 / S rows before it computes any, 192 bytes a lane; the
//    backward loads the code of up to 8 / S rows at once.  A target's k
//    slot rows are contiguous, so each pass reads k whole rows' units.
// 3. Inputs are read through the non-coherent path (ld.global.nc); every
//    output unit is written once, coalesced.  No shared memory, no atomic,
//    no fill.
//
// Every size is a compile-time constant.

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include <type_traits>

#include "sage.cuh"

namespace {

using namespace qtt::sage;

constexpr int THREADS = 256;  // 8 warps a block, a target a warp

// The next layer's positional block: [t, k] mask; slot j of target tg
// names row t + tg k + j of the addends.
struct Block {
  const uint8_t* mask;  // [T, k] bool
  int64_t t;
  int k;

  // The ballot of target tg's valid slots j0 .. j0 + 31.
  __device__ __forceinline__ unsigned valid(int64_t tg, int j0,
                                            int lane) const {
    const int j = j0 + lane;
    return __ballot_sync(FULL, j < k && mask[tg * k + j] != 0);
  }

  __device__ __forceinline__ int64_t row(int64_t tg, int j) const {
    return t + tg * k + j;
  }
};

// The code bytes of a unit V of T: one load or store.
template <typename T, typename V>
using Code = typename Raw<sizeof(V) / sizeof(T)>::type;

// One unit forward: y and its code.
template <typename T, typename V>
__device__ __forceinline__ void act_unit(const V& a, const V& b, const V& k,
                                         float scale, V& y, Code<T, V>& c) {
  constexpr int E = sizeof(V) / sizeof(T);
  const T* pa = reinterpret_cast<const T*>(&a);
  const T* pb = reinterpret_cast<const T*>(&b);
  const T* pk = reinterpret_cast<const T*>(&k);
  T* py = reinterpret_cast<T*>(&y);
  uint8_t* pc = reinterpret_cast<uint8_t*>(&c);
#pragma unroll
  for (int e = 0; e < E; ++e) act<T>(pa[e], pb[e], pk[e], scale, py[e], pc[e]);
}

// One unit backward from E values of dy.
template <typename T, typename V>
__device__ __forceinline__ V grad_unit(const T (&dy)[sizeof(V) / sizeof(T)],
                                       const Code<T, V>& c, float scale) {
  constexpr int E = sizeof(V) / sizeof(T);
  const uint8_t* pc = reinterpret_cast<const uint8_t*>(&c);
  V out;
  T* o = reinterpret_cast<T*>(&out);
#pragma unroll
  for (int e = 0; e < E; ++e) o[e] = act_grad<T>(dy[e], pc[e], scale);
  return out;
}

// What sage_mean_bwd's atomic add of grad / cnt leaves in a zeroed row.
template <typename T>
__device__ __forceinline__ T slot_grad(T grad, float cnt) {
  const float q = round_to<T>(__fdiv_rn(to_float(grad), cnt));
  if constexpr (std::is_same<T, float>::value)
    return __fadd_rn(0.0f, fabsf(q) < FLT_MIN ? 0.0f : q);  // atom.add.f32
  else
    return from_float<T>(__fadd_rn(0.0f, q));  // atom.add.noftz.bf16x2
}

template <typename T, typename V, int S>
__global__ void __launch_bounds__(THREADS)
    sage_act_mean_fwd(const V* __restrict__ a, const V* __restrict__ b,
                      const V* __restrict__ keep, Block blk, float scale,
                      V* __restrict__ x_self, V* __restrict__ mean,
                      Code<T, V>* __restrict__ code, int64_t nv) {
  constexpr int E = sizeof(V) / sizeof(T);
  constexpr int F = 4 / S;  // rows whose loads a lane issues at once
  const int64_t t = warp_target<THREADS>(blk.t);
  if (t < 0) return;  // the whole warp
  const int lane = threadIdx.x & 31;
  for (int64_t base = 0; base < nv; base += 32 * S) {
    const int64_t u0 = base + lane;  // this lane's first unit
    // the self row
    {
      const int64_t off = t * nv + u0;
      V va[S], vb[S], vk[S];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        if (u0 + 32 * s < nv) {
          va[s] = __ldg(a + off + 32 * s);
          vb[s] = __ldg(b + off + 32 * s);
          vk[s] = __ldg(keep + off + 32 * s);
        }
      }
#pragma unroll
      for (int s = 0; s < S; ++s) {
        if (u0 + 32 * s < nv) {
          V y;
          Code<T, V> c;
          act_unit<T>(va[s], vb[s], vk[s], scale, y, c);
          x_self[off + 32 * s] = y;
          code[off + 32 * s] = c;
        }
      }
    }
    // the slot rows, F at a time, added in slot order where valid
    float acc[S][E];
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int e = 0; e < E; ++e) acc[s][e] = 0.0f;
    int count = 0;
    for (int j0 = 0; j0 < blk.k; j0 += 32) {
      const unsigned valid = blk.valid(t, j0, lane);  // the same on every lane
      count += __popc(valid);
      const int n = blk.k - j0 < 32 ? blk.k - j0 : 32;
      for (int q0 = 0; q0 < n; q0 += F) {
        V va[F][S], vb[F][S], vk[F][S];
#pragma unroll
        for (int q = 0; q < F; ++q) {
          if (q0 + q < n) {
            const int64_t off = blk.row(t, j0 + q0 + q) * nv + u0;
#pragma unroll
            for (int s = 0; s < S; ++s) {
              if (u0 + 32 * s < nv) {
                va[q][s] = __ldg(a + off + 32 * s);
                vb[q][s] = __ldg(b + off + 32 * s);
                vk[q][s] = __ldg(keep + off + 32 * s);
              }
            }
          }
        }
#pragma unroll
        for (int q = 0; q < F; ++q) {
          if (q0 + q < n) {
            const bool ok = (valid >> (q0 + q)) & 1u;
            const int64_t off = blk.row(t, j0 + q0 + q) * nv + u0;
#pragma unroll
            for (int s = 0; s < S; ++s) {
              if (u0 + 32 * s < nv) {
                V y;
                Code<T, V> c;
                act_unit<T>(va[q][s], vb[q][s], vk[q][s], scale, y, c);
                code[off + 32 * s] = c;
                if (ok) {
                  const T* py = reinterpret_cast<const T*>(&y);
#pragma unroll
                  for (int e = 0; e < E; ++e) acc[s][e] += to_float(py[e]);
                }
              }
            }
          }
        }
      }
    }
    const float cnt = round_to<T>(static_cast<float>(count > 0 ? count : 1));
    V* dst = mean + t * nv + u0;
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

// grad_mean and grad_self may each be null: a zero gradient.
template <typename T, typename V, int S>
__global__ void __launch_bounds__(THREADS)
    sage_act_mean_bwd(const V* __restrict__ grad_mean,
                      const V* __restrict__ grad_self,
                      const Code<T, V>* __restrict__ code, Block blk,
                      float scale, V* __restrict__ dx, int64_t nv) {
  constexpr int E = sizeof(V) / sizeof(T);
  constexpr int F = 8 / S;  // rows whose code a lane loads at once
  const int64_t t = warp_target<THREADS>(blk.t);
  if (t < 0) return;  // the whole warp
  const int lane = threadIdx.x & 31;
  const unsigned valid0 = blk.valid(t, 0, lane);
  int count = __popc(valid0);
  for (int j0 = 32; j0 < blk.k; j0 += 32)
    count += __popc(blk.valid(t, j0, lane));
  const float cnt = round_to<T>(static_cast<float>(count > 0 ? count : 1));
  const T zero = from_float<T>(0.0f);
  for (int64_t base = 0; base < nv; base += 32 * S) {
    const int64_t u0 = base + lane;
    // the self row, and the gradient every valid slot's row takes
    T g[S][E];
    {
      const int64_t off = t * nv + u0;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        if (u0 + 32 * s < nv) {
          T dy[E];
          if (grad_self != nullptr) {
            load<T, E>(reinterpret_cast<const T*>(grad_self + off + 32 * s),
                       dy);
          } else {
#pragma unroll
            for (int e = 0; e < E; ++e) dy[e] = zero;
          }
          if (grad_mean != nullptr) {
            load<T, E>(reinterpret_cast<const T*>(grad_mean + off + 32 * s),
                       g[s]);
#pragma unroll
            for (int e = 0; e < E; ++e) g[s][e] = slot_grad<T>(g[s][e], cnt);
          } else {
#pragma unroll
            for (int e = 0; e < E; ++e) g[s][e] = zero;
          }
          dx[off + 32 * s] =
              grad_unit<T, V>(dy, __ldg(code + off + 32 * s), scale);
        }
      }
    }
    for (int j0 = 0; j0 < blk.k; j0 += 32) {
      const unsigned valid = j0 == 0 ? valid0 : blk.valid(t, j0, lane);
      const int n = blk.k - j0 < 32 ? blk.k - j0 : 32;
      for (int q0 = 0; q0 < n; q0 += F) {
        Code<T, V> c[F][S];
#pragma unroll
        for (int q = 0; q < F; ++q) {
          if (q0 + q < n) {
            const int64_t off = blk.row(t, j0 + q0 + q) * nv + u0;
#pragma unroll
            for (int s = 0; s < S; ++s)
              if (u0 + 32 * s < nv) c[q][s] = __ldg(code + off + 32 * s);
          }
        }
#pragma unroll
        for (int q = 0; q < F; ++q) {
          if (q0 + q < n) {
            const bool ok = (valid >> (q0 + q)) & 1u;
            const int64_t off = blk.row(t, j0 + q0 + q) * nv + u0;
#pragma unroll
            for (int s = 0; s < S; ++s) {
              if (u0 + 32 * s < nv) {
                T dy[E];
#pragma unroll
                for (int e = 0; e < E; ++e) dy[e] = ok ? g[s][e] : zero;
                dx[off + 32 * s] = grad_unit<T, V>(dy, c[q][s], scale);
              }
            }
          }
        }
      }
    }
  }
}

bool misaligned(const void* p, int unit) {
  return p != nullptr && reinterpret_cast<uintptr_t>(p) % unit != 0;
}

struct Args {
  const void* a;          // forward: a; backward: grad_mean
  const void* b;          // forward: b; backward: grad_self
  const void* keep;       // forward: keep; backward: the code
  void* out0;             // forward: x_self; backward: dx
  void* out1;             // forward: mean
  void* code;             // forward: the code
};

// One kernel of the pair, by element type, unit and units a lane.
template <bool FWD>
int launch(const Args& p, Block blk, float scale, int64_t row_bytes,
           int unit, int bf, cudaStream_t s) {
  const int64_t nv = row_bytes / unit;
  const unsigned blocks = static_cast<unsigned>(cdiv(blk.t * 32, THREADS));
#define QTT_SAM_GO(T, V, S)                                                 \
  do {                                                                      \
    typedef Code<T, V> C;                                                   \
    if (FWD)                                                                \
      sage_act_mean_fwd<T, V, S><<<blocks, THREADS, 0, s>>>(                \
          static_cast<const V*>(p.a), static_cast<const V*>(p.b),           \
          static_cast<const V*>(p.keep), blk, scale,                        \
          static_cast<V*>(p.out0), static_cast<V*>(p.out1),                 \
          static_cast<C*>(p.code), nv);                                     \
    else                                                                    \
      sage_act_mean_bwd<T, V, S><<<blocks, THREADS, 0, s>>>(                \
          static_cast<const V*>(p.a), static_cast<const V*>(p.b),           \
          static_cast<const C*>(p.keep), blk, scale,                        \
          static_cast<V*>(p.out0), nv);                                     \
  } while (0)
#define QTT_SAM_S(T, V)    \
  do {                     \
    if (nv <= 32)          \
      QTT_SAM_GO(T, V, 1); \
    else                   \
      QTT_SAM_GO(T, V, 2); \
  } while (0)
  if (bf) {
    switch (unit) {
      case 16: QTT_SAM_S(bf16, uint4); break;
      case 8: QTT_SAM_S(bf16, uint2); break;
      case 4: QTT_SAM_S(bf16, uint32_t); break;
      default: QTT_SAM_S(bf16, uint16_t); break;
    }
  } else {
    switch (unit) {
      case 16: QTT_SAM_S(float, uint4); break;
      case 8: QTT_SAM_S(float, uint2); break;
      default: QTT_SAM_S(float, uint32_t); break;
    }
  }
#undef QTT_SAM_S
#undef QTT_SAM_GO
  return static_cast<int>(cudaGetLastError());
}

// Whether the arguments are ones the kernels take: a unit that divides
// the row and every address (the code's by its E bytes a unit).
bool bad_args(const Args& p, int64_t t, int k, int64_t row_bytes, int unit,
              int bf) {
  const int code_unit = unit / (bf ? 2 : 4);
  return bad_unit(unit, bf, row_bytes) || k < 0 || misaligned(p.a, unit) ||
         misaligned(p.b, unit) || misaligned(p.out0, unit) ||
         misaligned(p.out1, unit) ||
         misaligned(p.keep, p.code != nullptr ? unit : code_unit) ||
         misaligned(p.code, code_unit);
}

}  // namespace

// x_self [t, D] and mean [t, D] of the activation y = relu(a + b) * keep *
// scale, and code [n, D] bytes, over a positional block: mask [t, k] bool,
// a, b and keep [n, D] with n = t (1 + k), fp32 or bf16 when bf; D =
// row_bytes / element.  unit (4, 8 or 16, and 2 for bf16) divides
// row_bytes and the five values' addresses, unit / element the code's.
extern "C" int sage_act_mean(const void* a, const void* b, const void* keep,
                             const void* mask, int64_t t, int k, float scale,
                             void* x_self, void* mean, void* code,
                             int64_t row_bytes, int unit, int bf,
                             void* stream) {
  if (t <= 0 || row_bytes <= 0) return static_cast<int>(cudaGetLastError());
  const Args p{a, b, keep, x_self, mean, code};
  if (bad_args(p, t, k, row_bytes, unit, bf) || a == nullptr ||
      b == nullptr || keep == nullptr || code == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const Block blk{static_cast<const uint8_t*>(mask), t, k};
  return launch<true>(p, blk, scale, row_bytes, unit, bf,
                      static_cast<cudaStream_t>(stream));
}

// dx [n, D], the gradient of sage_act_mean's a (and b), from the mean's
// gradient grad_mean [t, D] and the self rows' grad_self [t, D] (each
// null for a zero gradient) and the forward's code.
extern "C" int sage_act_mean_backward(const void* grad_mean,
                                      const void* grad_self,
                                      const void* mask, int64_t t, int k,
                                      float scale, const void* code,
                                      void* dx, int64_t row_bytes, int unit,
                                      int bf, void* stream) {
  if (t <= 0 || row_bytes <= 0) return static_cast<int>(cudaGetLastError());
  const Args p{grad_mean, grad_self, code, dx, nullptr, nullptr};
  if (bad_args(p, t, k, row_bytes, unit, bf) || code == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const Block blk{static_cast<const uint8_t*>(mask), t, k};
  return launch<false>(p, blk, scale, row_bytes, unit, bf,
                       static_cast<cudaStream_t>(stream));
}
