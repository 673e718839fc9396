// GraphSAGE's hidden-layer activation in training and its gradient:
//
//   r    = relu(a + b)
//   y    = (r * keep) * scale
//   code = !(r <= 0) | (keep != 0) << 1          (one byte an element)
//   dx   = code & 1 ? (dy * scale) * (code >> 1) : +0
//
// where a is SAGEConv's lin_self output (bias included), b its lin_nbr
// output, keep the dropout's keep mask (0 or 1, drawn by the caller) and
// scale the fp32 reciprocal of 1 - p.  This is the op chain it replaces,
// op for op, as PyTorch rounds it on the card: the add, F.relu (clamp_min
// at 0, which passes NaN through), the product by keep and the division by
// the Python scalar 1 - p, which PyTorch's CUDA division runs as a product
// by the scalar's fp32 reciprocal; the backward is autograd's of that
// chain: the division's (the same product), the product's by keep and
// ReLU's threshold_backward (+0 where r <= 0).  For bf16 every op computes
// in fp32 and rounds to bf16, as PyTorch's bf16 ops do.  Each product is
// one IEEE multiply (-fmad=false, and __fmul_rn besides), so the outputs are
// the chain's bit for bit.  The byte holds all the backward needs: ReLU's
// output and the keep mask are not kept for it.  The element ops are
// sage.cuh's, which sage_act_mean.cu shares.
//
// Replaces no TPU kernel: the JAX package leaves ReLU and dropout to XLA
// (quiver_tpu/models/sage.py: nn.relu, nn.Dropout), which fuses them.  On
// the card the chain ran as four elementwise kernels forward (the add,
// ReLU, the product, the division) and three backward; the keep draw
// before them stays.
//
// What bounds it on the H100: device memory.  It does a few operations
// an element and moves 17 bytes an fp32 element forward (a, b and keep
// read, y and the byte written) and 9 backward (dy and the byte read, dx
// written).  At ogbn-products' layer 0 (180,224 targets, 256 wide) the
// forward moves 784 MB, 0.234 ms at 3.35 TB/s, and the backward 415 MB,
// 0.124 ms, where the chain moved 1,844 MB forward (besides the keep draw,
// which stays) and 1,475 MB backward.
//
// What the design does about it: one flat pass over the T x H elements
// (the tensors are contiguous, so rows do not matter), a thread E
// elements at a time, E * sizeof(T) = 16 bytes where every address allows
// it (E bytes of code), and a scalar loop over the last n mod E elements.
// Misaligned tensors take the scalar loop throughout.  The grid gives each
// thread one unit: at layer 0 the forward takes 0.260 ms (90% of its bound)
// and the backward 0.142 (88%) on the H100, where a grid of only the blocks
// the card holds at once, each walking a grid-stride loop, took 0.272 and
// 0.151.  The loop stays for tensors past 2**20 blocks.  Inputs are read
// through the non-coherent path (ld.global.nc).  No shared memory is used.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sage.cuh"

namespace {

using namespace qtt::sage;

constexpr int THREADS = 256;
constexpr int64_t MAX_BLOCKS = int64_t{1} << 20;

// Elements [0, n), E at a time, then the last n mod E one at a time.
template <typename T, int E>
__global__ void __launch_bounds__(THREADS)
    sage_act_fwd(const T* __restrict__ a, const T* __restrict__ b,
                 const T* __restrict__ keep, T* __restrict__ y,
                 uint8_t* __restrict__ code, int64_t n, float scale) {
  const int64_t step = static_cast<int64_t>(gridDim.x) * THREADS;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * THREADS +
                        threadIdx.x;
  const int64_t nv = n / E;
  for (int64_t u = first; u < nv; u += step) {
    const int64_t i = u * E;
    T va[E], vb[E], vk[E], vy[E];
    uint8_t vc[E];
    load<T, E>(a + i, va);
    load<T, E>(b + i, vb);
    load<T, E>(keep + i, vk);
#pragma unroll
    for (int e = 0; e < E; ++e) act<T>(va[e], vb[e], vk[e], scale, vy[e],
                                       vc[e]);
    store<T, E>(y + i, vy);
    store<uint8_t, E>(code + i, vc);
  }
  for (int64_t i = nv * E + first; i < n; i += step)
    act<T>(a[i], b[i], keep[i], scale, y[i], code[i]);
}

template <typename T, int E>
__global__ void __launch_bounds__(THREADS)
    sage_act_bwd(const T* __restrict__ dy, const uint8_t* __restrict__ code,
                 T* __restrict__ dx, int64_t n, float scale) {
  const int64_t step = static_cast<int64_t>(gridDim.x) * THREADS;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * THREADS +
                        threadIdx.x;
  const int64_t nv = n / E;
  for (int64_t u = first; u < nv; u += step) {
    const int64_t i = u * E;
    T vd[E], vx[E];
    uint8_t vc[E];
    load<T, E>(dy + i, vd);
    load<uint8_t, E>(code + i, vc);
#pragma unroll
    for (int e = 0; e < E; ++e) vx[e] = act_grad<T>(vd[e], vc[e], scale);
    store<T, E>(dx + i, vx);
  }
  for (int64_t i = nv * E + first; i < n; i += step)
    dx[i] = act_grad<T>(dy[i], code[i], scale);
}

// The blocks of a launch over `units`: one unit a thread, up to MAX_BLOCKS
// blocks, past which the grid-stride loop takes the rest.
unsigned blocks_for(int64_t units) {
  const int64_t b = (units + THREADS - 1) / THREADS;
  return static_cast<unsigned>(b < 1 ? 1 : (b > MAX_BLOCKS ? MAX_BLOCKS : b));
}

// Whether every address is a multiple of its unit: values' addresses of 16
// bytes, the code's of E bytes.
bool vectors(const void* const* values, int n_values, const void* code,
             int e) {
  for (int i = 0; i < n_values; ++i)
    if (reinterpret_cast<uintptr_t>(values[i]) % 16 != 0) return false;
  return reinterpret_cast<uintptr_t>(code) % e == 0;
}

template <typename T>
int fwd(const void* a, const void* b, const void* keep, void* y, void* code,
        int64_t n, float scale, cudaStream_t s) {
  constexpr int E = 16 / sizeof(T);
  const void* values[] = {a, b, keep, y};
  const T* pa = static_cast<const T*>(a);
  const T* pb = static_cast<const T*>(b);
  const T* pk = static_cast<const T*>(keep);
  T* py = static_cast<T*>(y);
  uint8_t* pc = static_cast<uint8_t*>(code);
  if (vectors(values, 4, code, E)) {
    const unsigned grid = blocks_for(n / E + 1);
    sage_act_fwd<T, E><<<grid, THREADS, 0, s>>>(pa, pb, pk, py, pc, n, scale);
  } else {
    const unsigned grid = blocks_for(n);
    sage_act_fwd<T, 1><<<grid, THREADS, 0, s>>>(pa, pb, pk, py, pc, n, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd(const void* dy, const void* code, void* dx, int64_t n, float scale,
        cudaStream_t s) {
  constexpr int E = 16 / sizeof(T);
  const void* values[] = {dy, dx};
  const T* pd = static_cast<const T*>(dy);
  const uint8_t* pc = static_cast<const uint8_t*>(code);
  T* px = static_cast<T*>(dx);
  if (vectors(values, 2, code, E)) {
    const unsigned grid = blocks_for(n / E + 1);
    sage_act_bwd<T, E><<<grid, THREADS, 0, s>>>(pd, pc, px, n, scale);
  } else {
    const unsigned grid = blocks_for(n);
    sage_act_bwd<T, 1><<<grid, THREADS, 0, s>>>(pd, pc, px, n, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y = relu(a + b) * keep * scale and its code byte, over n contiguous
// elements of a, b, keep and y (fp32, or bf16 when bf) and n bytes of code.
extern "C" int sage_act(const void* a, const void* b, const void* keep,
                        void* y, void* code, int64_t n, float scale, int bf,
                        void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf ? fwd<bf16>(a, b, keep, y, code, n, scale, s)
            : fwd<float>(a, b, keep, y, code, n, scale, s);
}

// dx = the gradient of sage_act's a (and b) from y's gradient dy and the
// forward's code, over n contiguous elements.
extern "C" int sage_act_backward(const void* dy, const void* code, void* dx,
                                 int64_t n, float scale, int bf,
                                 void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf ? bwd<bf16>(dy, code, dx, n, scale, s)
            : bwd<float>(dy, code, dx, n, scale, s);
}
