// Kernel B2: feature-row gather, out[i, :] = table[row(i), :], where
// row(i) = order[clamp(idx[i], 0, N - 1)] when a row order is given and
// clamp(idx[i], 0, N - 1) when not; idx is int32 or int64.
//
// Replaces quiver_tpu/ops/pallas/gather_kernel.py::gather_rows (four row
// DMAs in flight per grid program over blocks of 256 rows) and the two
// takes in front of it in quiver_tpu/feature.py::lookup_device (the clip
// and the feature_order map), so that Feature.lookup_device is one call.
//
// What bounds it on the H100: device memory.  It does no arithmetic.  The
// least it must move is each distinct row once, each output row once and
// the ids: at Reddit's lookup (585,728 ids, 602-wide fp32 rows, 213,429
// distinct) 1.93 GB, 0.575 ms at 3.35 TB/s.  A copy that reads every drawn
// row moves 2.82 GB, and the table (561 MB) is eleven times the 50 MB L2,
// so most repeated draws of a row go back to device memory.  At R-GAT's
// MAG240M widths the 3.79 GB of output rows are most of the bound.
//
// What the design does about it (PERF.md gives the times of each choice,
// on an H100 80GB HBM3 at 700 W; b2_sweep.py times both routes):
//
// 1. Repeated rows: the grouped route.  A counting sort groups the call's
//    positions by row: a histogram of the rows (warp-aggregated atomics,
//    so the hundreds of thousands of masked slots that all read row 0 cost
//    one atomic a warp, not one each), an exclusive scan of the counts in
//    tiles, and a placement of every position in its row's slots.  Then a
//    warp walks a fixed chunk of GROUP slots: it loads a row into
//    registers once and stores it to every slot of the chunk that holds
//    it.  The chunks are fixed so that no warp walks all of a hot row's
//    slots.  Nothing is read back to the host: a call's launches depend on
//    its shapes only.  The grouped copy writes its rows in scattered
//    places, which costs more than the direct route's rows in order: it
//    writes whole 32-byte sectors only, and a pass in position order
//    writes the sectors that hold a row boundary (written in part from
//    two warps at two times, they cost Reddit fp32 0.1 ms).  It pays where
//    the table is more than twice the L2, there are 1.25 ids a row or
//    more and rows are 808 bytes or more (Reddit fp32: 0.85 ms against
//    1.00 direct; bf16 0.50 against 0.51).  The wrapper's rule picks the
//    route from the call's shapes (ops/cuda/gather_rows.py::route).
// 2. Copy width.  Rows that are 16-byte multiples in a 16-byte-aligned
//    table (ogbn-products' 400 bytes, MAG240M's 3,072) move as 16-byte
//    chunks.  Other rows (Reddit's 2,408 and 1,204 bytes, which start 4, 8
//    or 12 bytes off a 16-byte boundary) move in the widest unit that
//    divides the row and the table's address, 8 and 4 bytes there:
//    16-byte copies shifted in registers to the output's alignment were
//    measured slower there (fp32 0.96 ms against 0.93, bf16 0.57 against
//    0.51) and were taken out, as was a grouped copy in 16-byte chunks
//    shifted by warp shuffles (fp32 0.936 against 0.902, bf16 0.590
//    against 0.556, products 0.844 against 0.566: twice the registers, half
//    the warps in flight).  Every read lies inside its row, so none leaves
//    the table.
// 3. Narrow rows: the direct route's 16-byte copy is flat, one thread per
//    chunk of a row, not a warp a row, so a 400-byte row (25 chunks)
//    leaves no lane idle; a thread takes CHUNKS chunks and issues every
//    load before its stores (products: 0.32 ms against 0.41 for a warp a
//    row; 0.34 with one chunk a thread, 0.32 with four).  Other rows take
//    a warp each on the direct route, its lanes striding over the row's
//    units (a flat form was slower there).
// 4. The write path: the direct route's 16-byte stores stream
//    (st.global.cs, evict first), so the output does not push table rows
//    out of the L2; plain stores were within 1% (the four 16-byte lookups
//    took 1.797 ms streamed, 1.807 plain).  Other stores are plain.
//
// Every size is a compile-time constant.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int CHUNKS = 2;  // direct: 16-byte chunks a thread
constexpr int GROUP = 32;  // grouped: slots a warp walks, one a lane
constexpr int HOLD = 16;   // grouped: units of a row a lane holds
constexpr int SCAN_THREADS = 1024;
constexpr int SCAN_ITEMS = 4;
constexpr int TILE = SCAN_THREADS * SCAN_ITEMS;  // ops/cuda/gather_rows.py
constexpr unsigned FULL = 0xffffffffu;

// The table row of position i: idx[i] clamped to [0, n), then mapped
// through order (whose entries are clamped too, so a bad order cannot
// send a read outside the table).
struct RowOf {
  const void* idx;
  int idx64;
  const int32_t* order;
  int64_t n;

  __device__ __forceinline__ int64_t raw(int64_t i) const {
    return idx64 ? static_cast<const int64_t*>(idx)[i]
                 : static_cast<int64_t>(static_cast<const int32_t*>(idx)[i]);
  }
  __device__ __forceinline__ int64_t clamp(int64_t v) const {
    return v < 0 ? 0 : (v >= n ? n - 1 : v);
  }
  __device__ __forceinline__ int64_t map(int64_t v) const {
    v = clamp(v);
    return order == nullptr ? v : clamp(order[v]);
  }
};

// ---------------------------------------------------------------------
// The direct route.

// 16-byte rows in a 16-byte-aligned table: one thread per 16-byte chunk of
// a position's row (nc a row), CHUNKS chunks a thread, every load issued
// before the stores, which stream (evict first).  The row of chunk t is
// t / nc from a double product corrected by one, not an integer division.
__global__ void __launch_bounds__(THREADS)
    b2_chunks(const uint4* __restrict__ table, RowOf rows,
              uint4* __restrict__ out, int64_t m, int64_t nc, double inv_nc) {
  const uint64_t total = static_cast<uint64_t>(m) * nc;
  const uint64_t t0 = static_cast<uint64_t>(blockIdx.x) * CHUNKS * THREADS +
                      threadIdx.x;
  uint4 v[CHUNKS];
#pragma unroll
  for (int u = 0; u < CHUNKS; ++u) {
    const uint64_t t = t0 + static_cast<uint64_t>(u) * THREADS;
    if (t >= total) continue;
    uint64_t k = static_cast<uint64_t>(static_cast<double>(t) * inv_nc);
    if (k * nc > t) --k;
    else if ((k + 1) * nc <= t) ++k;
    const int64_t r = rows.map(rows.raw(static_cast<int64_t>(k)));
    v[u] = __ldg(table + static_cast<uint64_t>(r) * nc + (t - k * nc));
  }
#pragma unroll
  for (int u = 0; u < CHUNKS; ++u) {
    const uint64_t t = t0 + static_cast<uint64_t>(u) * THREADS;
    if (t >= total) continue;
    __stcs(out + t, v[u]);
  }
}

// Other rows: one warp per position, its lanes striding over the row's nv
// units of V (the widest of 8, 4, 2 or 1 bytes that divides the row and
// the table's address).
template <typename V>
__global__ void __launch_bounds__(THREADS)
    b2_units(const V* __restrict__ table, RowOf rows, V* __restrict__ out,
             int64_t m, int64_t nv) {
  const int64_t k =
      (static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x) >> 5;
  if (k >= m) return;
  const V* src = table + rows.map(rows.raw(k)) * nv;
  V* dst = out + k * nv;
  for (int64_t u = threadIdx.x & 31; u < nv; u += 32) dst[u] = src[u];
}

// ---------------------------------------------------------------------
// The grouped route's copy writes each output row's whole 32-byte sectors;
// the sectors that hold a row boundary (the seams) are written whole by
// b2_seams, so that no sector of the output is written in part from two
// places at two times (a sector written in part and evicted costs device
// memory a read and a write).

// Units [lo, hi) of the nv units of V at dst fill whole 32-byte sectors.
template <typename V>
__device__ __forceinline__ void whole_sectors(const V* dst, int64_t nv,
                                              int64_t& lo, int64_t& hi) {
  const uintptr_t d = reinterpret_cast<uintptr_t>(dst);
  lo = static_cast<int64_t>((32 - (d & 31)) & 31) / sizeof(V);
  hi = nv - static_cast<int64_t>((d + nv * sizeof(V)) & 31) / sizeof(V);
}

// The sectors of the output that hold a row boundary (the seams), each
// written whole by neighbouring threads: one thread per unit of V of the
// 32-byte sector that holds the start of row b, for b = 0 .. m (m: the
// output's end); a boundary on a sector's edge has no seam.  A unit
// belongs to the row p that holds it, read from table row map(idx[p]).
template <typename V>
__global__ void __launch_bounds__(THREADS)
    b2_seams(const V* __restrict__ table, RowOf rows, V* __restrict__ out,
             int64_t m, int64_t nv) {
  constexpr int64_t PER = 32 / sizeof(V);  // units of a sector
  const int64_t t = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  const int64_t b = t / PER;
  if (b > m) return;
  const uintptr_t o = reinterpret_cast<uintptr_t>(out);
  const uintptr_t start = o + static_cast<uint64_t>(b) * nv * sizeof(V);
  if ((start & 31) == 0) return;
  const uintptr_t a = (start & ~uintptr_t{31}) + (t % PER) * sizeof(V);
  if (a < o || a >= o + static_cast<uint64_t>(m) * nv * sizeof(V)) return;
  const int64_t e = static_cast<int64_t>(a - o) / static_cast<int64_t>(
      sizeof(V));  // unit of the output
  int64_t p = b < m ? b : m - 1;  // the row of unit e: p * nv <= e
  while (p * nv > e) --p;
  while ((p + 1) * nv <= e) ++p;
  out[e] = table[rows.map(rows.raw(p)) * nv + (e - p * nv)];
}

// A warp walks GROUP slots of the grouped list
// (a lane holds one slot's row and position) and, HOLD * 32 units of V at
// a time, loads a row into registers once when it differs from the one
// held and stores it to each slot's output row.  The slots of one row are
// neighbours, so a row is read once for each chunk of GROUP slots that
// holds it; the chunks are fixed, so no warp walks all of a hot row's.
// Units base .. base + 32 * HOLD - 1 of the rows of one warp's cnt slots
// (my_row, my_pos: a lane's slot), whole output sectors only; see b2_held.
template <typename V>
__device__ __forceinline__ void held_pass(const V* __restrict__ table,
                                          V* __restrict__ out, int64_t nv,
                                          int cnt, int my_row, int my_pos,
                                          int64_t base) {
  const int64_t seg = base + (threadIdx.x & 31);
  const int64_t left = nv - seg;  // units of the row from this lane's on
  V v[HOLD];
  int held = -1;
  for (int j = 0; j < cnt; ++j) {
    const int r = __shfl_sync(FULL, my_row, j);
    const int64_t pos = __shfl_sync(FULL, my_pos, j);
    if (r != held) {
      const V* src = table + r * nv + seg;
#pragma unroll
      for (int h = 0; h < HOLD; ++h)
        if (32 * h < left) v[h] = __ldg(src + 32 * h);
      held = r;
    }
    int64_t lo, hi;
    whole_sectors(out + pos * nv, nv, lo, hi);
    V* dst = out + pos * nv + seg;
#pragma unroll
    for (int h = 0; h < HOLD; ++h)
      if (32 * h < left && seg + 32 * h >= lo && seg + 32 * h < hi)
        dst[32 * h] = v[h];
  }
}

template <typename V>
__global__ void __launch_bounds__(THREADS)
    b2_held(const V* __restrict__ table, const int32_t* __restrict__ slot_row,
            const int32_t* __restrict__ slot_pos, V* __restrict__ out,
            int64_t m, int64_t nv) {
  const int lane = threadIdx.x & 31;
  const int64_t k0 =
      ((static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x) >> 5) *
      GROUP;
  if (k0 >= m) return;  // the whole warp
  const int cnt = static_cast<int>(m - k0 < GROUP ? m - k0 : GROUP);
  const int my_row = lane < cnt ? slot_row[k0 + lane] : 0;
  const int my_pos = lane < cnt ? slot_pos[k0 + lane] : 0;
  if (nv <= 32 * HOLD) {  // one pass holds the whole row
    held_pass(table, out, nv, cnt, my_row, my_pos, 0);
    return;
  }
  for (int64_t base = 0; base < nv; base += 32 * HOLD)  // the whole warp
    held_pass(table, out, nv, cnt, my_row, my_pos, base);
}

// ---------------------------------------------------------------------
// The grouped route's counting sort.

// Adds one for every active lane to counter[key], one atomic for each
// distinct key of the warp; returns this lane's slot (the count before its
// own add).  Every lane of the warp calls it.
__device__ __forceinline__ int warp_claim(int32_t* counter, int key,
                                          bool active) {
  const unsigned act = __ballot_sync(FULL, active);
  if (!active) return 0;
  const int lane = threadIdx.x & 31;
  const unsigned peers = __match_any_sync(act, key);
  const int leader = __ffs(peers) - 1;
  // the lanes under this one, from the hardware (a mask made by a shift of
  // a variable amount came out wrong from ptxas at -O3 in this kernel's
  // first form: PERF.md)
  unsigned below;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(below));
  int base = 0;
  if (lane == leader) base = atomicAdd(counter + key, __popc(peers));
  base = __shfl_sync(peers, base, leader);
  return base + __popc(peers & below);
}

__global__ void __launch_bounds__(THREADS)
    b2_count(RowOf rows, int64_t m, int32_t* __restrict__ counts) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  const bool active = i < m;
  warp_claim(counts, active ? static_cast<int>(rows.map(rows.raw(i))) : 0,
             active);
}

// Exclusive scan of v over the block's SCAN_THREADS threads; the block's
// sum goes to *total.
__device__ __forceinline__ int block_scan(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(FULL, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {  // SCAN_THREADS / 32 == 32 warp sums
    int s = warp_sums[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(FULL, s, d);
      if (lane >= d) s += y;
    }
    warp_sums[lane] = s;
  }
  __syncthreads();
  const int before = (warp == 0 ? 0 : warp_sums[warp - 1]) + x - v;
  *total = warp_sums[31];
  __syncthreads();  // warp_sums may be reused
  return before;
}

__global__ void __launch_bounds__(SCAN_THREADS)
    b2_tile_sums(const int32_t* __restrict__ counts, int64_t n,
                 int32_t* __restrict__ sums) {
  __shared__ int warp_sums[32];
  const int64_t j = static_cast<int64_t>(blockIdx.x) * TILE +
                    threadIdx.x * SCAN_ITEMS;
  int t = 0;
#pragma unroll
  for (int k = 0; k < SCAN_ITEMS; ++k) t += j + k < n ? counts[j + k] : 0;
  int total;
  block_scan(t, warp_sums, &total);
  if (threadIdx.x == 0) sums[blockIdx.x] = total;
}

// One block: the tile sums, scanned in place (exclusive).
__global__ void __launch_bounds__(SCAN_THREADS)
    b2_scan_sums(int32_t* __restrict__ sums, int64_t n_tiles) {
  __shared__ int warp_sums[32];
  int carry = 0;
  for (int64_t base = 0; base < n_tiles; base += TILE) {
    const int64_t j = base + threadIdx.x * SCAN_ITEMS;
    int v[SCAN_ITEMS], t = 0;
#pragma unroll
    for (int k = 0; k < SCAN_ITEMS; ++k) {
      v[k] = j + k < n_tiles ? sums[j + k] : 0;
      t += v[k];
    }
    int total;
    int run = carry + block_scan(t, warp_sums, &total);
#pragma unroll
    for (int k = 0; k < SCAN_ITEMS; ++k) {
      if (j + k < n_tiles) sums[j + k] = run;
      run += v[k];
    }
    carry += total;
  }
}

// counts[r] becomes the first slot of row r (exclusive scan).
__global__ void __launch_bounds__(SCAN_THREADS)
    b2_tile_scan(int32_t* __restrict__ counts, int64_t n,
                 const int32_t* __restrict__ sums) {
  __shared__ int warp_sums[32];
  const int64_t j = static_cast<int64_t>(blockIdx.x) * TILE +
                    threadIdx.x * SCAN_ITEMS;
  int v[SCAN_ITEMS], t = 0;
#pragma unroll
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    v[k] = j + k < n ? counts[j + k] : 0;
    t += v[k];
  }
  int total;
  int run = sums[blockIdx.x] + block_scan(t, warp_sums, &total);
#pragma unroll
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    if (j + k < n) counts[j + k] = run;
    run += v[k];
  }
}

// Every position into a slot of its row: slot_row and slot_pos list the
// positions grouped by row (in no fixed order within a row).
__global__ void __launch_bounds__(THREADS)
    b2_place(RowOf rows, int64_t m, int32_t* __restrict__ cursor,
             int32_t* __restrict__ slot_row, int32_t* __restrict__ slot_pos) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  const bool active = i < m;
  const int r = active ? static_cast<int>(rows.map(rows.raw(i))) : 0;
  const int slot = warp_claim(cursor, r, active);
  if (active) {
    slot_row[slot] = r;
    slot_pos[slot] = static_cast<int32_t>(i);
  }
}

int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

// The copy of either route, by the row's unit.
void launch_copy(const void* table, RowOf rows, const int32_t* slot_row,
                 const int32_t* slot_pos, void* out, int64_t m,
                 int64_t row_bytes, int unit, cudaStream_t s) {
  const int64_t nv = row_bytes / unit;
  if (slot_row == nullptr && unit == 16) {
    b2_chunks<<<static_cast<unsigned>(cdiv(m * nv, CHUNKS * THREADS)),
                THREADS, 0, s>>>(static_cast<const uint4*>(table), rows,
                                 static_cast<uint4*>(out), m, nv, 1.0 / nv);
    return;
  }
  const unsigned warps_blocks = static_cast<unsigned>(
      cdiv((slot_row ? cdiv(m, GROUP) : m) * 32, THREADS));
#define QTT_B2_COPY(T)                                                      \
  if (slot_row)                                                             \
    b2_held<T><<<warps_blocks, THREADS, 0, s>>>(                             \
        static_cast<const T*>(table), slot_row, slot_pos,                   \
        static_cast<T*>(out), m, nv);                                       \
  else                                                                      \
    b2_units<T><<<warps_blocks, THREADS, 0, s>>>(                            \
        static_cast<const T*>(table), rows, static_cast<T*>(out), m, nv)
  switch (unit) {
    case 16: QTT_B2_COPY(uint4); break;
    case 8: QTT_B2_COPY(uint2); break;
    case 4: QTT_B2_COPY(uint32_t); break;
    case 2: QTT_B2_COPY(uint16_t); break;
    default: QTT_B2_COPY(uint8_t); break;
  }
#undef QTT_B2_COPY
}

// The grouped route's seams (b2_seams), by the row's unit.
void launch_seams(const void* table, RowOf rows, void* out, int64_t m,
                  int64_t row_bytes, int unit, cudaStream_t s) {
  const int64_t nv = row_bytes / unit;
  const unsigned blocks =
      static_cast<unsigned>(cdiv((m + 1) * (32 / unit), THREADS));
#define QTT_B2_SEAMS(T)                                                     \
  b2_seams<T><<<blocks, THREADS, 0, s>>>(static_cast<const T*>(table), rows, \
                                         static_cast<T*>(out), m, nv)
  switch (unit) {
    case 16: QTT_B2_SEAMS(uint4); break;
    case 8: QTT_B2_SEAMS(uint2); break;
    case 4: QTT_B2_SEAMS(uint32_t); break;
    case 2: QTT_B2_SEAMS(uint16_t); break;
    default: QTT_B2_SEAMS(uint8_t); break;
  }
#undef QTT_B2_SEAMS
}

}  // namespace

// out [m, row_bytes / element] = the rows of table [n, row_bytes] at idx
// (int64 when idx64, else int32) clamped to [0, n) and mapped through
// order (int32 [n], or null).  `unit` (1, 2, 4, 8 or 16) divides row_bytes
// and the table's address; out is 16-byte aligned.  grouped picks the
// route; scratch holds n + ceil(n / TILE) + 2 m int32 words for it (the
// counts, the tile sums, and the grouped rows and positions).
extern "C" int gather_rows(const void* table, int64_t n, const void* idx,
                           int idx64, const void* order, void* out, int64_t m,
                           int64_t row_bytes, int unit, int grouped,
                           void* scratch, void* stream) {
  if (m <= 0 || row_bytes <= 0) return static_cast<int>(cudaGetLastError());
  if (n <= 0 || (reinterpret_cast<uintptr_t>(out) & 15) != 0 ||
      (unit != 1 && unit != 2 && unit != 4 && unit != 8 && unit != 16) ||
      row_bytes % unit != 0 ||
      reinterpret_cast<uintptr_t>(table) % unit != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const RowOf rows{idx, idx64, static_cast<const int32_t*>(order), n};
  if (!grouped) {
    launch_copy(table, rows, nullptr, nullptr, out, m, row_bytes, unit, s);
    return static_cast<int>(cudaGetLastError());
  }
  if (n >= INT32_MAX || m >= INT32_MAX || scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n_tiles = cdiv(n, TILE);
  int32_t* counts = static_cast<int32_t*>(scratch);
  int32_t* sums = counts + n;
  int32_t* slot_row = sums + n_tiles;
  int32_t* slot_pos = slot_row + m;
  const cudaError_t err =
      cudaMemsetAsync(counts, 0, n * sizeof(int32_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned per_pos = static_cast<unsigned>(cdiv(m, THREADS));
  b2_count<<<per_pos, THREADS, 0, s>>>(rows, m, counts);
  b2_tile_sums<<<static_cast<unsigned>(n_tiles), SCAN_THREADS, 0, s>>>(
      counts, n, sums);
  b2_scan_sums<<<1, SCAN_THREADS, 0, s>>>(sums, n_tiles);
  b2_tile_scan<<<static_cast<unsigned>(n_tiles), SCAN_THREADS, 0, s>>>(
      counts, n, sums);
  b2_place<<<per_pos, THREADS, 0, s>>>(rows, m, counts, slot_row, slot_pos);
  launch_copy(table, rows, slot_row, slot_pos, out, m, row_bytes, unit, s);
  if ((row_bytes & 31) != 0 || (reinterpret_cast<uintptr_t>(out) & 31) != 0)
    launch_seams(table, rows, out, m, row_bytes, unit, s);  // rows have seams
  return static_cast<int>(cudaGetLastError());
}
