// EmbeddingBag forward: per bag, the sum (or the mean) of the gathered
// table rows, for all F sparse fields of a batch in one launch.
//
// Replaces the TPU kernel `repro/kernels/embedding_bag/kernel.py::
// embedding_bag_fwd` (`_bag_kernel`), which the DLRM forward would call
// once per field.  Semantics are `repro/models/dlrm.py::embedding_bag`:
// out[b, f] = sum over l of table_f[idx[b, f, l]] * w[b, f, l], divided by
// L for the mean.  An index is read as `jnp.take` reads it: one in [-V, -1]
// counts from the end of the table, and one outside [-V, V) gives a row
// of NaN, so that bag is NaN; the kernel never reads outside a table.
// Products, sums and the mean's division are single IEEE operations
// (`__fmul_rn`, `__fadd_rn`, `__fdiv_rn`), and each bag sums its lookups
// in the order l = 0 .. L-1 from 0.f, whatever the shape of the warp:
// `ref.py::embedding_bags_ordered` is that order in plain PyTorch, and
// every shape gives its bits.
//
// On the TPU the bag indices were scalar-prefetched so that a BlockSpec
// could stream each needed row into VMEM, one grid step a row.  Here the
// F tables are passed as a device array of pointers with their row
// counts, so one launch covers a DLRM forward (RM2 would otherwise make 26
// small launches a request).  A warp owns a tile of bags, in a shape the
// wrapper picks from (D, L, alignment) (`ops.py::geometry`) and passes in
// as (lanes a bag, floats a lane load, L it is built for, rounds):
//
//   * L in {1, 2, 4, 8} (`bag_tile_kernel<LANES, VEC, LT>`): the warp is
//     G = 32 / LANES bags side by side, LANES lanes each, lane t of a bag
//     holding columns t VEC .. t VEC + VEC - 1 (float4 where D % 4 == 0
//     and the tables and the output are 16-byte aligned, float2 at 8
//     bytes, else scalar; strips of 32 VEC columns where D > 32 VEC).  A
//     tile is R rounds of G bags, as many as keep its indices within one
//     a lane (G R L <= 32) and its rows within LOAD_FLOATS registers a
//     lane (R L VEC).  The tile's indices and weights come in with one
//     streaming load each (`__ldcs`: the index stream does not push the
//     tables out of L2) and go round by `__shfl_sync`; then every row
//     load of the tile is issued (`__ldg`, ld.global.nc) before the first
//     add, R L loads a lane in flight.  At RM2 (D = 64, L = 4) that is 16
//     lanes x float4 a bag, 4 bags (16 indices) a tile, 8 loads of 16
//     bytes a lane, where one warp per bag kept about one 128-byte row in
//     flight.  LOAD_FLOATS = 32 was measured best there
//     (`tools/bag_variants.py` patches it to 16, 64 and 128: slower).
//   * any other L (`bag_chunk_kernel<LANES, VEC>`, LANES >= CHUNK): G bags
//     side by side, each walking its lookups CHUNK at a time (the group
//     loads CHUNK indices, one a lane, and shuffles them round; the CHUNK
//     rows are issued, then added in order).
//
// The tiles walk the bags field by field: all B bags of field 0, then of
// field 1, and so on (`tile_of`).  At any moment the card gathers from
// one or two of the 26 tables, not all 36.8 GB of them, so a table that
// fits the 50 MB L2 is read from memory about once, and the rest's
// address translations stay within one table.  A tile's output rows are F
// D floats apart, each written whole.  The output goes out by streaming
// stores (`__stcs`): at serve_bulk it is 1.745 GB written once, which
// would otherwise evict the rows that L2 can keep.  Built with
// -DBAG_WARP_PER_BAG the entry launches the first port's kernel (one warp
// a bag, lanes over the columns in strips of 32, one lookup at a time;
// the same bits), for `tools/bag_variants.py`.  The backward's segment
// S (below) is BAG_BWD_SEGMENT, 32 unless built with
// -DBAG_BWD_SEGMENT=<S> (`tools/bag_parent_ab.py` times 32 to 256).
//
// What bounds it: bytes.  The indices (4 B each), the distinct rows the
// batch touches (D * 4 B each) and the output (D * 4 B a bag).  For
// DLRM-RM2 serve_bulk (B = 262,144, F = 26, L = 4, D = 64; uniform
// indices) that is 109 MB + ~12.7M distinct rows (3.26 GB) + 1.745 GB,
// 1.528 ms over 3.35 TB/s.  The 15 fields whose tables exceed the L2 draw
// a row from memory at every lookup, repeats included, so the gather
// itself reads ~4.0 GB: with the indices and the output 6.03 GB, 1.80 ms
// (the gather floor `chip_smoke.py` prints beside the bound).
#include <cub/device/device_radix_sort.cuh>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;                       // warps a block
constexpr unsigned FULL = 0xffffffffu;
constexpr int LOAD_FLOATS = 32;               // row floats in flight a lane
constexpr int CHUNK = 8;                       // lookups a step, any other L

// The rounds of a tile: the largest power of two R with G R LT <= 32 and
// R LT VEC <= LOAD_FLOATS (1 for the chunked kernel, LT = 0).
// `ops.py::geometry` computes the same.
__host__ __device__ constexpr int tile_rounds(int lanes, int vec, int lt) {
  if (lt == 0) return 1;
  int r = 1;
  while (2 * r * (32 / lanes) * lt <= 32 && 2 * r * lt * vec <= LOAD_FLOATS)
    r *= 2;
  return r;
}

// the table row an index reads, as `jnp.take` reads it; -1 outside [-V, V)
__device__ __forceinline__ long long take_row(int i, long long V) {
  long long r = i;
  if (r < 0) r += V;
  return (r >= 0 && r < V) ? r : -1;
}

template <int VEC>
__device__ __forceinline__ void load_row(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (VEC == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = __ldg(p);
  }
}

template <int VEC>
__device__ __forceinline__ void store_row(float* p, const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  } else if constexpr (VEC == 2) {
    __stcs(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
  } else {
    __stcs(p, v[0]);
  }
}

// the gathered row l of a bag at columns c .. c + VEC - 1: NaN for an
// index outside the table
template <int VEC>
__device__ __forceinline__ void gather(const float* table, long long row,
                                       int D, int c, float (&v)[VEC]) {
  if (row >= 0) {
    load_row<VEC>(table + row * D + c, v);
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) v[e] = NAN;
  }
}

// acc += v * w (or v), one rounding each, in the caller's l order
template <int VEC>
__device__ __forceinline__ void accumulate(float (&acc)[VEC],
                                           const float (&v)[VEC], float w,
                                           bool weighted) {
#pragma unroll
  for (int e = 0; e < VEC; ++e)
    acc[e] = __fadd_rn(acc[e], weighted ? __fmul_rn(v[e], w) : v[e]);
}

// The bags of warp tile t, NB bags a tile.  The tiles walk field 0's bags
// b = 0 .. B-1, then field 1's, ..., so at any moment the card gathers
// from one or two tables (B = n_bags / F); bag j of the tile is
// (b0 + j) F + f.
struct Tile {
  long long first;   // the tile's first bag
  long long step;    // bag j is first + j step
  long long count;   // bags j < count exist
  int f;             // the tile's field
};

__host__ __device__ inline long long n_tiles(long long n_bags, int F,
                                             int NB) {
  return F * ((n_bags / F + NB - 1) / NB);
}

__device__ __forceinline__ Tile tile_of(long long t, long long n_bags,
                                        int F, int NB) {
  const long long B = n_bags / F, per_field = (B + NB - 1) / NB;
  const int f = (int)(t / per_field);
  const long long b0 = (t - f * per_field) * NB;
  return {b0 * F + f, F, min((long long)NB, B - b0), f};
}

// L = LT in {1, 2, 4, 8}: a tile of R rounds of G bags, every row load of
// a strip issued before the first add.  Every shuffle sits outside any
// branch that differs between lanes (a masked column or a bag past the
// end only skips its loads and its store).
template <int LANES, int VEC, int LT>
__global__ void __launch_bounds__(WARPS * 32)
bag_tile_kernel(const float* const* __restrict__ tables,
                const long long* __restrict__ vocabs,
                const int* __restrict__ idx, const float* __restrict__ w,
                float* __restrict__ out, long long n_bags, int F, int D,
                int mean) {
  constexpr int G = 32 / LANES;                  // bags side by side
  constexpr int R = tile_rounds(LANES, VEC, LT);
  constexpr int NB = G * R;                      // bags a tile
  static_assert(LANES * G == 32 && NB * LT <= 32, "one index a lane");
  static_assert(VEC == 1 || VEC == 2 || VEC == 4, "vector width");
  const int lane = threadIdx.x & 31;
  const int g = lane / LANES;
  const long long t = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (t >= n_tiles(n_bags, F, NB)) return;       // warp-uniform
  const Tile tl = tile_of(t, n_bags, F, NB);
  const bool weighted = w != nullptr;

  // the tile's indices and weights, one a lane: one streaming load each
  // (coalesced: L consecutive ints a bag).  Bag j's lookup l sits at lane
  // j LT + l.
  int my_i = 0;
  float my_w = 0.f;
  if (lane < tl.count * LT) {
    const long long at = (tl.first + lane / LT * tl.step) * LT + lane % LT;
    my_i = __ldcs(idx + at);
    if (weighted) my_w = __ldcs(w + at);
  }
  // round r holds bag j = r G + g, all of field tl.f
  const float* const tab = tables[tl.f];
  const long long V = vocabs[tl.f];
  bool live[R];
#pragma unroll
  for (int r = 0; r < R; ++r) live[r] = r * G + g < tl.count;
  const int strips = (D + 32 * VEC - 1) / (32 * VEC);   // 1 where LANES < 32
  for (int s = 0; s < strips; ++s) {
    const int c = s * 32 * VEC + (lane % LANES) * VEC;
    const bool cols = c < D;
    float v[R][LT][VEC];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int l = 0; l < LT; ++l) {
        const int ix = __shfl_sync(FULL, my_i, (r * G + g) * LT + l);
        const long long row = live[r] && cols ? take_row(ix, V) : -1;
        gather<VEC>(tab, row, D, c, v[r][l]);
      }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float acc[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
#pragma unroll
      for (int l = 0; l < LT; ++l) {
        const float wl =
            weighted ? __shfl_sync(FULL, my_w, (r * G + g) * LT + l) : 0.f;
        accumulate<VEC>(acc, v[r][l], wl, weighted);
      }
      if (mean)
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] = __fdiv_rn(acc[e], (float)LT);
      if (live[r] && cols)
        store_row<VEC>(out + (tl.first + (r * G + g) * tl.step) * D + c,
                       acc);
    }
  }
}

// any other L (0 included): G bags side by side, each walking its
// lookups CHUNK at a time
template <int LANES, int VEC>
__global__ void __launch_bounds__(WARPS * 32)
bag_chunk_kernel(const float* const* __restrict__ tables,
                 const long long* __restrict__ vocabs,
                 const int* __restrict__ idx, const float* __restrict__ w,
                 float* __restrict__ out, long long n_bags, int F, int L,
                 int D, int mean) {
  constexpr int G = 32 / LANES;
  static_assert(LANES >= CHUNK && LANES * G == 32, "a lane an index");
  const int lane = threadIdx.x & 31;
  const int g = lane / LANES, t = lane % LANES;
  const long long tile = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (tile >= n_tiles(n_bags, F, G)) return;     // warp-uniform
  const Tile tl = tile_of(tile, n_bags, F, G);
  const bool weighted = w != nullptr;
  const long long bag = tl.first + g * tl.step;
  const bool live = g < tl.count;
  const float* table = tables[tl.f];
  const long long V = vocabs[tl.f];
  const int strips = (D + 32 * VEC - 1) / (32 * VEC);
  for (int s = 0; s < strips; ++s) {             // uniform: shuffles inside
    const int c = s * 32 * VEC + t * VEC;
    const bool cols = live && c < D;
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
    for (int l0 = 0; l0 < L; l0 += CHUNK) {
      int my_i = 0;
      float my_w = 0.f;
      if (live && t < CHUNK && l0 + t < L) {
        my_i = __ldcs(idx + bag * L + l0 + t);
        if (weighted) my_w = __ldcs(w + bag * L + l0 + t);
      }
      float v[CHUNK][VEC], wt[CHUNK];
#pragma unroll
      for (int i = 0; i < CHUNK; ++i) {
        const int ix = __shfl_sync(FULL, my_i, g * LANES + i);
        wt[i] = __shfl_sync(FULL, my_w, g * LANES + i);
        if (cols && l0 + i < L)
          gather<VEC>(table, take_row(ix, V), D, c, v[i]);
      }
#pragma unroll
      for (int i = 0; i < CHUNK; ++i)
        if (cols && l0 + i < L) accumulate<VEC>(acc, v[i], wt[i], weighted);
    }
    if (!cols) continue;
    if (mean)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = __fdiv_rn(acc[e], (float)L);
    store_row<VEC>(out + bag * D + c, acc);
  }
}

#ifdef BAG_WARP_PER_BAG
// The first port's kernel: one warp a bag, lanes over the D columns in
// strips of 32, one lookup at a time (the same sums in the same order).
template <bool WEIGHTED>
__global__ void __launch_bounds__(WARPS * 32)
bag_kernel(const float* const* __restrict__ tables,
           const long long* __restrict__ vocabs,
           const int* __restrict__ idx, const float* __restrict__ w,
           float* __restrict__ out, long long n_bags, int F, int L, int D,
           int mean) {
  const int lane = threadIdx.x & 31;
  const long long bag = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (bag >= n_bags) return;
  const int f = (int)(bag % F);
  const float* __restrict__ table = tables[f];
  const long long V = vocabs[f];
  const int* bidx = idx + bag * L;
  float* orow = out + bag * D;
  for (int d = lane; d < D; d += 32) {
    float acc = 0.f;
    for (int l = 0; l < L; ++l) {
      long long i = bidx[l];
      if (i < 0) i += V;
      float v = (i >= 0 && i < V) ? table[i * D + d] : NAN;
      if (WEIGHTED) v = __fmul_rn(v, w[bag * L + l]);
      acc = __fadd_rn(acc, v);
    }
    orow[d] = mean ? __fdiv_rn(acc, (float)L) : acc;
  }
}
#endif

struct Args {
  const float* const* tables;
  const long long* vocabs;
  const int* idx;
  const float* w;
  float* out;
  long long n_bags;
  int F, L, D, mean;
  cudaStream_t s;
};

cudaError_t grid(long long warps, unsigned* blocks) {
  const long long b = (warps + WARPS - 1) / WARPS;
  if (b > 0x7fffffffLL) return cudaErrorInvalidValue;
  *blocks = (unsigned)b;
  return cudaSuccess;
}

template <int LANES, int VEC, int LT>
cudaError_t go(const Args& a) {
  unsigned blocks;
#ifdef BAG_WARP_PER_BAG
  if (cudaError_t e = grid(a.n_bags, &blocks)) return e;
  if (a.w)
    bag_kernel<true><<<blocks, WARPS * 32, 0, a.s>>>(
        a.tables, a.vocabs, a.idx, a.w, a.out, a.n_bags, a.F, a.L, a.D,
        a.mean);
  else
    bag_kernel<false><<<blocks, WARPS * 32, 0, a.s>>>(
        a.tables, a.vocabs, a.idx, a.w, a.out, a.n_bags, a.F, a.L, a.D,
        a.mean);
#else
  if constexpr (LT == 0) {
    if (cudaError_t e = grid(n_tiles(a.n_bags, a.F, 32 / LANES), &blocks))
      return e;
    bag_chunk_kernel<LANES, VEC><<<blocks, WARPS * 32, 0, a.s>>>(
        a.tables, a.vocabs, a.idx, a.w, a.out, a.n_bags, a.F, a.L, a.D,
        a.mean);
  } else {
    constexpr int NB = (32 / LANES) * tile_rounds(LANES, VEC, LT);
    if (cudaError_t e = grid(n_tiles(a.n_bags, a.F, NB), &blocks)) return e;
    bag_tile_kernel<LANES, VEC, LT><<<blocks, WARPS * 32, 0, a.s>>>(
        a.tables, a.vocabs, a.idx, a.w, a.out, a.n_bags, a.F, a.D, a.mean);
  }
#endif
  return cudaGetLastError();
}

// the instantiations: LT in {1, 2, 4, 8} with LANES >= LT, LT = 0 (any
// other L) with LANES >= CHUNK
template <int LANES, int VEC>
cudaError_t by_lt(int lt, const Args& a) {
  switch (lt) {
    case 0: if constexpr (LANES >= CHUNK) return go<LANES, VEC, 0>(a); break;
    case 1: return go<LANES, VEC, 1>(a);
    case 2: if constexpr (LANES >= 2) return go<LANES, VEC, 2>(a); break;
    case 4: if constexpr (LANES >= 4) return go<LANES, VEC, 4>(a); break;
    case 8: if constexpr (LANES >= 8) return go<LANES, VEC, 8>(a); break;
  }
  return cudaErrorInvalidValue;
}

template <int VEC>
cudaError_t by_lanes(int lanes, int lt, const Args& a) {
  switch (lanes) {
    case 1: return by_lt<1, VEC>(lt, a);
    case 2: return by_lt<2, VEC>(lt, a);
    case 4: return by_lt<4, VEC>(lt, a);
    case 8: return by_lt<8, VEC>(lt, a);
    case 16: return by_lt<16, VEC>(lt, a);
    case 32: return by_lt<32, VEC>(lt, a);
  }
  return cudaErrorInvalidValue;
}

// ---- backward: the tables' dense gradients ----
//
// Replaces no TPU kernel (the JAX package has no Pallas backward; XLA's
// autodiff of the gather scatter-adds each bag's cotangent into a dense
// zero table).  Every lookup of the batch, all F fields at once, gets a
// key: its table row plus the rows of the tables before it, or `total`,
// past every row, for a dropped lookup (an index outside [-V, V)).  Keys
// and positions are int32: the wrapper refuses a total of rows or a B F L
// of 2^31 or more.  Three kernels and a sort, no float atomics, so every
// run gives the same bits:
//
//   * `bag_bwd_keys_kernel` writes each lookup's key and its flat (b, f,
//     l) position, in (b, f, l) order.
//   * The wrapper sorts the (key, position) pairs stably over the low
//     ceil(log2(total + 1)) bits only, 24 at DLRM-RM2's train_batch
//     (`embedding_bag_bwd_sort`: CUB's radix sort).  The lookups then come
//     table by table, and each row's in (b, l) order.
//   * `bag_bwd_segments_kernel` cuts the sorted lookups into segments of
//     S = BWD_S (`ref.py::SEGMENT`, 32) fixed when the library is built, a
//     group of lanes a segment, the lanes
//     over a row's columns (16 lanes of float4 at D = 64: two segments a
//     warp).  A group walks its segment BWD_STEP lookups a step, every
//     bag-gradient load of a step in flight before the first add, and
//     sums each run fragment (the segment's lookups of one key) from 0.f
//     in sorted order: gout[b, f] divided by L for the mean (`__fdiv_rn`),
//     times the weight (`__fmul_rn`), added by `__fadd_rn`.  A run that
//     lies inside the segment is its row's gradient, written once by
//     streaming stores.  A fragment that goes on into the segment before
//     or after goes to the partial buffer [n_segments, 2, D]: slot 0 if it
//     opens the segment, else slot 1.  No group walks more than S
//     lookups, however many a row has.
//   * `bag_bwd_rows_kernel` takes BWD_TILE rows a block and finds each
//     row's run [a, b) of sorted lookups by binary search: the tile's
//     range by two warps, 32 probes a round; then each row within it, from
//     shared memory where the range holds at most BWD_STAGE lookups.  It
//     writes every row the segments kernel did not: +0.0 where no lookup
//     reads the row, and for a run over segments a / S .. (b - 1) / S the
//     sum from 0.f of its fragments' partials in segment order (slot 1 of
//     the first, slot 0 of the others).  Streaming stores.
//
// So each row of the [total, D] gradient is written exactly once, and the
// wrapper fills nothing.  `ref.py::embedding_bags_bwd_ordered` is the
// same sums in the same order; where no run crosses a segment, they are
// the CPU's `index_add_` bit for bit.
//
// What bounds it: bytes.  The call must read the indices and the bag
// gradients and write the dense gradients whole: at DLRM-RM2's
// train_batch (B = 65,536, 26 x 4 lookups, D = 64, tables cut to 2^20
// rows, 14.7M rows) 27 MB + 436 MB + 3.77 GB, 1.26 ms over 3.35 TB/s.
// The two kernels together move more: the segments kernel writes the
// touched rows (1.0 GB there) and reads a bag gradient at each lookup,
// which L2 serves only in part (one field's bag gradients are 16.8 MB,
// but the lookups in flight span several fields); the rows kernel writes
// the rest.  A smaller S narrows that span but lengthens the partial
// sums of a hot row: on an H100 80GB HBM3 the two kernels were fastest
// at S = 32 of 32 to 256, both at train_batch and at a batch whose
// hottest row has 46,536 lookups (`tools/bag_parent_ab.py`).
#ifndef BAG_BWD_SEGMENT
#define BAG_BWD_SEGMENT 32
#endif
constexpr int BWD_THREADS = 256;   // threads a block of the rows kernel
constexpr int BWD_TILE = 512;      // rows a block of the rows kernel
constexpr int BWD_UNROLL = 8;      // partials in flight a lane (rows kernel)
constexpr int BWD_STEP = 8;        // lookups a step (segments kernel)
constexpr int BWD_STAGE = 4096;    // sorted keys a rows block stages
constexpr int BWD_S = BAG_BWD_SEGMENT;   // sorted lookups a segment
static_assert(BWD_S > 0, "BAG_BWD_SEGMENT must be positive");
constexpr int BWD_SEGMENTS = 1;    // `parts` bits of the C entry
constexpr int BWD_ROWS = 2;

// W floats a lane of a row (1, 2 or 4): the backward's stores,
// streaming, or plain for the partials, which the rows kernel reads back
template <int W, bool STREAM>
__device__ __forceinline__ void bwd_store(float* p, const float (&v)[W]) {
  if constexpr (STREAM) {
    store_row<W>(p, v);
  } else if constexpr (W == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (W == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

// the first index in [lo, hi) whose key is >= x (hi if none); keys in
// shared or global memory
__device__ __forceinline__ int first_at_least(const int* keys, int lo,
                                              int hi, int x) {
  while (lo < hi) {
    const int mid = lo + (hi - lo) / 2;
    if (keys[mid] < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// the same over [0, n) by a whole warp, 32 probes a round: each round
// keeps the one step of the range between the last probe below x and
// the first at or above it
__device__ __forceinline__ int warp_first_at_least(
    const int* __restrict__ keys, int n, int x) {
  const int lane = threadIdx.x & 31;
  long long lo = 0, hi = n;                // the answer is in [lo, hi]
  while (hi > lo) {                        // 64 bits: no overflow near 2^31
    const long long step = (hi - lo + 31) / 32;
    const long long probe = lo + (lane + 1) * step - 1;
    const bool below = probe < hi && __ldg(keys + probe) < x;
    const int c = __popc(__ballot_sync(FULL, below));
    if (step == 1) return (int)(lo + c);
    hi = min(hi, lo + (c + 1) * step - 1);
    lo += c * step;
  }
  return (int)lo;
}

// each lookup's key (global row, or total) and flat position
__global__ void __launch_bounds__(256)
bag_bwd_keys_kernel(const int* __restrict__ idx,
                    const long long* __restrict__ vocabs,
                    const long long* __restrict__ firsts,
                    int* __restrict__ keys, int* __restrict__ pos, int n,
                    int F, int L, int total) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const int f = (p / L) % F;
  const long long r = take_row(__ldcs(idx + p), __ldg(vocabs + f));
  keys[p] = r >= 0 ? static_cast<int>(__ldg(firsts + f) + r) : total;
  pos[p] = p;
}

// a group of LANES lanes, W floats each, a segment of BWD_S sorted lookups
// (see above); lshift is log2 L where L is a power of two, else -1
template <int LANES, int W>
__global__ void __launch_bounds__(WARPS * 32)
bag_bwd_segments_kernel(const int* __restrict__ keys,
                        const int* __restrict__ pos,
                        const float* __restrict__ gout,
                        const float* __restrict__ w,
                        float* __restrict__ grad,
                        float* __restrict__ partial, int n, int total, int L,
                        int lshift, int D, int mean) {
  constexpr int G = 32 / LANES;                  // segments a warp
  constexpr int C = BWD_STEP;                    // lookups a step
  constexpr int S = BWD_S;
  const int lane = threadIdx.x & 31, t = lane % LANES;
  const long long seg =
      ((long long)blockIdx.x * WARPS + (threadIdx.x >> 5)) * G + lane / LANES;
  const long long base = seg * S;
  const int len = base < n ? (int)min((long long)S, n - base) : 0;
  // the keys just before and just after the segment (-1: none)
  const int before = len && base > 0 ? __ldg(keys + base - 1) : -1;
  const int after = len && base + len < n ? __ldg(keys + base + len) : -1;
  const bool weighted = w != nullptr;
  const float fl = static_cast<float>(L);
  const int strips = (D + LANES * W - 1) / (LANES * W);
  for (int s = 0; s < strips; ++s) {             // no shuffles below
    const int c = (s * LANES + t) * W;
    const bool cols = c < D;
    float acc[W];
#pragma unroll
    for (int u = 0; u < W; ++u) acc[u] = 0.f;
    for (int e0 = 0; e0 < len; e0 += C) {
      int k[C], p[C];
#pragma unroll
      for (int i = 0; i < C; ++i) {
        const bool in = e0 + i < len;
        k[i] = in ? __ldg(keys + base + e0 + i) : total;
        p[i] = in ? __ldg(pos + base + e0 + i) : 0;
      }
      float v[C][W], wt[C];
#pragma unroll
      for (int i = 0; i < C; ++i) {
        const bool use = k[i] < total;
        const int bf = lshift >= 0 ? p[i] >> lshift : p[i] / L;   // b F + f
        if (use && cols) load_row<W>(gout + (long long)bf * D + c, v[i]);
        wt[i] = use && weighted ? __ldg(w + p[i]) : 1.f;
      }
#pragma unroll
      for (int i = 0; i < C; ++i) {
        if (k[i] >= total) break;       // dropped lookups sort last
        const int e = e0 + i;
        if (cols)
#pragma unroll
          for (int u = 0; u < W; ++u) {
            float x = v[i][u];
            if (mean) x = __fdiv_rn(x, fl);
            if (weighted) x = __fmul_rn(x, wt[i]);
            acc[u] = __fadd_rn(acc[u], x);
          }
        const bool end = e == len - 1;
        const int next = end ? after
                             : i + 1 < C ? k[i + 1]
                                         : __ldg(keys + base + e + 1);
        if (end || next != k[i]) {               // the fragment closes
          // it opens the segment and goes on from the one before; it
          // closes the segment and goes on into the next
          const bool head = before == k[i];
          const bool tail = end && after == k[i];
          if (cols) {
            if (head || tail)
              bwd_store<W, false>(
                  partial + (seg * 2 + (head ? 0 : 1)) * D + c, acc);
            else
              bwd_store<W, true>(grad + (long long)k[i] * D + c, acc);
          }
#pragma unroll
          for (int u = 0; u < W; ++u) acc[u] = 0.f;
        }
      }
    }
  }
}

// BWD_TILE rows a block: each row's run [a, b) of sorted lookups by
// binary search (the tile's range first, by two warps; then each row
// within it, in shared memory where the range has at most BWD_STAGE
// lookups), zeros to the rows no lookup reads and the partials' sums to
// the runs that span segments; the segments kernel wrote the rest
template <int LANES, int W>
__global__ void __launch_bounds__(BWD_THREADS)
bag_bwd_rows_kernel(const int* __restrict__ keys,
                    const float* __restrict__ partial,
                    float* __restrict__ grad, int n, int total, int D) {
  constexpr int G = 32 / LANES;                  // rows a warp step
  constexpr int S = BWD_S;
  __shared__ int run[BWD_TILE + 1];   // row j's lookups: [run[j], run[j+1])
  __shared__ int staged[BWD_STAGE];
  const int r0 = blockIdx.x * BWD_TILE;
  const int rows = min(BWD_TILE, total - r0);
  if (threadIdx.x < 64) {             // warps 0 and 1: the tile's range
    const int at = threadIdx.x < 32 ? 0 : rows;
    const int i = warp_first_at_least(keys, n, r0 + at);
    if ((threadIdx.x & 31) == 0) run[at] = i;
  }
  __syncthreads();
  const int lo = run[0], hi = run[rows];
  const bool stage = hi - lo <= BWD_STAGE;
  if (stage)
    for (int e = lo + threadIdx.x; e < hi; e += BWD_THREADS)
      staged[e - lo] = __ldg(keys + e);
  __syncthreads();
  const int* tk = stage ? staged : keys + lo;   // the tile's keys
  for (int j = threadIdx.x + 1; j < rows; j += BWD_THREADS)
    run[j] = lo + first_at_least(tk, 0, hi - lo, r0 + j);
  __syncthreads();
  const int lane = threadIdx.x & 31, t = lane % LANES;
  const int strips = (D + LANES * W - 1) / (LANES * W);
  for (int j = (threadIdx.x >> 5) * G + lane / LANES; j < rows;
       j += BWD_THREADS / 32 * G) {
    const int a = run[j], b = run[j + 1];
    const bool touched = a < b;
    const int s0 = a / S, s1 = touched ? (b - 1) / S : s0 - 1;
    if (touched && s0 == s1) continue;           // the segments kernel's
    float* out = grad + (long long)(r0 + j) * D;
    for (int s = 0; s < strips; ++s) {
      const int c = (s * LANES + t) * W;
      if (c >= D) break;
      float acc[W];
#pragma unroll
      for (int u = 0; u < W; ++u) acc[u] = 0.f;
      for (int q0 = s0; q0 <= s1; q0 += BWD_UNROLL) {  // segment order
        float v[BWD_UNROLL][W];
#pragma unroll
        for (int i = 0; i < BWD_UNROLL; ++i)
          if (q0 + i <= s1)
            load_row<W>(partial + ((long long)(q0 + i) * 2
                                   + (q0 + i == s0 ? 1 : 0)) * D + c,
                        v[i]);
#pragma unroll
        for (int i = 0; i < BWD_UNROLL; ++i)
          if (q0 + i <= s1)
#pragma unroll
            for (int u = 0; u < W; ++u) acc[u] = __fadd_rn(acc[u], v[i][u]);
      }
      bwd_store<W, true>(out + c, acc);
    }
  }
}

struct BwdArgs {
  const int* keys;
  const int* pos;
  const float* gout;
  const float* w;
  float* grad;
  float* partial;
  int n, total, L, lshift, D, mean, parts;
  cudaStream_t s;
};

template <int LANES, int W>
cudaError_t bwd_go(const BwdArgs& a) {
  if ((a.parts & BWD_SEGMENTS) && a.n > 0) {
    constexpr int G = 32 / LANES;                // segments a warp
    const long long segs = (a.n + (long long)BWD_S - 1) / BWD_S;
    unsigned blocks;
    if (cudaError_t e = grid((segs + G - 1) / G, &blocks)) return e;
    bag_bwd_segments_kernel<LANES, W><<<blocks, WARPS * 32, 0, a.s>>>(
        a.keys, a.pos, a.gout, a.w, a.grad, a.partial, a.n, a.total, a.L,
        a.lshift, a.D, a.mean);
    if (cudaError_t e = cudaGetLastError()) return e;
  }
  if ((a.parts & BWD_ROWS) && a.total > 0) {
    const unsigned blocks = (unsigned)((a.total + BWD_TILE - 1) / BWD_TILE);
    bag_bwd_rows_kernel<LANES, W><<<blocks, BWD_THREADS, 0, a.s>>>(
        a.keys, a.partial, a.grad, a.n, a.total, a.D);
  }
  return cudaGetLastError();
}

template <int W>
cudaError_t bwd_by_lanes(int lanes, const BwdArgs& a) {
  switch (lanes) {
    case 1: return bwd_go<1, W>(a);
    case 2: return bwd_go<2, W>(a);
    case 4: return bwd_go<4, W>(a);
    case 8: return bwd_go<8, W>(a);
    case 16: return bwd_go<16, W>(a);
    case 32: return bwd_go<32, W>(a);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// keys [n] and pos [n] (int32) for the n = B F L lookups
// of idx [B, F, L]: each one's global row (its table's row plus the rows
// of the tables before it: firsts [F], int64 on the device beside vocabs
// [F]), or total for a dropped one, and its flat (b, f, l) position.
// Returns the launch's error code.
extern "C" int embedding_bag_bwd_keys(const int* idx, const void* vocabs,
                                      const void* firsts, int* keys,
                                      int* pos, long long n, int F, int L,
                                      long long total, void* stream) {
  if (n < 0 || n > 0x7fffffffLL || total < 0 || total > 0x7fffffffLL ||
      F <= 0 || L < 0 || (n > 0 && L == 0))
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  bag_bwd_keys_kernel<<<(unsigned)((n + 255) / 256), 256, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      idx, static_cast<const long long*>(vocabs),
      static_cast<const long long*>(firsts), keys, pos, (int)n, F, L,
      (int)total);
  return cudaGetLastError();
}

// The stable sort of the (key, position) pairs by key bits [0, bits):
// CUB's radix sort.  With temp null it only sets *bytes to the temporary
// storage it needs (the wrapper allocates it).  Returns its error code.
extern "C" int embedding_bag_bwd_sort(void* temp, unsigned long long* bytes,
                                      const int* keys_in, int* keys_out,
                                      const int* pos_in, int* pos_out,
                                      long long n, int bits, void* stream) {
  if (n < 0 || n > 0x7fffffffLL || bits < 1 || bits > 32)
    return cudaErrorInvalidValue;
  size_t b = static_cast<size_t>(*bytes);
  const cudaError_t e = cub::DeviceRadixSort::SortPairs(
      temp, b, reinterpret_cast<const unsigned*>(keys_in),
      reinterpret_cast<unsigned*>(keys_out), pos_in, pos_out,
      static_cast<int>(n), 0, bits, static_cast<cudaStream_t>(stream));
  *bytes = b;
  return e;
}

// grad [total, D] (the F tables' gradients one after the other, written
// whole here: nothing needs to fill it) for the bags' gradients gout [B,
// F, D] at the n = B F L lookups: keys [n] and pos [n] as sorted by
// `embedding_bag_bwd_sort`; w [B, F, L] or null; partial [ceil(n / S), 2,
// D] f32 scratch; S the segment, which must be the BWD_S the library was
// built with (the wrapper sizes partial by it).  (lanes, vec) is the
// shape of a group:
// vec floats a lane, 1, 2 or 4 dividing D, with gout, grad and partial
// aligned to 4 vec bytes; lanes a power of two up to 32 with lanes x vec
// >= D below 32.  `parts` launches the segments kernel (1), the rows
// kernel (2) or both (3).  Returns the first launch error code (0 on
// success).
extern "C" int embedding_bag_bwd_launch(const int* keys, const int* pos,
                                        const float* gout, const float* w,
                                        float* grad, float* partial,
                                        long long n, long long total, int L,
                                        int D, int mean, int segment,
                                        int lanes, int vec, int parts,
                                        void* stream) {
  if (n < 0 || n > 0x7fffffffLL || total < 0 || total > 0x7fffffffLL ||
      L < 0 || (n > 0 && L == 0) || D <= 0 || segment != BWD_S ||
      parts < 1 || parts > 3)
    return cudaErrorInvalidValue;
  if ((vec != 1 && vec != 2 && vec != 4) || D % vec ||
      reinterpret_cast<uintptr_t>(gout) % (4 * vec) ||
      reinterpret_cast<uintptr_t>(grad) % (4 * vec) ||
      reinterpret_cast<uintptr_t>(partial) % (4 * vec))
    return cudaErrorInvalidValue;
  if (lanes < 32 && lanes * vec < D) return cudaErrorInvalidValue;
  const int lshift = L > 0 && !(L & (L - 1)) ? __builtin_ctz(L) : -1;
  const BwdArgs a{keys, pos, gout, w, grad, partial, (int)n, (int)total,
                  L, lshift, D, mean, parts,
                  static_cast<cudaStream_t>(stream)};
  switch (vec) {
    case 1: return bwd_by_lanes<1>(lanes, a);
    case 2: return bwd_by_lanes<2>(lanes, a);
    default: return bwd_by_lanes<4>(lanes, a);
  }
}

// out[B, F, D]; tables and vocabs are device arrays of F entries; idx and
// w (null when unweighted) are [B, F, L].  (lanes, vec, lt, rounds) is the
// warp's shape from `ops.py::geometry`: lanes a bag, a power of two up to
// 32 with lanes x vec >= D below 32; vec 1, 2 or 4 dividing D, with the
// tables and out aligned to 4 vec bytes (the wrapper checks the tables,
// this entry the output); lt = L for L in {1, 2, 4, 8} with lanes >= L,
// or 0 with lanes >= 8; rounds = tile_rounds(lanes, vec, lt).  A shape the
// kernel is not built for is refused (cudaErrorInvalidValue), as are
// empty or oversized launches.  Returns the launch's error code (0 on
// success).
extern "C" int embedding_bag_launch(const void* tables, const void* vocabs,
                                    const int* idx, const float* w,
                                    float* out, long long n_bags, int F,
                                    int L, int D, int mean, int lanes,
                                    int vec, int lt, int rounds,
                                    void* stream) {
  if (n_bags <= 0 || F <= 0 || n_bags % F || L < 0 || D <= 0)
    return cudaErrorInvalidValue;
  if ((vec != 1 && vec != 2 && vec != 4) || D % vec ||
      reinterpret_cast<uintptr_t>(out) % (4 * vec))
    return cudaErrorInvalidValue;
  if (lanes < 32 && lanes * vec < D) return cudaErrorInvalidValue;
  if (lt != 0 && lt != L) return cudaErrorInvalidValue;
  if (lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) ||
      rounds != tile_rounds(lanes, vec, lt))
    return cudaErrorInvalidValue;
  const Args a{static_cast<const float* const*>(tables),
               static_cast<const long long*>(vocabs), idx, w, out, n_bags,
               F, L, D, mean, static_cast<cudaStream_t>(stream)};
  switch (vec) {
    case 1: return by_lanes<1>(lanes, lt, a);
    case 2: return by_lanes<2>(lanes, lt, a);
    default: return by_lanes<4>(lanes, lt, a);
  }
}

// Text of a launch error code, for the wrapper's exception.
extern "C" const char* embedding_bag_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
