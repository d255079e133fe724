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
// the same bits), for `tools/bag_variants.py`.
//
// What bounds it: bytes.  The indices (4 B each), the distinct rows the
// batch touches (D * 4 B each) and the output (D * 4 B a bag).  For
// DLRM-RM2 serve_bulk (B = 262,144, F = 26, L = 4, D = 64; uniform
// indices) that is 109 MB + ~12.7M distinct rows (3.26 GB) + 1.745 GB,
// 1.528 ms over 3.35 TB/s.  The 15 fields whose tables exceed the L2 draw
// a row from memory at every lookup, repeats included, so the gather
// itself reads ~4.0 GB: with the indices and the output 6.03 GB, 1.80 ms
// (the gather floor `chip_smoke.py` prints beside the bound).
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
// zero table).  The wrapper sorts every lookup of the batch, all F fields
// at once, by a key: its table row plus the rows of the tables before it
// (a stable torch.sort, so a row's lookups stay in (b, l) order), and a
// dropped lookup (an index outside [-V, V)) the key `total`, past every
// row.  A warp takes 32 consecutive sorted lookups; each lookup that
// starts a run of one key (a row the batch touches) is the warp's, and the
// warp walks that run to its end, lanes over the row's columns (strips of
// 128, four a lane), summing the bag gradients gout[b, f] (÷ L for the
// mean, then × the lookup's weight) in the run's order from 0.f, and
// writes the row once.  No atomics: every run gives the same bits, and
// all F fields are one launch.  The rows no lookup touches stay as the
// wrapper zeroed them.  Bound: bytes (the sorted keys and positions, the
// bag gradients each touched row reads, the weights, and the dense
// gradients written whole, zeros included).
constexpr int BWD_COLS = 4;       // columns a lane in a strip of 128

__global__ void bag_bwd_kernel(const long long* __restrict__ keys,
                               const long long* __restrict__ pos,
                               const float* __restrict__ gout,
                               const float* __restrict__ w,
                               float* __restrict__ grad, long long n,
                               long long total, int F, int L, int D,
                               int mean) {
  const long long warp = (static_cast<long long>(blockIdx.x) * blockDim.x
                          + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  const long long i = warp * 32 + lane;
  const long long key = i < n ? keys[i] : total;
  const bool start = i < n && key < total && (i == 0 || keys[i - 1] != key);
  unsigned runs = __ballot_sync(FULL, start);
  const float fl = static_cast<float>(L);
  while (runs) {
    const int j = __ffs(runs) - 1;
    runs &= runs - 1;
    const long long s = warp * 32 + j;
    const long long r = __shfl_sync(FULL, key, j);
    for (int c0 = 0; c0 < D; c0 += 32 * BWD_COLS) {
      float acc[BWD_COLS];
#pragma unroll
      for (int u = 0; u < BWD_COLS; ++u) acc[u] = 0.f;
      for (long long e = s; e < n && keys[e] == r; ++e) {
        const long long p = pos[e];             // flat (b, f, l)
        const long long bf = p / L;             // b F + f
        const float* g = gout + bf * D;
        const float wt = w != nullptr ? w[p] : 1.f;
#pragma unroll
        for (int u = 0; u < BWD_COLS; ++u) {
          const int c = c0 + lane + 32 * u;
          if (c < D) {
            float t = g[c];
            if (mean) t = __fdiv_rn(t, fl);
            if (w != nullptr) t = __fmul_rn(t, wt);
            acc[u] = __fadd_rn(acc[u], t);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < BWD_COLS; ++u) {
        const int c = c0 + lane + 32 * u;
        if (c < D) grad[r * D + c] = acc[u];
      }
    }
  }
}

}  // namespace

// grad [total, D] (zeroed by the caller; the F tables' gradients one
// after the other) += the bags' gradients gout [B, F, D] at the n = B F L
// lookups: keys [n] (int64, sorted: the global row of each lookup, or
// total for a dropped one) and pos [n] (int64: its flat (b, f, l)
// position), w [B, F, L] or null.  One launch; returns its error code.
extern "C" int embedding_bag_bwd_launch(const long long* keys,
                                        const long long* pos,
                                        const float* gout, const float* w,
                                        float* grad, long long n,
                                        long long total, int F, int L, int D,
                                        int mean, void* stream) {
  if (n < 0 || total < 0 || F <= 0 || L <= 0 || D <= 0)
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const long long blocks = (n + 32 * WARPS - 1) / (32 * WARPS);
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  bag_bwd_kernel<<<static_cast<unsigned>(blocks), 32 * WARPS, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      keys, pos, gout, w, grad, n, total, F, L, D, mean);
  return cudaGetLastError();
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
