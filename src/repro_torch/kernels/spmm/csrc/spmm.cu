// Scatter-SpMM: the segment sum of edge messages into destination rows,
// over edges sorted by destination (CSR).
//
// Replaces the TPU kernel `repro/kernels/spmm/kernel.py::scatter_spmm`
// (`_spmm_kernel`) together with the gather and per-edge scale of its
// wrapper `repro/kernels/spmm/ops.py::spmm_sorted_coo`.  Semantics are
// `jax.ops.segment_sum` (`repro/kernels/spmm/ref.py`): out[r] is the f32 sum
// of the messages of the edges whose destination is r; an empty row is 0; an
// edge whose destination lies outside [0, n_rows) is dropped.  The message
// of edge e is x[src[e]] * coeff[e] (`spmm_sorted_coo`), or row e of the
// message matrix when no src is given (`scatter_spmm`).  A source index is
// read as JAX reads `x[src]`: a negative one counts from the end, then it is
// clamped into [0, n_x), so the kernel never reads outside x.
//
// The TPU kernel turned the scatter into one-hot MXU matmuls over (row
// block, edge block) pairs.  Hopper has no use for that: this is a
// segmented reduction.  The wrapper hands in rowptr[n_rows + 1] (the first
// edge of each row, from a binary search of the sorted destinations, so an
// out-of-range destination falls outside every row), built once per graph;
// the kernel clamps each row's range into [0, n_edges), so a stale rowptr
// gives a wrong sum but never a read outside src, coeff or the messages.
// One warp owns one destination row, with no atomics, so every run gives
// the same bits; products and sums are single IEEE operations
// (`__fmul_rn`, `__fadd_rn`), so a message equals the plain version's and
// only the order of the sum differs.  Two shapes of warp, chosen by the
// wrapper from D (`ops.py::geometry`) and passed in as (lanes an edge,
// floats a lane load):
//
//   * wide, (32, 1), for D >= 32 (and any D, on request): the lanes cover
//     the D columns in strips of 32, the last strip masked; each lane
//     walks the row's edges one after the other with an f32 accumulator,
//     a broadcast load of src[e] before each 4-byte gather (the first
//     port's kernel, unchanged: at D = 512 it sits at 1.3x its byte
//     bound).
//   * narrow, (L, V) with L x V >= D and L < 32, for D < 32: the warp is
//     G = 32 / L edge groups of L lanes, lane l of group g holding columns
//     l V .. l V + V - 1 (float4 where D % 4 == 0 and x is 16-byte
//     aligned, else scalar).  The warp loads the row's src and coeff 32 at
//     a time, one coalesced streaming load each (`__ldcs`: evict-first, so
//     the index stream does not push x out of L2), and hands them out by
//     `__shfl_sync`; group g takes the row's edges g, g + G, g + 2G, ...,
//     so 32 / G gathers of each lane are issued before the first is added:
//     G edges, 32 / G deep, in flight a warp, where the wide shape had one.
//     The G partial sums, each in edge order, are folded by a fixed
//     xor-shuffle tree over the group index (offsets L, 2L, .. 16: pairs of
//     neighbouring groups first), so the bits are the same on every run.
//     `ref.py::spmm_ordered` is this order in plain PyTorch.
//
// Why narrow D needs it: at ogb_products' D = 16 the wide shape idles half
// its lanes (at D = 7, 25 of 32) and keeps one dependent gather a lane in
// flight, some 1.5 TB/s of sectors (2.602 ms on an H100 80GB HBM3 at
// 700 W, PERF.md).
//
// What bounds it: bytes.  Each input read once and each output written
// once: src and coeff (8 B an edge), rowptr (4 B a row), x, and out.  For
// GCN layer 1 on ogb_products (2,449,029 nodes, 61,859,140 edges, D = 16)
// that is 494.9 + 9.8 + 156.7 + 156.7 MB = 0.818 GB, 0.244 ms over
// 3.35 TB/s (the 2 flops an edge and column take 0.030 ms at 67 TFLOP/s).
// The gather of x[src] is random (x, 156.7 MB, is three times the L2), so
// each edge costs the 32-byte sectors its row touches: 2 at D = 16, 3.96
// GB in all, 1.18 ms at 3.35 TB/s with no L2 hits -- the gather floor,
// which `chip_smoke.py` prints beside the bound.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;   // rows per block
constexpr unsigned FULL = 0xffffffffu;

// x[src[e]] as JAX reads it: a negative index counts from the end, then
// the index is clamped into [0, n_x)
__device__ __forceinline__ long long source_row(int s, int n_x) {
  long long r = s;
  if (r < 0) r += n_x;
  return r < 0 ? 0 : (r >= n_x ? n_x - 1 : r);
}

// the wide shape: lanes over columns, one edge at a time
template <bool GATHER, bool SCALE>
__global__ void __launch_bounds__(WARPS * 32)
spmm_csr_kernel(const float* __restrict__ x, const int* __restrict__ src,
                const float* __restrict__ coeff,
                const int* __restrict__ rowptr, float* __restrict__ out,
                int n_rows, int n_x, int n_edges, int D) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= n_rows) return;
  const int lo = max(rowptr[row], 0), hi = min(rowptr[row + 1], n_edges);
  float* orow = out + row * D;
  for (int d = lane; d < D; d += 32) {
    float acc = 0.f;
#pragma unroll 4
    for (int e = lo; e < hi; ++e) {
      long long s = e;
      if (GATHER) s = source_row(src[e], n_x);
      float m = x[s * D + d];
      if (SCALE) m = __fmul_rn(m, coeff[e]);
      acc = __fadd_rn(acc, m);
    }
    orow[d] = acc;
  }
}

// the narrow shape: G = 32 / L edge groups of L lanes, V floats a lane
template <int L, int V, bool GATHER, bool SCALE>
__global__ void __launch_bounds__(WARPS * 32)
spmm_narrow_kernel(const float* __restrict__ x, const int* __restrict__ src,
                   const float* __restrict__ coeff,
                   const int* __restrict__ rowptr, float* __restrict__ out,
                   int n_rows, int n_x, int n_edges, int D) {
  constexpr int G = 32 / L;      // edge groups a warp
  constexpr int STEPS = 32 / G;  // a group's edges of one 32-edge batch
  static_assert(L * G == 32 && (V == 1 || V == 4), "geometry");
  const int lane = threadIdx.x & 31;
  const int g = lane / L, c0 = (lane % L) * V;   // group, first column
  const long long row = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= n_rows) return;                     // warp-uniform
  const int lo = max(rowptr[row], 0), hi = min(rowptr[row + 1], n_edges);
  const bool cols = c0 < D;      // V = 4 only where D % 4 == 0
  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.f;
  for (int e0 = lo; e0 < hi; e0 += 32) {
    // the batch's indices and weights, one coalesced streaming load each
    int s_l = 0;
    float c_l = 0.f;
    if (e0 + lane < hi) {
      if (GATHER) s_l = __ldcs(src + e0 + lane);
      if (SCALE) c_l = __ldcs(coeff + e0 + lane);
    }
    // every gather of the batch issued before the first add
    float m[STEPS][V], c[STEPS];
#pragma unroll
    for (int i = 0; i < STEPS; ++i) {
      const int k = i * G + g;                   // edge e0 + k
      const int s_k = __shfl_sync(FULL, s_l, k);
      c[i] = __shfl_sync(FULL, c_l, k);
      const long long r = GATHER ? source_row(s_k, n_x) : e0 + k;
#pragma unroll
      for (int v = 0; v < V; ++v) m[i][v] = 0.f;
      if (cols && e0 + k < hi) {
        if constexpr (V == 4) {
          const float4 t = *reinterpret_cast<const float4*>(x + r * D + c0);
          m[i][0] = t.x; m[i][1] = t.y; m[i][2] = t.z; m[i][3] = t.w;
        } else {
          m[i][0] = x[r * D + c0];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < STEPS; ++i)
      if (cols && e0 + i * G + g < hi)
#pragma unroll
        for (int v = 0; v < V; ++v)
          acc[v] = __fadd_rn(acc[v], SCALE ? __fmul_rn(m[i][v], c[i])
                                           : m[i][v]);
  }
  // fold the groups: neighbours first, a fixed tree
#pragma unroll
  for (int off = L; off < 32; off <<= 1)
#pragma unroll
    for (int v = 0; v < V; ++v)
      acc[v] = __fadd_rn(acc[v], __shfl_xor_sync(FULL, acc[v], off));
  if (g == 0 && cols) {
    float* o = out + row * D + c0;
    if constexpr (V == 4) {
      *reinterpret_cast<float4*>(o) = make_float4(acc[0], acc[1], acc[2],
                                                  acc[3]);
    } else {
      o[0] = acc[0];
    }
  }
}

template <bool GATHER, bool SCALE>
cudaError_t launch(int lanes, int vec, const float* x, const int* src,
                   const float* coeff, const int* rowptr, float* out,
                   int n_rows, int n_x, int n_edges, int D, cudaStream_t s) {
  const unsigned blocks = (unsigned)((n_rows + WARPS - 1) / WARPS);
#define SPMM_ARGS x, src, coeff, rowptr, out, n_rows, n_x, n_edges, D
#define SPMM_NARROW(L, V) \
  spmm_narrow_kernel<L, V, GATHER, SCALE><<<blocks, WARPS * 32, 0, s>>>(SPMM_ARGS)
  if (lanes == 32 && vec == 1) {
    spmm_csr_kernel<GATHER, SCALE><<<blocks, WARPS * 32, 0, s>>>(SPMM_ARGS);
  } else if (vec == 1) {
    switch (lanes) {
      case 1: SPMM_NARROW(1, 1); break;
      case 2: SPMM_NARROW(2, 1); break;
      case 4: SPMM_NARROW(4, 1); break;
      case 8: SPMM_NARROW(8, 1); break;
      case 16: SPMM_NARROW(16, 1); break;
      default: return cudaErrorInvalidValue;
    }
  } else {
    switch (lanes) {
      case 1: SPMM_NARROW(1, 4); break;
      case 2: SPMM_NARROW(2, 4); break;
      case 4: SPMM_NARROW(4, 4); break;
      case 8: SPMM_NARROW(8, 4); break;
      default: return cudaErrorInvalidValue;
    }
  }
#undef SPMM_NARROW
#undef SPMM_ARGS
  return cudaGetLastError();
}

}  // namespace

// out[n_rows, D] = the segment sums over n_edges edges.  With src, x is
// [n_x, D] and gathered (coeff, when given, scales each message); without
// it, x holds the n_edges messages and coeff must be null.  (lanes, vec)
// is the warp's shape: (32, 1) the wide one, for any D; a narrow one needs
// lanes one of 1, 2, 4, 8, 16 with lanes x vec >= D, and vec 1, or 4 with
// D % 4 == 0, x 16-byte aligned and lanes <= 8.  A shape the kernel is not
// built for is refused (cudaErrorInvalidValue).  Returns the launch's
// error code (0 on success).
extern "C" int spmm_csr_launch(const float* x, const int* src,
                               const float* coeff, const int* rowptr,
                               float* out, int n_rows, int n_x, int n_edges,
                               int D, int lanes, int vec, void* stream) {
  if (n_rows <= 0 || D <= 0 || n_edges < 0 || (src && n_x <= 0) ||
      (coeff && !src))
    return cudaErrorInvalidValue;
  const bool wide = lanes == 32 && vec == 1;
  if (!wide && (lanes * vec < D ||
                (vec == 4 && (D % 4 || reinterpret_cast<uintptr_t>(x) % 16))
                || (vec != 1 && vec != 4)))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (coeff)
    return launch<true, true>(lanes, vec, x, src, coeff, rowptr, out, n_rows,
                              n_x, n_edges, D, s);
  if (src)
    return launch<true, false>(lanes, vec, x, src, coeff, rowptr, out, n_rows,
                               n_x, n_edges, D, s);
  return launch<false, false>(lanes, vec, x, src, coeff, rowptr, out, n_rows,
                              n_x, n_edges, D, s);
}

// Text of a launch error code, for the wrapper's exception.
extern "C" const char* spmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
