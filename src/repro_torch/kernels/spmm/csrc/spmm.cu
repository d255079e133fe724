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
// One warp owns one
// destination row; its lanes cover the D columns in strips of 32, the last
// strip masked; each lane loops over the row's edges with an f32
// accumulator in a register, gathers and scales in the loop, and writes
// its column once.  No atomics: every run gives the same bits.  Products
// and sums are single IEEE operations (`__fmul_rn`, `__fadd_rn`), so a
// message equals the plain version's and only the order of the sum
// differs.
//
// What bounds it: bytes.  Each input read once and each output written
// once: src and coeff (8 B an edge), rowptr (4 B a row), x, and out.  For
// GCN layer 1 on ogb_products (2,449,029 nodes, 61,859,140 edges, D = 16)
// that is 494.9 + 9.8 + 156.7 + 156.7 MB = 0.818 GB, 0.244 ms over
// 3.35 TB/s (the 2 flops an edge and column take 0.030 ms at 67 TFLOP/s).
// The gather of x[src] is random: each edge costs at least one 32-byte
// sector of x per 8 columns, which is what this simple design pays.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;   // rows per block

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
      if (GATHER) {
        s = src[e];
        if (s < 0) s += n_x;
        s = s < 0 ? 0 : (s >= n_x ? n_x - 1 : s);
      }
      float m = x[s * D + d];
      if (SCALE) m = __fmul_rn(m, coeff[e]);
      acc = __fadd_rn(acc, m);
    }
    orow[d] = acc;
  }
}

}  // namespace

// out[n_rows, D] = the segment sums over n_edges edges.  With src, x is
// [n_x, D] and gathered (coeff, when given, scales each message); without
// it, x holds the n_edges messages and coeff must be null.  Returns the
// launch's error code (0 on success).
extern "C" int spmm_csr_launch(const float* x, const int* src,
                               const float* coeff, const int* rowptr,
                               float* out, int n_rows, int n_x, int n_edges,
                               int D, void* stream) {
  if (n_rows <= 0 || D <= 0 || n_edges < 0 || (src && n_x <= 0) ||
      (coeff && !src))
    return cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((n_rows + WARPS - 1) / WARPS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (coeff)
    spmm_csr_kernel<true, true><<<blocks, WARPS * 32, 0, s>>>(
        x, src, coeff, rowptr, out, n_rows, n_x, n_edges, D);
  else if (src)
    spmm_csr_kernel<true, false><<<blocks, WARPS * 32, 0, s>>>(
        x, src, coeff, rowptr, out, n_rows, n_x, n_edges, D);
  else
    spmm_csr_kernel<false, false><<<blocks, WARPS * 32, 0, s>>>(
        x, src, coeff, rowptr, out, n_rows, n_x, n_edges, D);
  return cudaGetLastError();
}

// Text of a launch error code, for the wrapper's exception.
extern "C" const char* spmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
