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
//
// On the TPU the bag indices were scalar-prefetched so that a BlockSpec
// could stream each needed row into VMEM, one grid step a row.  Here a
// warp owns one (b, f) bag and loads its own indices: its lanes cover the
// D columns in strips of 32 (the last strip masked), each lane loops over
// the L lookups with an f32 accumulator in a register and writes its
// column once.  The F tables are passed as a device array of pointers with
// their row counts, so one launch covers a DLRM forward (RM2 would
// otherwise make 26 small launches a request).  Products, sums and the
// mean's division are single IEEE operations.
//
// What bounds it: bytes.  The indices (4 B each), the distinct rows the
// batch touches (D * 4 B each) and the output (D * 4 B a bag).  For
// DLRM-RM2 serve_bulk (B = 262,144, F = 26, L = 4, D = 64) that is at most
// 109 MB + 6.98 GB + 1.745 GB, 2.64 ms over 3.35 TB/s.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;   // bags per block

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

}  // namespace

// out[B, F, D]; tables and vocabs are device arrays of F entries; idx and
// w (null when unweighted) are [B, F, L].  Returns the launch's error code.
extern "C" int embedding_bag_launch(const void* tables, const void* vocabs,
                                    const int* idx, const float* w,
                                    float* out, long long n_bags, int F,
                                    int L, int D, int mean, void* stream) {
  if (n_bags <= 0 || F <= 0 || L < 0 || D <= 0)
    return cudaErrorInvalidValue;
  const long long blocks = (n_bags + WARPS - 1) / WARPS;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* const* t = static_cast<const float* const*>(tables);
  const long long* v = static_cast<const long long*>(vocabs);
  if (w)
    bag_kernel<true><<<(unsigned)blocks, WARPS * 32, 0, s>>>(
        t, v, idx, w, out, n_bags, F, L, D, mean);
  else
    bag_kernel<false><<<(unsigned)blocks, WARPS * 32, 0, s>>>(
        t, v, idx, w, out, n_bags, F, L, D, mean);
  return cudaGetLastError();
}

// Text of a launch error code, for the wrapper's exception.
extern "C" const char* embedding_bag_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
