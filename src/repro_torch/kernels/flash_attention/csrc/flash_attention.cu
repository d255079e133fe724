// Causal GQA flash-attention forward: online softmax in f32, one block a
// (query tile, head, batch).  bf16 inputs go to the Hopper tensor-core
// kernel of flash_attention_tc.cuh (wgmma on TMA-staged K/V), f32 inputs
// to the 3xTF32 tensor-core kernel of flash_attention_tf32.cuh (each
// product as three TF32 wgmma products of split operands), both at every
// head width 16-128.  The CUDA-core f32 kernel below (the first port of
// this kernel) is built only with -DFA_CUDA_CORE_F32, then in place of
// the 3xTF32 one, for the A/B of tools/flash_spmm_variants.py: the
// wrapper never routes to it.
//
// Replaces the TPU kernel `repro/kernels/flash_attention/kernel.py::
// flash_attention_fwd` (`_fa_kernel`).  It computes what `_fa_kernel`
// computes: q, k and v are read in their [B, T, H, dh] / [B, T, Kh, dh]
// layouts and cast to f32, q is multiplied by scale = 1/sqrt(dh), the
// scores s = q k^T are masked to NEG_INF where col > row (row and col both
// counted from 0, `kernel.py:46-48`), the running max m, sum l and
// accumulator acc are kept in f32, and the output is acc / max(l, 1e-30)
// cast to q's dtype.  The KV head of query head h is h / G (G = H / Kh),
// read in place, never repeated.
//
// On the TPU the key tiles were the sequential third grid axis, carrying
// (m, l, acc) in VMEM scratch from one grid step to the next, and the
// tiles above the diagonal ran masked.  Here blocks run in parallel and in
// no order, so the key tiles are a loop inside the block, (m, l, acc) stay
// in registers for the whole loop, and the loop stops at the diagonal:
// tiles wholly above it are skipped (their masked terms add exactly 0).
// The blocks nearest the diagonal's far end have the most tiles, so the
// grid walks the query tiles from the last one down and the longest
// blocks start first.  Unlike the Pallas wrapper (which asserts T % 128 ==
// 0), the kernel masks the ragged edge: rows past Tq are not written, keys
// past Tk score NEG_INF and load as zero.
//
// The CUDA-core kernel (f32, the A/B variant): f32 FMAs.  A block of
// 256 threads holds a 64-row query tile in shared memory, transposed and
// pre-scaled; for each 64-key tile it stages K (transposed) and V in
// shared memory, each thread computes a 4 x 4 patch of the scores from
// float4 reads, the row max is reduced over the 16 threads that share the
// rows by warp shuffles, the probabilities P go back through shared memory
// (over the K tile), and each thread accumulates a 4 x dh/16 patch of P V.
// The row sums stay per-thread partials (every thread of a row scales by
// the same correction) and are reduced once at the end.
//
// What bounds it on this card: operations.  A causal forward needs
// 4 B H dh T(T+1)/2 flops against 2 B T (H + Kh) dh elements moved (q, k,
// v read once, o written once); for llama3.2-1b at T = 4096 that is 68.7
// Gflop against 83.9 MB in f32: 0.4166 ms at 165 TFLOP/s (three TF32
// tensor-core products, the best rate at f32 accuracy here), 1.03 ms at
// the CUDA cores' 67, 0.025 ms for the bytes at 3.35 TB/s.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdio.h>

#include "flash_attention_tc.cuh"
#include "flash_attention_tf32.cuh"

namespace {

constexpr int BQ = 64;          // query rows a block
constexpr int BK = 64;          // keys a tile
constexpr int THREADS = 256;    // 16 x 16: ty owns 4 rows, tx 4 keys / dh/16 cols
constexpr int LD = BQ + 4;      // padded row of the transposed tiles (floats)
constexpr float NEG_INF = -1e30f;   // `kernel.py:28`

template <int DH>
constexpr int smem_floats() {
  // qT [DH][LD], kT [max(DH, BK)][LD] (K^T, then P^T), vs [BK][DH]
  return DH * LD + (DH > BK ? DH : BK) * LD + BK * DH;
}

template <int DH>
__global__ void __launch_bounds__(THREADS)
fa_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int Tq, int Tk,
              int H, int Kh, float scale, int causal) {
  constexpr int DV = DH / 16;   // output columns a thread
  extern __shared__ float4 smem4[];
  float* qT = reinterpret_cast<float*>(smem4);
  float* kT = qT + DH * LD;
  float* vs = kT + (DH > BK ? DH : BK) * LD;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // longest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / Kh);
  const long long q_stride = (long long)H * DH;       // between rows t
  const long long kv_stride = (long long)Kh * DH;
  const float* qb = q + ((long long)b * Tq * H + h) * DH;
  const float* kb = k + ((long long)b * Tk * Kh + kh) * DH;
  const float* vb = v + ((long long)b * Tk * Kh + kh) * DH;

  for (int e = tid; e < BQ * DH; e += THREADS) {
    const int r = e / DH, d = e % DH;
    qT[d * LD + r] = q0 + r < Tq
        ? qb[(long long)(q0 + r) * q_stride + d] * scale : 0.f;
  }

  float m[4], l[4], acc[4][DV];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DV; ++j) acc[i][j] = 0.f;
  }
  const int q_last = min(q0 + BQ, Tq) - 1;
  const int k_end = causal ? min(Tk, q_last + 1) : Tk;

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();   // Q staged; the last tile's P^T and V reads done
    for (int e = tid; e < BK * DH; e += THREADS) {
      const int c = e / DH, d = e % DH;
      const bool in = k0 + c < Tk;
      const long long off = (long long)(k0 + c) * kv_stride + d;
      kT[d * LD + c] = in ? kb[off] : 0.f;
      vs[c * DH + d] = in ? vb[off] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&qT[d * LD + ty * 4]);
      const float4 c = *reinterpret_cast<const float4*>(&kT[d * LD + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx * 4 + j;
        if (col >= Tk || (causal && col > row)) s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off; off >>= 1)   // the 16 lanes sharing the rows
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        ps += s[i][j];
      }
      l[i] = l[i] * corr + ps;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DV; ++j) acc[i][j] *= corr;
    }

    __syncthreads();   // every thread has read its K^T columns
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&kT[(tx * 4 + j) * LD + ty * 4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float4 p4 = *reinterpret_cast<const float4*>(&kT[c * LD + ty * 4]);
      const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
      const float* vrow = &vs[c * DH + tx * DV];
      float vv[DV];
      if constexpr (DV % 4 == 0) {
#pragma unroll
        for (int j = 0; j < DV; j += 4) {
          const float4 t = *reinterpret_cast<const float4*>(vrow + j);
          vv[j] = t.x; vv[j + 1] = t.y; vv[j + 2] = t.z; vv[j + 3] = t.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < DV; ++j) vv[j] = vrow[j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DV; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float ls = l[i];
#pragma unroll
    for (int off = 8; off; off >>= 1)
      ls += __shfl_xor_sync(0xffffffffu, ls, off);
    const int row = q0 + ty * 4 + i;
    if (row >= Tq) continue;
    const float den = fmaxf(ls, 1e-30f);
    float* orow = o + (((long long)b * Tq + row) * H + h) * DH + tx * DV;
#pragma unroll
    for (int j = 0; j < DV; ++j) orow[j] = __fdiv_rn(acc[i][j], den);
  }
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Tq, int Tk, int H, int Kh, float scale,
                   int causal, cudaStream_t s) {
  constexpr int bytes = smem_floats<DH>() * 4;
  auto kern = fa_fwd_kernel<DH>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + BQ - 1) / BQ, H, B);
  kern<<<grid, THREADS, bytes, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Tq, Tk, H, Kh, scale,
      causal);
  return cudaGetLastError();
}

// the f32 kernel: 3xTF32 on the tensor cores (path 2), or with
// -DFA_CUDA_CORE_F32 the CUDA-core kernel (path 0)
#ifdef FA_CUDA_CORE_F32
constexpr int kF32Path = 0;
int launch_f32(int dh, const void* q, const void* k, const void* v, void* o,
               void*, int B, int Tq, int Tk, int H, int Kh, float scale,
               int causal, cudaStream_t s) {
  switch (dh) {
    case 16: return launch<16>(q, k, v, o, B, Tq, Tk, H, Kh, scale, causal, s);
    case 32: return launch<32>(q, k, v, o, B, Tq, Tk, H, Kh, scale, causal, s);
    case 64: return launch<64>(q, k, v, o, B, Tq, Tk, H, Kh, scale, causal, s);
    case 128: return launch<128>(q, k, v, o, B, Tq, Tk, H, Kh, scale, causal, s);
    default: return cudaErrorInvalidValue;
  }
}
#else
constexpr int kF32Path = 2;
int launch_f32(int dh, const void* q, const void* k, const void* v, void* o,
               void* scratch, int B, int Tq, int Tk, int H, int Kh,
               float scale, int causal, cudaStream_t s) {
  switch (dh) {
    case 16: return fa_tf32::launch<16>(q, k, v, o, scratch, B, Tq, Tk, H, Kh, scale, causal, s);
    case 32: return fa_tf32::launch<32>(q, k, v, o, scratch, B, Tq, Tk, H, Kh, scale, causal, s);
    case 64: return fa_tf32::launch<64>(q, k, v, o, scratch, B, Tq, Tk, H, Kh, scale, causal, s);
    case 128: return fa_tf32::launch<128>(q, k, v, o, scratch, B, Tq, Tk, H, Kh, scale, causal, s);
    default: return cudaErrorInvalidValue;
  }
}
#endif

int launch_bf16(int dh, const void* q, const void* k, const void* v, void* o,
                int B, int Tq, int Tk, int H, int Kh, float scale, int causal,
                cudaStream_t s) {
  switch (dh) {
    case 16: return fa_tc::launch<16>(q, k, v, o, B, Tq, Tk, H, Kh, scale, causal, s);
    case 32: return fa_tc::launch<32>(q, k, v, o, B, Tq, Tk, H, Kh, scale, causal, s);
    case 64: return fa_tc::launch<64>(q, k, v, o, B, Tq, Tk, H, Kh, scale, causal, s);
    case 128: return fa_tc::launch<128>(q, k, v, o, B, Tq, Tk, H, Kh, scale, causal, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Bytes of scratch the launch needs for these shapes (the f32 split
// pass's K and V^T hi and lo; 0 for bf16).
extern "C" long long flash_attention_scratch_bytes(int B, int Tk, int Kh,
                                                   int dh, int bf16) {
  return bf16 ? 0 : fa_tf32::scratch_bytes(B, Tk, Kh, dh);
}

// o [B, Tq, H, dh] = attention(q [B, Tq, H, dh], k, v [B, Tk, Kh, dh]),
// all contiguous, 16-byte aligned and of one dtype (bf16 != 0: bfloat16,
// else float32); dh one of 16, 32, 64, 128; scratch 16-byte aligned, of
// flash_attention_scratch_bytes.  Sets *path to the kernel it launches
// (1: tensor cores, bf16; 2: tensor cores, f32 as 3xTF32; 0: CUDA cores,
// f32, in the -DFA_CUDA_CORE_F32 build only) and returns the launch's
// error code: a cudaError_t, or a negative code of the tensor-map
// encoding (see flash_attention_error_string).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, void* scratch,
                                      int B, int Tq, int Tk, int H, int Kh,
                                      int dh, int bf16, float scale,
                                      int causal, void* stream, int* path) {
  if (B <= 0 || Tq <= 0 || Tk <= 0 || Kh <= 0 || H % Kh != 0 ||
      B > 65535 || H > 65535 || (!bf16 && !scratch))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  *path = bf16 ? 1 : kF32Path;
  return bf16 ? launch_bf16(dh, q, k, v, o, B, Tq, Tk, H, Kh, scale, causal, s)
              : launch_f32(dh, q, k, v, o, scratch, B, Tq, Tk, H, Kh, scale,
                           causal, s);
}

// Text of a launch error code, for the wrapper's exception.
extern "C" const char* flash_attention_error_string(int err) {
  static thread_local char buf[96];
  if (err == hopper::kNoEncoder)
    return "the CUDA driver offers no cuTensorMapEncodeTiled";
  if (err <= hopper::kEncodeFailed) {
    snprintf(buf, sizeof buf, "cuTensorMapEncodeTiled failed (CUresult %d)",
             hopper::kEncodeFailed - err);
    return buf;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
