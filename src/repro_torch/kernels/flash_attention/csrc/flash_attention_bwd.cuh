// Causal GQA flash-attention backward for bf16, included by
// flash_attention.cu (which holds the C entry).
//
// Replaces no TPU kernel: the JAX package has no Pallas backward and
// trains through `flash_attention_xla` under XLA's autodiff
// (`repro/models/transformer.py`).  It is the gradient of the forward
// kernels' function (`_fa_kernel`'s: scores q k^T scaled by 1/sqrt(dh),
// masked where col > row, both counted from 0, softmax in f32), so that
// the port's LM trains through the kernel it serves with.  A plain
// backward would hold the [B, H, T, T] f32 probabilities of a layer: 2.1
// GB at llama3.2-1b's heads and T = 4096 with B = 1.
//
// It takes q, k, v, the forward's output o and its per-row log-sum-exp
// lse [B, H, Tq] (f32, natural log of the scaled scores, stored by the
// forward kernels' epilogue) and dO, and follows FlashAttention-2's form,
// in three launches, so that no sum needs a float atomic and every run
// gives the same bits:
//
//   * fa_bwd_delta: delta [B, H, Tq] = rowsum(dO o) in f32, a thread a row.
//   * fa_bwd_dkdv: a block of four warps a (64-key tile, KV head, batch).
//     For each of the G query heads of the KV head, and each query tile
//     at or after the key tile, it recomputes S^T = K Q^T, P^T = exp(S^T
//     scale - lse), dP^T = V dO^T and dS^T = P^T (dP^T - delta) in f32
//     registers, and accumulates dV += P^T dO and dK += dS^T Q (times
//     scale at the end) in f32 registers, in one order: each of dK and dV
//     is written once, whole.
//   * fa_bwd_dq: a block of four warps a (64-query tile, head, batch) walks
//     the key tiles up to the diagonal: S, P, dP and dS again, and
//     dQ += dS K (times scale).
//
// The products run on the tensor cores as mma.sync m16n8k16 (bf16 in, f32
// accumulate), each warp 16 rows of its block's tile.  Operands lie in
// shared memory with their reduction dimension contiguous (rows padded by
// 8 bf16, so the fragment loads of a warp hit 32 distinct banks); the
// probabilities and dS never leave registers: the accumulator fragments
// of S^T (or S) are the A fragments of the next product.  P and dS go into
// those products as two bf16 terms, hi = bf16(x) and lo = bf16(x - hi),
// some 16 bits of x, as the forward's P V does: one bf16 P puts the
// gradients of the keys that few queries see many times their median off
// (chip_smoke.py phase 48 holds every entry to the forward's elementwise
// limit).  The transposed tiles that the products over the query (or key)
// dimension need (Q^T, dO^T; K^T) are written transposed into shared
// memory as they are loaded.
//
// What bounds it on this card: operations.  Per head and causal (row, col
// <= row) pair, 2 dh flops for each of the five products S, dP, dV, dK and
// dQ (S twice: both kernels recompute it), some 10 dh counted once, which
// at T = 4096 and llama's heads (32/8, dh 64) is 0.172 ms over 989 TFLOP/s
// for B = 1.  This first version is simple: no TMA, no wgmma, no
// pipelining of the loads with the products, and the hi/lo terms double
// the three products that take P or dS; so it is far from that bound.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace fa_bwd {

constexpr int ROWS = 64;          // a block's own tile: 4 warps x 16 rows
constexpr int THREADS = 128;
constexpr float LOG2E = 1.4426950408889634f;

template <int DH>
struct Geo {
  static constexpr int COLS = DH <= 64 ? 64 : 32;   // the loop's tile
  static constexpr int LDD = DH + 8;     // row stride of an [r][DH] tile
  static constexpr int LDC = COLS + 8;   // of a [DH][COLS] tile
};

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The A fragment of rows r0..r0+15, columns k0..k0+15 of a row-major tile
// with row stride ld (the reduction dimension contiguous).
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* s,
                                       int ld, int r0, int k0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* p = s + (r0 + g) * ld + k0 + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}

// The B fragment of columns n0..n0+7, reduction k0..k0+15 of B, from its
// transpose Bt [n][k] (k contiguous) with row stride ld.
__device__ __forceinline__ void load_b(uint32_t& b0, uint32_t& b1,
                                       const __nv_bfloat16* s, int ld, int n0,
                                       int k0, int lane) {
  const __nv_bfloat16* p = s + (n0 + (lane >> 2)) * ld + k0 + 2 * (lane & 3);
  b0 = ld32(p);
  b1 = ld32(p + 8);
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// hi and lo A fragments of k-step kk from accumulator fragments c (C of
// m16n8: c[n][0..1] row g, c[n][2..3] row g + 8; columns 2t, 2t + 1 of
// n-tile n): n-tiles 2kk and 2kk + 1 are the step's 16 columns.
template <int N>
__device__ __forceinline__ void split_a(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                        const float (&c)[N][4], int kk) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float* src = c[2 * kk + r / 2] + 2 * (r % 2);
    const __nv_bfloat162 h2 = __floats2bfloat162_rn(src[0], src[1]);
    hi[r] = *reinterpret_cast<const uint32_t*>(&h2);
    lo[r] = pack(src[0] - __low2float(h2), src[1] - __high2float(h2));
  }
}

// rows [t0, t0 + n) of x [B, T, heads, DH] (head `head`, batch `b`) into a
// row-major tile [n][ld] and, when tr is given, transposed into tr
// [DH][ldt]; rows past T are zeros
template <int DH>
__device__ __forceinline__ void load_rows(__nv_bfloat16* tile, int ld,
                                          __nv_bfloat16* tr, int ldt,
                                          const __nv_bfloat16* x, int b, int T,
                                          int heads, int head, int t0, int n) {
  constexpr int VEC = DH / 8;   // uint4 a row
  for (int e = threadIdx.x; e < n * VEC; e += THREADS) {
    const int r = e / VEC, c = (e % VEC) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (t0 + r < T)
      v = *reinterpret_cast<const uint4*>(
          x + ((static_cast<long long>(b) * T + t0 + r) * heads + head) * DH + c);
    *reinterpret_cast<uint4*>(tile + r * ld + c) = v;
    if (tr != nullptr) {
      const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
      for (int i = 0; i < 8; ++i) tr[(c + i) * ldt + r] = h[i];
    }
  }
}

// delta[b, h, t] = sum_d dO[b, t, h, d] o[b, t, h, d], in f32
template <int DH>
__global__ void fa_bwd_delta(const __nv_bfloat16* __restrict__ o,
                             const __nv_bfloat16* __restrict__ dout,
                             float* __restrict__ delta, int B, int T, int H) {
  const long long row = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (row >= static_cast<long long>(B) * T * H) return;
  const int h = row % H;
  const long long bt = row / H;              // b T + t
  const uint4* po = reinterpret_cast<const uint4*>(o + row * DH);
  const uint4* pd = reinterpret_cast<const uint4*>(dout + row * DH);
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < DH / 8; ++c) {
    const uint4 a = po[c], d = pd[c];
    const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&d);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(a2[i]), y = __bfloat1622float2(d2[i]);
      acc = fmaf(x.x, y.x, acc);
      acc = fmaf(x.y, y.y, acc);
    }
  }
  const long long b = bt / T, t = bt % T;
  delta[(b * H + h) * T + t] = acc;
}

template <int DH>
constexpr int dkdv_smem_bytes() {
  using G = Geo<DH>;
  return 2 * (2 * ROWS * G::LDD + 2 * G::COLS * G::LDD + 2 * DH * G::LDC)
         + 2 * G::COLS * 4;
}

template <int DH>
__global__ void __launch_bounds__(THREADS)
fa_bwd_dkdv(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
            const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
            int Tq, int Tk, int H, int Kh, float scale, int causal) {
  using G = Geo<DH>;
  constexpr int COLS = G::COLS, LDD = G::LDD, LDC = G::LDC;
  extern __shared__ uint4 bwd_smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(bwd_smem);
  __nv_bfloat16* sV = sK + ROWS * LDD;
  __nv_bfloat16* sQ = sV + ROWS * LDD;
  __nv_bfloat16* sdO = sQ + COLS * LDD;
  __nv_bfloat16* sQt = sdO + COLS * LDD;
  __nv_bfloat16* sdOt = sQt + DH * LDC;
  float* sLse = reinterpret_cast<float*>(sdOt + DH * LDC);
  float* sDelta = sLse + COLS;

  const int k0 = blockIdx.x * ROWS, kh = blockIdx.y, b = blockIdx.z;
  const int Gq = H / Kh;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp * 16;                      // the warp's first key row
  const float sl2 = scale * LOG2E;

  load_rows<DH>(sK, LDD, nullptr, 0, k, b, Tk, Kh, kh, k0, ROWS);
  load_rows<DH>(sV, LDD, nullptr, 0, v, b, Tk, Kh, kh, k0, ROWS);

  float acc_dk[DH / 8][4], acc_dv[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[n][e] = acc_dv[n][e] = 0.f;

  // the first query tile that holds a query at or after the tile's first key
  const int q_begin = causal ? (k0 / COLS) * COLS : 0;
  for (int hg = 0; hg < Gq; ++hg) {
    const int h = kh * Gq + hg;
    const float* lse_h = lse + (static_cast<long long>(b) * H + h) * Tq;
    const float* delta_h = delta + (static_cast<long long>(b) * H + h) * Tq;
    for (int q0 = q_begin; q0 < Tq; q0 += COLS) {
      __syncthreads();   // the last tile's reads are done
      load_rows<DH>(sQ, LDD, sQt, LDC, q, b, Tq, H, h, q0, COLS);
      load_rows<DH>(sdO, LDD, sdOt, LDC, dout, b, Tq, H, h, q0, COLS);
      for (int i = threadIdx.x; i < COLS; i += THREADS) {
        const bool in = q0 + i < Tq;
        sLse[i] = in ? lse_h[q0 + i] : 0.f;
        sDelta[i] = in ? delta_h[q0 + i] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: 16 keys x COLS queries a warp
      float st[COLS / 8][4], dpt[COLS / 8][4];
#pragma unroll
      for (int n = 0; n < COLS / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        uint32_t ak[4], av[4];
        load_a(ak, sK, LDD, wr, kk * 16, lane);
        load_a(av, sV, LDD, wr, kk * 16, lane);
#pragma unroll
        for (int n = 0; n < COLS / 8; ++n) {
          uint32_t b0, b1;
          load_b(b0, b1, sQ, LDD, n * 8, kk * 16, lane);
          mma16816(st[n], ak, b0, b1);
          load_b(b0, b1, sdO, LDD, n * 8, kk * 16, lane);
          mma16816(dpt[n], av, b0, b1);
        }
      }
      // P^T and dS^T: entry (n, e) is key k0 + wr + g + 8 (e / 2), query
      // q0 + 8 n + 2 t + e % 2
#pragma unroll
      for (int n = 0; n < COLS / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + wr + g + 8 * (e / 2);
          const int qc = 8 * n + 2 * t + (e % 2);
          const int qi = q0 + qc;
          const bool keep = qi < Tq && key < Tk && !(causal && key > qi);
          const float p = keep ? exp2f(st[n][e] * sl2 - sLse[qc] * LOG2E) : 0.f;
          st[n][e] = p;
          dpt[n][e] = p * (dpt[n][e] - sDelta[qc]);
        }
      // dV += P^T dO and dK += dS^T Q over the tile's queries
#pragma unroll
      for (int kk = 0; kk < COLS / 16; ++kk) {
        uint32_t ph[4], pl[4], sh[4], sl[4];
        split_a(ph, pl, st, kk);
        split_a(sh, sl, dpt, kk);
#pragma unroll
        for (int n = 0; n < DH / 8; ++n) {
          uint32_t b0, b1;
          load_b(b0, b1, sdOt, LDC, n * 8, kk * 16, lane);
          mma16816(acc_dv[n], ph, b0, b1);
          mma16816(acc_dv[n], pl, b0, b1);
          load_b(b0, b1, sQt, LDC, n * 8, kk * 16, lane);
          mma16816(acc_dk[n], sh, b0, b1);
          mma16816(acc_dk[n], sl, b0, b1);
        }
      }
    }
  }

  // dk, dv [B, Tk, Kh, DH]: row g (and g + 8) of the warp, columns 8 n + 2 t
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = k0 + wr + g + 8 * half;
    if (key >= Tk) continue;
    const long long off = ((static_cast<long long>(b) * Tk + key) * Kh + kh) * DH;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      const int c = 8 * n + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(dk + off + c) = __floats2bfloat162_rn(
          acc_dk[n][2 * half] * scale, acc_dk[n][2 * half + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + c) = __floats2bfloat162_rn(
          acc_dv[n][2 * half], acc_dv[n][2 * half + 1]);
    }
  }
}

template <int DH>
constexpr int dq_smem_bytes() {
  using G = Geo<DH>;
  return 2 * (2 * ROWS * G::LDD + 2 * G::COLS * G::LDD + DH * G::LDC);
}

template <int DH>
__global__ void __launch_bounds__(THREADS)
fa_bwd_dq(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
          const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          __nv_bfloat16* __restrict__ dq, int Tq, int Tk, int H, int Kh,
          float scale, int causal) {
  using G = Geo<DH>;
  constexpr int COLS = G::COLS, LDD = G::LDD, LDC = G::LDC;
  extern __shared__ uint4 bwd_smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(bwd_smem);
  __nv_bfloat16* sdO = sQ + ROWS * LDD;
  __nv_bfloat16* sK = sdO + ROWS * LDD;
  __nv_bfloat16* sV = sK + COLS * LDD;
  __nv_bfloat16* sKt = sV + COLS * LDD;

  // the query tiles from the last down: the longest blocks start first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * ROWS;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / Kh);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp * 16;
  const float sl2 = scale * LOG2E;

  load_rows<DH>(sQ, LDD, nullptr, 0, q, b, Tq, H, h, q0, ROWS);
  load_rows<DH>(sdO, LDD, nullptr, 0, dout, b, Tq, H, h, q0, ROWS);
  // this thread's two rows' lse (log2 units) and delta
  float lse2[2], dl[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = q0 + wr + g + 8 * half;
    const long long at = (static_cast<long long>(b) * H + h) * Tq + qi;
    lse2[half] = qi < Tq ? lse[at] * LOG2E : 0.f;
    dl[half] = qi < Tq ? delta[at] : 0.f;
  }

  float acc[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int q_last = min(q0 + ROWS, Tq) - 1;
  const int k_end = causal ? min(Tk, q_last + 1) : Tk;
  for (int c0 = 0; c0 < k_end; c0 += COLS) {
    __syncthreads();
    load_rows<DH>(sK, LDD, sKt, LDC, k, b, Tk, Kh, kh, c0, COLS);
    load_rows<DH>(sV, LDD, nullptr, 0, v, b, Tk, Kh, kh, c0, COLS);
    __syncthreads();

    float s[COLS / 8][4], dp[COLS / 8][4];
#pragma unroll
    for (int n = 0; n < COLS / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      uint32_t aq[4], ado[4];
      load_a(aq, sQ, LDD, wr, kk * 16, lane);
      load_a(ado, sdO, LDD, wr, kk * 16, lane);
#pragma unroll
      for (int n = 0; n < COLS / 8; ++n) {
        uint32_t b0, b1;
        load_b(b0, b1, sK, LDD, n * 8, kk * 16, lane);
        mma16816(s[n], aq, b0, b1);
        load_b(b0, b1, sV, LDD, n * 8, kk * 16, lane);
        mma16816(dp[n], ado, b0, b1);
      }
    }
    // entry (n, e): query q0 + wr + g + 8 (e / 2), key c0 + 8 n + 2 t + e % 2
#pragma unroll
    for (int n = 0; n < COLS / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = q0 + wr + g + 8 * (e / 2);
        const int key = c0 + 8 * n + 2 * t + (e % 2);
        const bool keep = qi < Tq && key < Tk && !(causal && key > qi);
        const float p = keep ? exp2f(s[n][e] * sl2 - lse2[e / 2]) : 0.f;
        dp[n][e] = p * (dp[n][e] - dl[e / 2]);
      }
    // dQ += dS K over the tile's keys
#pragma unroll
    for (int kk = 0; kk < COLS / 16; ++kk) {
      uint32_t sh[4], sl[4];
      split_a(sh, sl, dp, kk);
#pragma unroll
      for (int n = 0; n < DH / 8; ++n) {
        uint32_t b0, b1;
        load_b(b0, b1, sKt, LDC, n * 8, kk * 16, lane);
        mma16816(acc[n], sh, b0, b1);
        mma16816(acc[n], sl, b0, b1);
      }
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = q0 + wr + g + 8 * half;
    if (qi >= Tq) continue;
    const long long off = ((static_cast<long long>(b) * Tq + qi) * H + h) * DH;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dq + off + 8 * n + 2 * t) =
          __floats2bfloat162_rn(acc[n][2 * half] * scale,
                                acc[n][2 * half + 1] * scale);
  }
}

// Bytes of scratch the backward needs: delta [B, H, Tq] f32.
inline long long scratch_bytes(int B, int Tq, int H) {
  return 4LL * B * H * Tq;
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const float* lse, const void* dout, void* dq, void* dk,
                   void* dv, void* scratch, int B, int Tq, int Tk, int H,
                   int Kh, float scale, int causal, cudaStream_t s) {
  using bf = __nv_bfloat16;
  float* delta = static_cast<float*>(scratch);
  const long long rows = static_cast<long long>(B) * Tq * H;
  const long long blocks = (rows + 255) / 256;
  if (blocks > 0x7fffffff || B > 65535 || Kh > 65535 || H > 65535)
    return cudaErrorInvalidValue;
  fa_bwd_delta<DH><<<static_cast<unsigned>(blocks), 256, 0, s>>>(
      static_cast<const bf*>(o), static_cast<const bf*>(dout), delta, B, Tq, H);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  constexpr int kv_bytes = dkdv_smem_bytes<DH>();
  e = cudaFuncSetAttribute(fa_bwd_dkdv<DH>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, kv_bytes);
  if (e != cudaSuccess) return e;
  fa_bwd_dkdv<DH><<<dim3((Tk + ROWS - 1) / ROWS, Kh, B), THREADS, kv_bytes, s>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k),
      static_cast<const bf*>(v), static_cast<const bf*>(dout), lse, delta,
      static_cast<bf*>(dk), static_cast<bf*>(dv), Tq, Tk, H, Kh, scale, causal);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  constexpr int q_bytes = dq_smem_bytes<DH>();
  e = cudaFuncSetAttribute(fa_bwd_dq<DH>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, q_bytes);
  if (e != cudaSuccess) return e;
  fa_bwd_dq<DH><<<dim3((Tq + ROWS - 1) / ROWS, H, B), THREADS, q_bytes, s>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k),
      static_cast<const bf*>(v), static_cast<const bf*>(dout), lse, delta,
      static_cast<bf*>(dq), Tq, Tk, H, Kh, scale, causal);
  return cudaGetLastError();
}

}  // namespace fa_bwd
