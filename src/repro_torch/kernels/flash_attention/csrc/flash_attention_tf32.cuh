// Hopper tensor-core flash-attention forward for f32, as 3xTF32 on wgmma,
// included by flash_attention.cu (which holds the C entry).
//
// What it computes is `_fa_kernel`'s function in f32 (see
// flash_attention.cu and ref.py::flash_attention_ref): q is scaled by
// 1/sqrt(dh) in f32, the scores are masked to NEG_INF where col > row (both
// counted from 0) and past Tk, the running max m, sum l and accumulator
// stay in f32, the output is acc / max(l, 1e-30) in f32, and query head h
// reads KV head h / G in place.
//
// The arithmetic.  The tensor cores multiply tf32 (1 + 10 bits), some 1e-3
// off f32: one TF32 product misses the 2e-5 x (|ref| + 1) limit that f32
// is held to.  So each operand x is split as hi = tf32(x) and lo =
// tf32(x - hi), both written out here (`cvt.rna.tf32.f32`, then the low 13
// bits masked to 0; x - hi is exact in f32), and each product is three
// tensor-core products summed in the f32 accumulator, the small ones first:
//
//   S  = Q_hi K_lo^T + Q_lo K_hi^T + Q_hi K_hi^T
//   O += P_lo V_hi   + P_hi V_lo   + P_hi V_hi
//
// (lo x lo, ~2^-22 of the product, is dropped), some 2^-21 of each term,
// as CUTLASS's OpMultiplyAddFastF32 does on mma.sync.  exp, max and the
// running sums stay in f32 on the CUDA cores.  ref.py::flash_attention_tf32x3
// is this arithmetic in plain PyTorch (tests/test_torch_flash_tf32.py).
//
// What bounds it on this card: operations.  4 dh flops a head and (row,
// col <= row) pair, three tensor-core products each: 68.7 Gflop at llama's
// heads and T = 4096, 0.4166 ms at 495 / 3 = 165 TFLOP/s (the rate at
// which this card reaches f32 accuracy), 1.026 ms at the CUDA cores' 67.
//
// The design: the bf16 kernel's (flash_attention_tc.cuh) -- TMA loads into
// a ring of STAGES slots with full and empty mbarriers, one producer
// warpgroup whose one thread issues them, consumer warpgroups of 64 query
// rows, the grid walking the query tiles from the last one down, the key
// loop stopping at the diagonal, only tiles that cross it or the ragged
// end masked -- with these changes, each answering a trouble of tf32:
//
//   * tf32 wgmma takes both operands K-major only (the transpose
//     immediates exist for f16 and bf16 alone).  Q K^T is K-major for
//     both (dh contiguous).  V is not: it has to reach shared memory as
//     V^T, keys contiguous.  A split pass before the kernel
//     (`split_k`, `split_vt`) writes K's hi and lo ([2B, Tk, Kh, dh]) and
//     V^T's hi and lo ([2B, Kh, dh, Tk8], Tk8 = Tk rounded up to 8, zeros
//     past Tk) to scratch that the wrapper allocates; the kernel loads
//     both by TMA as it loads Q.  Kh heads of K and V are read once and
//     written twice (at qwen3-1.7b's heads and T = 4096, 33.6 MB in and
//     67.1 MB out), not once a query tile.  Q is split in the kernel: the
//     TMA lands it raw in Q_lo's buffer and each consumer warpgroup splits
//     its 64 rows in place, elementwise (the swizzle does not matter),
//     scaled by 1/sqrt(dh) first.
//   * P from registers.  The f32 accumulator gives a thread, in each
//     8-column group of its rows, the columns 2t and 2t + 1 (t = lane %
//     4); the tf32 A fragment (m64k8) wants the columns t and t + 4.  So
//     the kernel reads the keys of each group of 8 in the order 0 2 4 6
//     1 3 5 7: the split pass writes V^T's columns in that order, and P's
//     A fragment of step j is then the accumulator's entries 4j, 4j + 2,
//     4j + 1, 4j + 3 as they lie, split into hi and lo in place: no
//     shuffle, no trip through shared memory.  The mask reads the keys'
//     own positions.
//   * Shared memory.  f32 tiles are twice bf16's and each operand needs
//     its lo tile too: Q 2 x BQ x dh x 4 bytes, a slot 4 x BK x dh x 4
//     (K hi, K lo, V^T hi, V^T lo).  dh <= 64: two consumer warpgroups
//     (BQ = 128), 64-key tiles, two slots: 196,608 bytes at dh 64.  dh =
//     128: one consumer warpgroup (BQ = 64), 32-key tiles, two slots:
//     196,608 bytes.  Cfg::SMEM is static_assert-ed under 232,448.
//   * Registers.  With three warpgroups (dh <= 64) ptxas holds the
//     consumers to the 168 registers they have at entry, whatever
//     setmaxnreg gives (PERF.md, the bf16 kernel's findings): O (dh / 2),
//     S (32) and P's hi and lo (64) fit at 64-key tiles.  At dh = 128 the
//     block is two warpgroups, up to 255 registers a thread, for O's 64
//     and the rest (ptxas takes 167).  chip_smoke.py's phase 12 fails on a
//     spill at dh 64 or 128.
//
// What it leaves: no overlap of a warpgroup's softmax with its own
// products (at dh <= 64 the other warpgroup fills the gap; at dh = 128
// there is none), the split pass's extra reads and writes of K and V, and
// the non-persistent grid of the bf16 kernel.
#pragma once

#include "hopper.cuh"

namespace fa_tf32 {

using namespace hopper;

constexpr float NEG_INF = -1e30f;   // `kernel.py:28`
constexpr float LOG2E = 1.4426950408889634f;

// the tiles of head width DH
template <int DH>
struct Cfg {
  static constexpr int WGS = DH == 128 ? 1 : 2;   // consumer warpgroups
  static constexpr int BQ = 64 * WGS;             // query rows a block
  static constexpr int BK = DH == 128 ? 32 : 64;  // keys a tile
  static constexpr int STAGES = 2;                // slots in the ring
  static constexpr int CONSUMERS = 128 * WGS;
  static constexpr int THREADS = CONSUMERS + 128; // + the producer
  // Q and K: rows of SW bytes (dh contiguous), CHUNKS chunks of COLS floats
  static constexpr int SW = DH * 4 >= 128 ? 128 : DH * 4;
  static constexpr int COLS = SW / 4;
  static constexpr int CHUNKS = DH / COLS;
  static constexpr int LAYOUT = layout_of(SW);
  // V^T: DH rows of 128 bytes (32 keys) a chunk, VCHUNKS chunks
  static constexpr int VCHUNKS = BK / 32;
  static constexpr int Q_BYTES = BQ * DH * 4;     // one of Q hi, Q lo
  static constexpr int T_BYTES = BK * DH * 4;     // one tile of a slot
  static constexpr int SLOT_BYTES = 4 * T_BYTES;  // K hi, K lo, V^T hi, lo
  static constexpr int BAR_OFF = 2 * Q_BYTES + STAGES * SLOT_BYTES;
  // + barriers, + slack to align the base to 1024 B (the 128 B swizzle's
  // repeat)
  static constexpr int SMEM = BAR_OFF + 64 + 1024;
  static_assert(SMEM <= 232448, "over the 227 KB a block may use");
  static_assert(BK % 32 == 0 && Q_BYTES % 1024 == 0 && T_BYTES % 1024 == 0,
                "tiles on 1024-byte boundaries");
};

// tf32(x), round to nearest (ties away), the low 13 bits 0
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;
}
// (hi, lo) of x: hi = tf32(x), lo = tf32(x - hi)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// ---- wgmma, tf32 (k = 8) ----
// S (64 x N, f32) (+)= A (64 x 8, shared) B (8 x N, shared), both K-major
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t a,
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}
// O (64 x N, f32) += A (64 x 8, registers) B (8 x N, shared, K-major)
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8],
                                             const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                             const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b,
                                         int scale_d) {
  if constexpr (N == 32) wgmma_ss_n32(d, a, b, scale_d);
  else wgmma_ss_n64(d, a, b, scale_d);
}
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t b) {
  if constexpr (N == 16) wgmma_rs_n16(d, a, b);
  else if constexpr (N == 32) wgmma_rs_n32(d, a, b);
  else if constexpr (N == 64) wgmma_rs_n64(d, a, b);
  else wgmma_rs_n128(d, a, b);
}

// ---- the split pass: K as [2B, Tk, Kh, dh] (hi, then lo), V as V^T ----

// x4 [n4] float4 -> hi [n4], lo [n4]
__global__ void split_k(const float4* __restrict__ x, float4* __restrict__ hi,
                        float4* __restrict__ lo, long long n4) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n4;
       i += (long long)gridDim.x * blockDim.x) {
    const float4 v = x[i];
    uint32_t h[4], l[4];
    split(v.x, h[0], l[0]);
    split(v.y, h[1], l[1]);
    split(v.z, h[2], l[2]);
    split(v.w, h[3], l[3]);
    hi[i] = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                        __uint_as_float(h[2]), __uint_as_float(h[3]));
    lo[i] = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                        __uint_as_float(l[2]), __uint_as_float(l[3]));
  }
}

// v [B, Tk, Kh, DH] -> hi, lo [B, Kh, DH, Tk8]: key c of each group of 8
// at column 8 (c / 8) + (c % 8) / 2 + 4 (c % 2), the order the P fragment
// reads; zeros for the keys in [Tk, Tk8).  A 32-key x 32-column tile a
// block of 32 x 8 threads, through shared memory; grid (B Kh, Tk8 / 32,
// DH / 32 rounded up).
template <int DH>
__global__ void split_vt(const float* __restrict__ v, float* __restrict__ hi,
                         float* __restrict__ lo, int Tk, int Kh, int Tk8) {
  __shared__ float tile[32][33];
  const int bk = blockIdx.x, b = bk / Kh, kh = bk % Kh;
  const int c0 = blockIdx.y * 32, d0 = blockIdx.z * 32;
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int r = ty; r < 32; r += 8) {
    const int c = c0 + r, d = d0 + tx;
    tile[r][tx] = c < Tk && d < DH
        ? v[((static_cast<long long>(b) * Tk + c) * Kh + kh) * DH + d] : 0.f;
  }
  __syncthreads();
  for (int r = ty; r < 32; r += 8) {
    const int d = d0 + r, c = c0 + tx;
    if (d >= DH || c >= Tk8) continue;
    uint32_t h, l;
    split(tile[tx][r], h, l);
    const long long at = (static_cast<long long>(bk) * DH + d) * Tk8
                         + (c & ~7) + ((c & 7) >> 1) + 4 * (c & 1);
    hi[at] = __uint_as_float(h);
    lo[at] = __uint_as_float(l);
  }
}

// ---- the attention kernel ----

// LSE: the instance that stores each row's log-sum-exp into lse; the
// serving instance (false) is the code without it, as in the bf16 kernel
template <int DH, bool LSE>
__global__ void __launch_bounds__(Cfg<DH>::THREADS, 1)
fa_fwd_tf32(const __grid_constant__ CUtensorMap tq,
            const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv, float* __restrict__ o,
            float* __restrict__ lse, int B, int Tq, int Tk, int H, int Kh,
            float scale, int causal) {
  using C = Cfg<DH>;
  constexpr int BQ = C::BQ, BK = C::BK, STAGES = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);   // base, as a pointer
  const uint32_t sQhi = base, sQlo = base + C::Q_BYTES;
  // a slot: K hi, K lo, V^T hi, V^T lo, T_BYTES each
  auto slot = [&](int s) { return base + 2 * C::Q_BYTES + s * C::SLOT_BYTES; };
  const uint32_t bar = base + C::BAR_OFF;   // full[STAGES], empty[STAGES], q
  auto full = [&](int s) { return bar + 8 * s; };
  auto empty = [&](int s) { return bar + 8 * (STAGES + s); };
  const uint32_t qbar = bar + 16 * STAGES;

  // block -> (query tile, head, batch), the last query tiles first
  const int n_qt = (Tq + BQ - 1) / BQ;
  const int hb = blockIdx.x % (H * B);
  const int h = hb % H, b = hb / H;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x / (H * B))) * BQ;
  const int kh = h / (H / Kh);
  const int q_last = min(q0 + BQ, Tq) - 1;
  const int k_end = causal ? min(Tk, q_last + 1) : Tk;
  const int n_kt = (k_end + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), C::CONSUMERS);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128,
                             0);
  if (wg == C::WGS) {
    // ---- producer warpgroup: one thread issues every load ----
    if constexpr (C::WGS > 1) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == C::CONSUMERS) {
      mbar_expect_tx(qbar, C::Q_BYTES);   // raw Q lands in Q lo's buffer
#pragma unroll
      for (int c = 0; c < C::CHUNKS; ++c)
        tma_load_4d(sQlo + c * BQ * C::SW, &tq, qbar, c * C::COLS, h, q0, b);
      for (int j = 0; j < n_kt; ++j) {
        const int s = j % STAGES, r = j / STAGES;
        if (r > 0) mbar_wait(empty(s), (r - 1) & 1);
        mbar_expect_tx(full(s), C::SLOT_BYTES);
        const uint32_t sl = slot(s);
#pragma unroll
        for (int c = 0; c < C::CHUNKS; ++c) {   // K hi at batch b, lo at b + B
          tma_load_4d(sl + c * BK * C::SW, &tk, full(s), c * C::COLS, kh,
                      j * BK, b);
          tma_load_4d(sl + C::T_BYTES + c * BK * C::SW, &tk, full(s),
                      c * C::COLS, kh, j * BK, b + B);
        }
#pragma unroll
        for (int c = 0; c < C::VCHUNKS; ++c) {  // V^T: 32 keys x DH rows
          tma_load_4d(sl + 2 * C::T_BYTES + c * DH * 128, &tv, full(s),
                      j * BK + 32 * c, 0, kh, b);
          tma_load_4d(sl + 3 * C::T_BYTES + c * DH * 128, &tv, full(s),
                      j * BK + 32 * c, 0, kh, b + B);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    if constexpr (C::WGS > 1) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int row0 = q0 + wg * 64 + (t / 32) * 16 + lane / 4;   // and row0 + 8
    const int cq = 2 * (lane % 4);     // first column of each 8-column block
    const int wg_row0 = q0 + wg * 64;
    constexpr uint32_t SBO = 8 * C::SW;     // Q, K: 8 rows of SW bytes
    constexpr uint32_t VSBO = 8 * 128;      // V^T: 8 rows of 128 bytes

    // split this warpgroup's 64 rows of Q, scaled, in place: lo where the
    // raw values landed, hi in Q hi's buffer (same offsets)
    mbar_wait(qbar, 0);
#pragma unroll
    for (int c = 0; c < C::CHUNKS; ++c) {
      const int off = c * BQ * C::SW + wg * 64 * C::SW;
#pragma unroll
      for (int i = t; i < 64 * C::SW / 16; i += 128) {
        float4* lo4 = reinterpret_cast<float4*>(gbase + C::Q_BYTES + off) + i;
        float4* hi4 = reinterpret_cast<float4*>(gbase + off) + i;
        const float4 x = *lo4;
        uint32_t hh[4], ll[4];
        split(__fmul_rn(x.x, scale), hh[0], ll[0]);   // no fma into the split
        split(__fmul_rn(x.y, scale), hh[1], ll[1]);
        split(__fmul_rn(x.z, scale), hh[2], ll[2]);
        split(__fmul_rn(x.w, scale), hh[3], ll[3]);
        *hi4 = make_float4(__uint_as_float(hh[0]), __uint_as_float(hh[1]),
                           __uint_as_float(hh[2]), __uint_as_float(hh[3]));
        *lo4 = make_float4(__uint_as_float(ll[0]), __uint_as_float(ll[1]),
                           __uint_as_float(ll[2]), __uint_as_float(ll[3]));
      }
    }
    // the generic writes, seen by wgmma's async proxy, then this
    // warpgroup's 128 threads meet (named barrier 1 + wg)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");

    float acc[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    const uint32_t qa_hi = sQhi + wg * 64 * C::SW;
    const uint32_t qa_lo = sQlo + wg * 64 * C::SW;

    for (int j = 0; j < n_kt; ++j) {
      const int s = j % STAGES, k0 = j * BK;
      mbar_wait(full(s), (j / STAGES) & 1);
      const uint32_t k_hi = slot(s), k_lo = k_hi + C::T_BYTES;
      const uint32_t v_hi = k_hi + 2 * C::T_BYTES, v_lo = k_hi + 3 * C::T_BYTES;

      // S = Q K^T over dh in steps of 8 (32 B of a row): chunk kk 8 / COLS
      float sc[BK / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 8; ++kk) {
        const uint32_t at = (kk * 8 % C::COLS) * 4;   // within the row
        const uint32_t qo = (kk * 8 / C::COLS) * BQ * C::SW + at;
        const uint32_t ko = (kk * 8 / C::COLS) * BK * C::SW + at;
        const uint64_t qh = make_desc(qa_hi + qo, 16, SBO, C::LAYOUT);
        const uint64_t kdh = make_desc(k_hi + ko, 16, SBO, C::LAYOUT);
        wgmma_ss<BK>(sc, qh, make_desc(k_lo + ko, 16, SBO, C::LAYOUT), kk > 0);
        wgmma_ss<BK>(sc, make_desc(qa_lo + qo, 16, SBO, C::LAYOUT), kdh, 1);
        wgmma_ss<BK>(sc, qh, kdh, 1);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(sc);

      // accumulator entry e: row row0 + 8 ((e / 2) % 2), key
      // k0 + 8 (e / 4) + cq + e % 2
      if ((causal && k0 + BK - 1 > wg_row0) || k0 + BK > Tk) {
#pragma unroll
        for (int e = 0; e < BK / 2; ++e) {
          const int row = row0 + 8 * ((e / 2) % 2);
          const int col = k0 + 8 * (e / 4) + cq + e % 2;
          if (col >= Tk || (causal && col > row)) sc[e] = NEG_INF;
        }
      }
      float corr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = m[i];
#pragma unroll
        for (int e = 2 * i; e < BK / 2; e += 4)
          mx = fmaxf(mx, fmaxf(sc[e], sc[e + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        corr[i] = exp2f((m[i] - mx) * LOG2E);
        m[i] = mx;
        const float ms = mx * LOG2E;
        float ps = 0.f;
#pragma unroll
        for (int e = 2 * i; e < BK / 2; e += 4) {
          sc[e] = exp2f(fmaf(sc[e], LOG2E, -ms));
          sc[e + 1] = exp2f(fmaf(sc[e + 1], LOG2E, -ms));
          ps += sc[e] + sc[e + 1];
        }
        l[i] = l[i] * corr[i] + ps;   // this thread's share of the row sum
      }
#pragma unroll
      for (int e = 0; e < DH / 2; ++e) acc[e] *= corr[(e / 2) % 2];

      // O += P V, 8 keys a step: P's hi and lo where the accumulator holds
      // p, the A fragment of step jj its entries 4jj, 4jj + 2, 4jj + 1,
      // 4jj + 3 (V^T's columns in the matching order)
      uint32_t ph[BK / 2], pl[BK / 2];
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) split(sc[e], ph[e], pl[e]);
      wgmma_fence();
#pragma unroll
      for (int jj = 0; jj < BK / 8; ++jj) {
        const uint32_t a_hi[4] = {ph[4 * jj], ph[4 * jj + 2], ph[4 * jj + 1],
                                  ph[4 * jj + 3]};
        const uint32_t a_lo[4] = {pl[4 * jj], pl[4 * jj + 2], pl[4 * jj + 1],
                                  pl[4 * jj + 3]};
        const uint32_t vo = (jj * 8 / 32) * DH * 128 + (jj * 8 % 32) * 4;
        const uint64_t vh = make_desc(v_hi + vo, 16, VSBO, 1);
        wgmma_rs<DH>(acc, a_lo, vh);
        wgmma_rs<DH>(acc, a_hi, make_desc(v_lo + vo, 16, VSBO, 1));
        wgmma_rs<DH>(acc, a_hi, vh);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(acc);
      mbar_arrive(empty(s));
    }

    // the row sums over the quad, then out = acc / max(l, 1e-30)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      const int row = row0 + 8 * i;
      if (row >= Tq) continue;
      const float den = fmaxf(l[i], 1e-30f);
      if constexpr (LSE) {
        // the row's log-sum-exp of the (pre-scaled) scores, for a backward
        if (cq == 0)
          lse[(static_cast<long long>(b) * H + h) * Tq + row] = m[i] + logf(den);
      }
      float* orow = o + ((static_cast<long long>(b) * Tq + row) * H + h) * DH + cq;
#pragma unroll
      for (int c8 = 0; c8 < DH / 8; ++c8)
        *reinterpret_cast<float2*>(orow + 8 * c8) = make_float2(
            __fdiv_rn(acc[4 * c8 + 2 * i], den),
            __fdiv_rn(acc[4 * c8 + 2 * i + 1], den));
    }
  }
}

// ---- host ----

// Scratch of the split pass in bytes: K hi and lo, V^T hi and lo.
inline long long scratch_bytes(int B, int Tk, int Kh, int dh) {
  const long long tk8 = (Tk + 7) / 8 * 8;
  return 4LL * 2 * B * Kh * dh * (Tk + tk8);
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           void* scratch, int B, int Tq, int Tk, int H, int Kh, float scale,
           int causal, cudaStream_t s) {
  using C = Cfg<DH>;
  const int Tk8 = (Tk + 7) / 8 * 8;
  const long long nk = static_cast<long long>(B) * Tk * Kh * DH;
  float* ks = static_cast<float*>(scratch);         // [2B, Tk, Kh, DH]
  float* vt = ks + 2 * nk;                           // [2B, Kh, DH, Tk8]
  const long long nv = static_cast<long long>(B) * Kh * DH * Tk8;
  if (static_cast<long long>(B) * Kh > 0x7fffffff || Tk8 / 32 + 1 > 65535)
    return cudaErrorInvalidValue;

  const long long k_blocks = (nk / 4 + 255) / 256;
  split_k<<<static_cast<unsigned>(k_blocks < 4096 ? k_blocks : 4096), 256, 0, s>>>(
      static_cast<const float4*>(k), reinterpret_cast<float4*>(ks),
      reinterpret_cast<float4*>(ks + nk), nk / 4);
  split_vt<DH><<<dim3(B * Kh, (Tk8 + 31) / 32, (DH + 31) / 32), dim3(32, 8),
                 0, s>>>(static_cast<const float*>(v), vt, vt + nv, Tk, Kh,
                         Tk8);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  CUtensorMap mq, mk, mv;
  const cuuint64_t c4 = 4;
  {   // q [B, Tq, H, DH], raw
    const cuuint64_t dims[4] = {DH, static_cast<cuuint64_t>(H),
                                static_cast<cuuint64_t>(Tq),
                                static_cast<cuuint64_t>(B)};
    const cuuint64_t strides[3] = {c4 * DH, c4 * H * DH, c4 * Tq * H * DH};
    const cuuint32_t box[4] = {C::COLS, 1, C::BQ, 1};
    int err = encode_4d(&mq, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, q, dims,
                        strides, box, swizzle_of(C::SW));
    if (err) return err;
  }
  {   // K hi, lo [2B, Tk, Kh, DH]
    const cuuint64_t dims[4] = {DH, static_cast<cuuint64_t>(Kh),
                                static_cast<cuuint64_t>(Tk),
                                static_cast<cuuint64_t>(2 * B)};
    const cuuint64_t strides[3] = {c4 * DH, c4 * Kh * DH, c4 * Tk * Kh * DH};
    const cuuint32_t box[4] = {C::COLS, 1, C::BK, 1};
    int err = encode_4d(&mk, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, ks, dims,
                        strides, box, swizzle_of(C::SW));
    if (err) return err;
  }
  {   // V^T hi, lo [2B, Kh, DH, Tk8]
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(Tk8), DH,
                                static_cast<cuuint64_t>(Kh),
                                static_cast<cuuint64_t>(2 * B)};
    const cuuint64_t strides[3] = {c4 * Tk8, c4 * DH * Tk8, c4 * Kh * DH * Tk8};
    const cuuint32_t box[4] = {32, DH, 1, 1};
    int err = encode_4d(&mv, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, vt, dims,
                        strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
    if (err) return err;
  }
  const long long blocks = static_cast<long long>((Tq + C::BQ - 1) / C::BQ) * H * B;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  auto kern = lse != nullptr ? fa_fwd_tf32<DH, true> : fa_fwd_tf32<DH, false>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           C::SMEM);
  if (e != cudaSuccess) return e;
  kern<<<static_cast<unsigned>(blocks), C::THREADS, C::SMEM, s>>>(
      mq, mk, mv, static_cast<float*>(o), lse, B, Tq, Tk, H, Kh, scale,
      causal);
  return cudaGetLastError();
}

}  // namespace fa_tf32
