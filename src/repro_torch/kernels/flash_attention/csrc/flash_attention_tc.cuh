// Hopper tensor-core flash-attention forward for bf16: wgmma on K/V tiles
// staged by TMA, included by flash_attention.cu (which holds the C entry).
//
// What it computes is `_fa_kernel`'s function (see flash_attention.cu): the
// scores q k^T are scaled by 1/sqrt(dh), masked to NEG_INF where col > row
// (both counted from 0, whatever Tq and Tk) and past Tk, the running max m
// and sum l stay in f32, the output is acc / max(l, 1e-30) in bf16, and the
// KV head of query head h is h / G, read in place.  P, which `_fa_kernel`
// keeps in f32, goes into the P V product as two bf16 terms, hi = bf16(p)
// and lo = bf16(p - hi), some 16 bits of p.  One bf16 P (up to 2^-8 of
// each term, the JAX model path's rounding) is not enough: the early rows
// of a long sequence average few keys and are many times the output's
// median, so their error lands far above the median in entries near 0
// (on an H100, 2.6-6.8x chip_smoke.py's bf16 limit at its T = 4096 and
// 32768 shapes; hi and lo 0.33-0.37x).
//
// What bounds it on this card: operations.  4 dh flops a head and (row,
// col <= row) pair against 2 (H + Kh) dh bf16 elements a position moved,
// some T / 2 flops a byte for a causal forward: at T = 32768 and llama's
// heads 4.40 Tflop, 4.45 ms at the tensor cores' 989 TFLOP/s against 0.05
// ms for the bytes at 3.35 TB/s.  So the products go to the tensor cores:
//
//   * a block of three warpgroups a (128-row query tile, head, batch):
//     warpgroups 0 and 1 consume, 64 query rows each; warpgroup 2 produces.
//     One thread of the producer issues the TMA loads (Q once, then K and V
//     tile by tile into a ring of STAGES slots with full/empty mbarriers),
//     and the producer gives its registers to the consumers (setmaxnreg).
//   * S = Q K^T by wgmma m64n128k16 with both operands in shared memory
//     (dh contiguous: K-major for both, no transpose).
//   * softmax in registers: each row of the accumulator lives on the 4
//     lanes of a quad, so the row max and sum are two shuffles; only the
//     tiles that cross the diagonal or the ragged end are masked, and the
//     key loop stops at the diagonal.
//   * O += P V by wgmma m64n{dh}k16 with P in registers (the accumulator's
//     layout is the A fragment's, so P is packed to bf16 where it is), hi
//     and lo one product each, and V from shared memory with the transpose
//     bit (dh contiguous is MN-major for B).
//   * tiles are loaded as 4-D boxes (dh chunk, 1 head, rows, 1 batch) of
//     the tensors as they lie, swizzled to the row width (128 B at dh 64,
//     two 128 B atoms a row at dh 128, 64 B at 32, 32 B at 16); rows past
//     T load as zeros and padded keys are masked.
//   * the grid walks query tiles from the last down, so the longest blocks
//     start first.
//
// What it leaves: the lo term makes the P V products twice the work, 1.5x
// the tensor cores' share; the softmax of a tile does not overlap a
// product inside its warpgroup (the other warpgroup's products fill that
// gap, unordered: no explicit ping-pong).  Overlapping it with the last
// tile's P V keeps the scores, P and O live at once, ~200 registers a
// thread, while ptxas holds the consumers' code to the 168 a thread has at
// entry: it spilled and ran slower.  The grid is not persistent, so each
// block pays its Q load and prologue; the tiles on the diagonal run whole
// and masked; each block loads its own K/V (the G query heads of a group
// meet in L2); the output is stored from registers, not through shared
// memory and TMA.
#pragma once

#include <cuda_bf16.h>

#include "hopper.cuh"

namespace fa_tc {

using namespace hopper;

constexpr int BQ = 128;          // query rows a block: two consumer warpgroups
constexpr int BK = 128;          // keys a tile
constexpr int STAGES = 2;        // K/V slots in the ring
constexpr int THREADS = 384;     // warpgroups 0, 1 consume; 2 produces
constexpr int CONSUMERS = 256;
static_assert(BQ == BK, "Q and K tiles share their chunk offsets");
constexpr float NEG_INF = -1e30f;   // `kernel.py:28`

// shared-memory geometry of head width DH: a tile is CHUNKS column chunks,
// each [rows][COLS] bf16 with rows of SW bytes, swizzled by TMA in SW-byte
// atoms (wgmma layout type LAYOUT)
template <int DH>
struct Geom {
  static constexpr int SW = DH * 2 >= 128 ? 128 : DH * 2;
  static constexpr int COLS = SW / 2;
  static constexpr int CHUNKS = DH / COLS;
  static constexpr int LAYOUT = layout_of(SW);
  static constexpr int Q_BYTES = BQ * DH * 2;
  static constexpr int KV_BYTES = BK * DH * 2;     // one of K, V a slot
  static constexpr int BAR_OFF = Q_BYTES + 2 * STAGES * KV_BYTES;
  // + barriers, + slack to align the base to 1024 B (the 128 B swizzle's
  // repeat)
  static constexpr int SMEM = BAR_OFF + 64 + 1024;
};

// S (64 x 128, f32) (+)= A (64 x 16, shared) B (16 x 128, shared), both K-major
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t b) {
  if constexpr (N == 16) wgmma_rs_n16(d, a, b);
  else if constexpr (N == 32) wgmma_rs_n32(d, a, b);
  else if constexpr (N == 64) wgmma_rs_n64(d, a, b);
  else wgmma_rs_n128(d, a, b);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// LSE: the instance that stores each row's log-sum-exp into lse (the
// autograd forward); the serving instance (false) is the code without it
template <int DH, bool LSE>
__global__ void __launch_bounds__(THREADS, 1)
fa_fwd_tc(const __grid_constant__ CUtensorMap tq,
          const __grid_constant__ CUtensorMap tk,
          const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
          float* __restrict__ lse, int B, int Tq, int Tk, int H, int Kh,
          float scale_log2e, int causal) {
  using G = Geom<DH>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t bar = base + G::BAR_OFF;   // full[STAGES], empty[STAGES], q
  auto full = [&](int s) { return bar + 8 * s; };
  auto empty = [&](int s) { return bar + 8 * (STAGES + s); };
  const uint32_t qbar = bar + 16 * STAGES;
  auto sK = [&](int s) { return base + G::Q_BYTES + s * 2 * G::KV_BYTES; };
  auto sV = [&](int s) { return sK(s) + G::KV_BYTES; };

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
      mbar_init(empty(s), CONSUMERS);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup, made warp-uniform for the compiler by a shuffle from
  // lane 0, as CUTLASS's warp-specialised kernels take it
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128,
                             0);
  if (wg == CONSUMERS / 128) {
    // ---- producer warpgroup: one thread issues every load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == CONSUMERS) {
      mbar_expect_tx(qbar, G::Q_BYTES);
#pragma unroll
      for (int c = 0; c < G::CHUNKS; ++c)
        tma_load_4d(sQ + c * BQ * G::SW, &tq, qbar, c * G::COLS, h, q0, b);
      for (int j = 0; j < n_kt; ++j) {
        const int s = j % STAGES, r = j / STAGES;
        if (r > 0) mbar_wait(empty(s), (r - 1) & 1);
        mbar_expect_tx(full(s), 2 * G::KV_BYTES);
#pragma unroll
        for (int c = 0; c < G::CHUNKS; ++c) {
          tma_load_4d(sK(s) + c * BK * G::SW, &tk, full(s), c * G::COLS, kh,
                      j * BK, b);
          tma_load_4d(sV(s) + c * BK * G::SW, &tv, full(s), c * G::COLS, kh,
                      j * BK, b);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int row0 = q0 + wg * 64 + (t / 32) * 16 + lane / 4;   // and row0 + 8
    const int cq = 2 * (lane % 4);     // first column of each 8-column block
    const int wg_row0 = q0 + wg * 64;
    constexpr uint32_t SBO = 8 * G::SW;            // 8 rows of SW bytes
    constexpr uint32_t V_LBO = BK * G::SW;         // between column chunks
    // P V steps a wgmma fence: all 8 at once is fastest, but with the f32
    // scores, hi and lo all live ptxas spills at dh 32 and 128 (the
    // consumers' code is held to the 168 registers a thread has at entry,
    // whatever setmaxnreg gives them); one step a fence lets the scores
    // die as they go and costs 2-3% at dh 128, 16-19% at dh 64 (H100,
    // tools/flash_tc_variants.py)
    // (the lse instance at dh 64 spills 8 bytes at 8 steps a fence and
    // none at 4, on an H100: it takes 4)
    constexpr int FENCE_STEPS = DH == 32 || DH == 128 ? 1
                                : LSE && DH == 64 ? 4 : BK / 16;

    float acc[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    const uint32_t qa = sQ + wg * 64 * G::SW;

    mbar_wait(qbar, 0);
    for (int j = 0; j < n_kt; ++j) {
      const int s = j % STAGES, k0 = j * BK;
      mbar_wait(full(s), (j / STAGES) & 1);

      // S = Q K^T over dh in steps of 16: chunk kk*16 / COLS, 32 B a step
      float sc[BK / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const uint32_t off = (kk * 16 / G::COLS) * BQ * G::SW
                             + (kk * 16 % G::COLS) * 2;
        wgmma_ss_n128(sc, make_desc(qa + off, 16, SBO, G::LAYOUT),
                      make_desc(sK(s) + off, 16, SBO, G::LAYOUT), kk > 0);
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
        corr[i] = ex2((m[i] - mx) * scale_log2e);
        m[i] = mx;
        const float ms = mx * scale_log2e;
        float ps = 0.f;
#pragma unroll
        for (int e = 2 * i; e < BK / 2; e += 4) {
          sc[e] = ex2(fmaf(sc[e], scale_log2e, -ms));
          sc[e + 1] = ex2(fmaf(sc[e + 1], scale_log2e, -ms));
          ps += sc[e] + sc[e + 1];
        }
        l[i] = l[i] * corr[i] + ps;   // this thread's share of the row sum
      }
#pragma unroll
      for (int e = 0; e < DH / 2; ++e) acc[e] *= corr[(e / 2) % 2];

      // O += P V, 16 keys a step: P's entries 8 kk .. 8 kk + 7 of the
      // accumulator, two to a register, are the step's A fragment, as hi
      // and lo; V's 16 rows of SW bytes.  The fragments of FENCE_STEPS
      // steps are made, then fenced (their registers were just written),
      // then multiplied.
#pragma unroll
      for (int kf = 0; kf < BK / 16; kf += FENCE_STEPS) {
        uint32_t hi[FENCE_STEPS][4], lo[FENCE_STEPS][4];
#pragma unroll
        for (int u = 0; u < FENCE_STEPS; ++u)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int e = 8 * (kf + u) + 2 * r;
            const __nv_bfloat162 h2 = __floats2bfloat162_rn(sc[e], sc[e + 1]);
            hi[u][r] = *reinterpret_cast<const uint32_t*>(&h2);
            lo[u][r] = pack_bf16(sc[e] - __low2float(h2),
                                 sc[e + 1] - __high2float(h2));
          }
        wgmma_fence();
#pragma unroll
        for (int u = 0; u < FENCE_STEPS; ++u) {
          const uint64_t dv = make_desc(sV(s) + (kf + u) * 16 * G::SW, V_LBO,
                                        SBO, G::LAYOUT);
          wgmma_rs<DH>(acc, hi[u], dv);
          wgmma_rs<DH>(acc, lo[u], dv);
        }
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
      __nv_bfloat16* orow = o + ((static_cast<long long>(b) * Tq + row) * H + h) * DH + cq;
#pragma unroll
      for (int c8 = 0; c8 < DH / 8; ++c8)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * c8) = __floats2bfloat162_rn(
            __fdiv_rn(acc[4 * c8 + 2 * i], den),
            __fdiv_rn(acc[4 * c8 + 2 * i + 1], den));
    }
    if constexpr (LSE) {
      // each row's log-sum-exp of the scaled scores, for the backward,
      // once the accumulator is stored (its registers free: at dh 64 a
      // store beside the output's spilled)
      if (cq == 0) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = row0 + 8 * i;
          if (row < Tq)
            lse[(static_cast<long long>(b) * H + h) * Tq + row] =
                (m[i] * scale_log2e + __log2f(fmaxf(l[i], 1e-30f)))
                * 0.6931471805599453f;
        }
      }
    }
  }
}

// ---- host: tensor maps and the launch ----

// A map over x [B, T, heads, DH] bf16 as it lies (innermost first: DH,
// heads, T, B), boxes of (COLS, 1, rows, 1) with the swizzle of the row
// width; rows past T are filled with zeros.
template <int DH>
int encode(CUtensorMap* map, const void* x, int B, int T, int heads, int rows) {
  using G = Geom<DH>;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(DH),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(DH) * 2,
                                 static_cast<cuuint64_t>(heads) * DH * 2,
                                 static_cast<cuuint64_t>(T) * heads * DH * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(G::COLS), 1,
                             static_cast<cuuint32_t>(rows), 1};
  return encode_4d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, dims, strides,
                   box, swizzle_of(G::SW));
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int Tq, int Tk, int H, int Kh, float scale, int causal,
           cudaStream_t s) {
  CUtensorMap mq, mk, mv;
  int err = encode<DH>(&mq, q, B, Tq, H, BQ);
  if (!err) err = encode<DH>(&mk, k, B, Tk, Kh, BK);
  if (!err) err = encode<DH>(&mv, v, B, Tk, Kh, BK);
  if (err) return err;
  const long long blocks = static_cast<long long>((Tq + BQ - 1) / BQ) * H * B;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  auto kern = lse != nullptr ? fa_fwd_tc<DH, true> : fa_fwd_tc<DH, false>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Geom<DH>::SMEM);
  if (e != cudaSuccess) return e;
  kern<<<static_cast<unsigned>(blocks), THREADS, Geom<DH>::SMEM, s>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), lse, B, Tq, Tk, H, Kh,
      scale * 1.4426950408889634f, causal);
  return cudaGetLastError();
}

}  // namespace fa_tc
