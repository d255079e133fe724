// Causal GQA flash-attention backward for bf16 on Hopper: wgmma on tiles
// staged by TMA, included by flash_attention.cu (which holds the C entry).
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
// forward kernels' epilogue) and dO, and follows FlashAttention-2's two
// passes, in three launches, so that no sum needs a float atomic and every
// run gives the same bits:
//
//   * fa_bwd_prep: delta = rowsum(dO o) and lse log2(e), f32, a thread a
//     row, into scratch [B, H, Tp] each (Tp: Tq rounded up to 64 rows, the
//     rows past Tq zero), so that a 64-query slice of either is one aligned
//     bulk copy.
//   * fa_bwd_dkdv: a block of two warpgroups takes a pair of 128-key
//     tiles, i and n - 1 - i, one after the other: under the causal mask
//     tile i meets n - i query tiles, so each pair is the same work and
//     the grid (n / 2 pairs, KV head, batch) has no tail of long blocks.
//     For a key tile, K and V are loaded once (TMA), then, for each of the
//     G query heads of the KV head and each 64-query tile at or after the
//     key tile, Q, dO (4-D TMA boxes of the tensors as they lie, swizzled
//     to the row width, as the forward's) and the tile's lse and delta
//     (bulk copies) into a ring of STAGES slots with full/empty mbarriers.
//     Each warpgroup owns 64 keys: S^T = K Q^T and dP^T = V dO^T by wgmma
//     with both operands K-major in shared memory; P^T = exp2(S^T scale
//     log2 e - lse log2 e) and dS^T = P^T (dP^T - delta) in registers (the
//     masks only on the tiles that cross the diagonal or a ragged end,
//     from the row and column index); then dV += P^T dO and dK += dS^T Q
//     by wgmma with A from registers (the accumulator's layout is the A
//     fragment's) and B the same dO and Q tiles read MN-major under the
//     transpose bit: no transposed copy.  dK and dV stay in f32 registers
//     for the key tile and are written once (dK times the scale).
//   * fa_bwd_dq: a block of two warpgroups and a producer warp over
//     (128-query tile, head, batch), the longest first: Q and dO loaded
//     once, K and V by 64-key tiles through the ring; S = Q K^T and dP =
//     dO V^T K-major, dS in registers, then dQ += dS K with K's tile under
//     the transpose bit; dQ written once.
//
// P and dS go into the products that take them as two bf16 terms, hi =
// bf16(x) and lo = bf16(x - hi), some 16 bits of x, as the forward's P V
// does: one bf16 P puts the gradients of the keys that few queries see
// many times their median off (chip_smoke.py phase 48 holds every entry to
// the forward's elementwise limit).
//
// Registers.  An SM's register file is four partitions of 16,384, and
// warp w of a block runs on partition w % 4: a block of 9 to 12 warps puts
// three warps on a partition, and ptxas holds every thread to 168 unless
// setmaxnreg raises it.  The dK/dV consumer at dh 128 holds dK and dV (128
// registers) and S^T and dP^T or their hi and lo fragments (64) at once:
// with a 9th warp for a producer it spills at dh 64 and 128
// (tools/flash_bwd_variants.py, warps_9).  So fa_bwd_dkdv is 8 warps (up
// to 255 registers; 253 at dh 128) with no producer warp and no
// setmaxnreg: its thread 0 issues the loads, and after its warpgroup is
// done with step j it waits until the other one is too and refills that
// slot with step j + STAGES.
// fa_bwd_dq (156 registers at dh 128) keeps a producer warp.
//
// What bounds it on this card: operations.  Per head and causal (row, col
// <= row) pair, 2 dh flops for each of the five products S, dP, dV, dK and
// dQ, some 10 dh, which at T = 4096 and llama's heads (32/8, dh 64) is
// 0.174 ms over 989 TFLOP/s for B = 1.  What it leaves: the two passes
// compute S and dP twice (4 dh more) and the hi and lo terms double the
// three products that take P or dS (6 more), so the kernel does 20 dh,
// 2x the bound's operations; the diagonal tiles run whole and masked;
// within a warpgroup the products do not overlap the exponentials (the
// other warpgroup's products fill that gap, unordered: no explicit
// ping-pong).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "flash_attention_tc.cuh"
#include "hopper.cuh"

namespace fa_bwd {

using namespace hopper;
using fa_tc::ex2;
using fa_tc::pack_bf16;
using fa_tc::wgmma_rs;

constexpr int WG_ROWS = 64;       // a consumer warpgroup's rows; a TMA box
constexpr int TILE = 128;         // a block's own tile: two warpgroups
constexpr int BN = 64;            // the loop's tile: queries (dK/dV), keys (dQ)
constexpr int STAGES = 3;         // slots in the ring
constexpr int CONSUMERS = 256;
constexpr int DQ_THREADS = CONSUMERS + 32;   // fa_bwd_dq: + a producer warp
constexpr float LOG2E = 1.4426950408889634f;

// shared-memory geometry of head width DH: a tile is CHUNKS column chunks,
// each [rows][COLS] bf16 in rows of SW bytes, swizzled by TMA in SW-byte
// atoms (wgmma layout type LAYOUT), the forward's `Geom`
template <int DH>
struct Geo {
  static constexpr int SW = fa_tc::Geom<DH>::SW;
  static constexpr int COLS = fa_tc::Geom<DH>::COLS;
  static constexpr int CHUNKS = fa_tc::Geom<DH>::CHUNKS;
  static constexpr int LAYOUT = fa_tc::Geom<DH>::LAYOUT;
  static constexpr uint32_t SBO = 8 * SW;          // 8 rows of SW bytes
  static constexpr int BIG = TILE * DH * 2;        // a 128-row tile
  static constexpr int SMALL = BN * DH * 2;        // a 64-row tile
  static constexpr int RING = 2 * BIG;             // after the block's tiles
  static constexpr int VEC = RING + STAGES * 2 * SMALL;   // lse, delta slots
  static constexpr int BAR_OFF = VEC + STAGES * 2 * BN * 4;
  // + barriers (full, empty a slot; the tiles' full, empty), + slack to
  // align the base to 1024 B (the 128 B swizzle's repeat)
  static constexpr int SMEM = BAR_OFF + 8 * (2 * STAGES + 2) + 1024;
  // offset of k-step kk (16 columns of dh) in a K-major tile of `rows`
  __host__ __device__ static constexpr uint32_t k_off(int kk, int rows) {
    return (kk * 16 / COLS) * rows * SW + (kk * 16 % COLS) * 2;
  }
};

// D (64 x 64, f32) (+)= A (64 x 16, shared) B (16 x 64, shared), both K-major
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// `bytes` contiguous bytes of global memory into shared memory, completing
// on `bar` (both addresses and the size multiples of 16)
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// two floats at a 32-bit shared-memory address (the same loads through a
// generic pointer cost fa_bwd_dkdv<128> the registers it had left: it
// spills, tools/flash_bwd_variants.py)
__device__ __forceinline__ float2 lds2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y) : "r"(addr));
  return v;
}

// rows r0 .. r0 + ROWS - 1 of x (head `head`, batch b) into a tile of
// ROWS rows: a 64-row box a column chunk and 64 rows
template <int DH, int ROWS>
__device__ __forceinline__ void load_rows(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int head, int r0, int b) {
  using G = Geo<DH>;
#pragma unroll
  for (int c = 0; c < G::CHUNKS; ++c)
#pragma unroll
    for (int r = 0; r < ROWS; r += WG_ROWS)
      tma_load_4d(dst + (c * ROWS + r) * G::SW, map, bar, c * G::COLS, head,
                  r0 + r, b);
}

// hi and lo A fragments of the BN / 16 k-steps of an accumulator x
// (m64n{BN}: entries 8 kk .. 8 kk + 7 are k-step kk's, two to a register)
__device__ __forceinline__ void split_frags(uint32_t (&hi)[BN / 16][4],
                                            uint32_t (&lo)[BN / 16][4],
                                            const float (&x)[BN / 2]) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int e = 8 * kk + 2 * r;
      const __nv_bfloat162 h2 = __floats2bfloat162_rn(x[e], x[e + 1]);
      hi[kk][r] = *reinterpret_cast<const uint32_t*>(&h2);
      lo[kk][r] = pack_bf16(x[e] - __low2float(h2), x[e + 1] - __high2float(h2));
    }
}

// delta[b, h, t] = sum_d dO[b, t, h, d] o[b, t, h, d] and lse2[b, h, t] =
// lse[b, h, t] log2(e), f32, for t < Tp (0 past T)
template <int DH>
__global__ void fa_bwd_prep(const __nv_bfloat16* __restrict__ o,
                            const __nv_bfloat16* __restrict__ dout,
                            const float* __restrict__ lse,
                            float* __restrict__ lse2, float* __restrict__ delta,
                            int B, int T, int Tp, int H) {
  const long long row = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (row >= static_cast<long long>(B) * Tp * H) return;
  const int h = row % H;
  const long long bt = row / H;              // b Tp + t
  const int t = bt % Tp;
  const long long b = bt / Tp;
  float acc = 0.f, l2 = 0.f;
  if (t < T) {
    const long long src = ((b * T + t) * H + h) * DH;
    const uint4* po = reinterpret_cast<const uint4*>(o + src);
    const uint4* pd = reinterpret_cast<const uint4*>(dout + src);
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
    l2 = lse[(b * H + h) * T + t] * LOG2E;
  }
  const long long at = (b * H + h) * Tp + t;
  delta[at] = acc;
  lse2[at] = l2;
}

template <int DH>
__global__ void __launch_bounds__(CONSUMERS, 1)
fa_bwd_dkdv(const __grid_constant__ CUtensorMap tq,
            const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv,
            const __grid_constant__ CUtensorMap tdo,
            const float* __restrict__ lse2, const float* __restrict__ delta,
            __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
            int Tq, int Tk, int Tp, int H, int Kh, float scale, int causal) {
  using G = Geo<DH>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sK = base, sV = base + G::BIG;
  auto sQ = [&](int s) { return base + G::RING + s * 2 * G::SMALL; };
  auto sdO = [&](int s) { return sQ(s) + G::SMALL; };
  auto vec = [&](int s) { return base + G::VEC + s * 2 * BN * 4; };  // lse2, delta
  const uint32_t bar = base + G::BAR_OFF;
  auto full = [&](int s) { return bar + 8 * s; };
  auto empty = [&](int s) { return bar + 8 * (STAGES + s); };
  const uint32_t kv_full = bar + 16 * STAGES, kv_empty = kv_full + 8;

  // block -> (pair of key tiles i, n - 1 - i; KV head; batch)
  const int n_kt = (Tk + TILE - 1) / TILE, n_pairs = (n_kt + 1) / 2;
  const int pair = blockIdx.x % n_pairs;
  const int kh = (blockIdx.x / n_pairs) % Kh, b = blockIdx.x / n_pairs / Kh;
  const int n_items = n_kt - 1 - pair > pair ? 2 : 1;
  const int Gq = H / Kh;
  const int n_qt = (Tq + BN - 1) / BN;
  auto key_tile = [&](int item) { return item == 0 ? pair : n_kt - 1 - pair; };
  // the first query tile that holds a query at or after the key tile's
  // first key, and the tiles a query head meets
  auto q_begin = [&](int kt) { return causal ? kt * TILE / BN : 0; };
  auto n_q = [&](int kt) { return max(n_qt - q_begin(kt), 0); };
  // the block's steps, (item, query head, query tile) in order
  const int n0 = Gq * n_q(key_tile(0));
  const int n_steps = n0 + (n_items > 1 ? Gq * n_q(key_tile(1)) : 0);

  // thread 0 issues every load: K and V of an item on kv_full, and step
  // g's Q, dO, lse2 and delta into slot g % STAGES
  auto load_kv = [&](int item) {
    mbar_expect_tx(kv_full, 2 * G::BIG);
    load_rows<DH, TILE>(sK, &tk, kv_full, kh, key_tile(item) * TILE, b);
    load_rows<DH, TILE>(sV, &tv, kv_full, kh, key_tile(item) * TILE, b);
  };
  auto load_step = [&](int g) {
    const int item = g < n0 ? 0 : 1, kt = key_tile(item);
    const int gi = g - (item ? n0 : 0);
    const int h = kh * Gq + gi / n_q(kt), q0 = (q_begin(kt) + gi % n_q(kt)) * BN;
    const int s = g % STAGES;
    const long long at = (static_cast<long long>(b) * H + h) * Tp + q0;
    mbar_expect_tx(full(s), 2 * G::SMALL + 2 * BN * 4);
    load_rows<DH, BN>(sQ(s), &tq, full(s), h, q0, b);
    load_rows<DH, BN>(sdO(s), &tdo, full(s), h, q0, b);
    bulk_load(vec(s), lse2 + at, BN * 4, full(s));
    bulk_load(vec(s) + BN * 4, delta + at, BN * 4, full(s));
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONSUMERS);
    }
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, CONSUMERS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    load_kv(0);
    for (int g = 0; g < min(STAGES, n_steps); ++g) load_step(g);
  }
  __syncthreads();

  // ---- two warpgroups, 64 keys each ----
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  const int t = threadIdx.x % 128, lane = t % 32;
  const int cq = 2 * (lane % 4);     // first column of each 8-column block
  const float sl2 = scale * LOG2E;
  const uint32_t ka = sK + wg * WG_ROWS * G::SW, va = sV + wg * WG_ROWS * G::SW;
  float acc_dk[DH / 2], acc_dv[DH / 2];
  int j = 0;
  for (int item = 0; item < n_items; ++item) {
    const int kt = key_tile(item);
    const int wk0 = kt * TILE + wg * WG_ROWS;          // the warpgroup's keys
    const int key0 = wk0 + (t / 32) * 16 + lane / 4;   // and key0 + 8
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) acc_dk[i] = acc_dv[i] = 0.f;
    mbar_wait(kv_full, item & 1);
    for (int hg = 0; hg < Gq; ++hg) {
      for (int qt = q_begin(kt); qt < n_qt; ++qt, ++j) {
        const int s = j % STAGES, q0 = qt * BN;
        mbar_wait(full(s), (j / STAGES) & 1);
        // a tile wholly before the warpgroup's keys, or past Tk, adds 0
        if (!((causal && q0 + BN - 1 < wk0) || wk0 >= Tk)) {
          // S^T = K Q^T and dP^T = V dO^T over dh, 16 a step
          float st[BN / 2], dpt[BN / 2];
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < DH / 16; ++kk) {
            const uint32_t oa = G::k_off(kk, TILE), ob = G::k_off(kk, BN);
            wgmma_ss_n64(st, make_desc(ka + oa, 16, G::SBO, G::LAYOUT),
                         make_desc(sQ(s) + ob, 16, G::SBO, G::LAYOUT), kk > 0);
            wgmma_ss_n64(dpt, make_desc(va + oa, 16, G::SBO, G::LAYOUT),
                         make_desc(sdO(s) + ob, 16, G::SBO, G::LAYOUT), kk > 0);
          }
          wgmma_commit();
          wgmma_wait0();
          fence_regs(st);
          fence_regs(dpt);

          // entry e: key key0 + 8 ((e / 2) % 2), query q0 + 8 (e / 4) + cq + e % 2
          // (the lse2 and delta of the columns this thread holds: cq, cq + 1
          // of each 8-column block)
          const uint32_t vl = vec(s) + cq * 4;
          const bool edge = (causal && q0 < wk0 + WG_ROWS - 1) || q0 + BN > Tq;
#pragma unroll
          for (int c8 = 0; c8 < BN / 8; ++c8) {
            const float2 l2 = lds2(vl + 32 * c8), dl = lds2(vl + 4 * BN + 32 * c8);
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int e = 4 * c8 + u;
              float p = ex2(fmaf(st[e], sl2, -(u % 2 ? l2.y : l2.x)));
              if (edge) {
                const int key = key0 + 8 * (u / 2), qi = q0 + 8 * c8 + cq + u % 2;
                if (qi >= Tq || (causal && key > qi)) p = 0.f;
              }
              st[e] = p;
              dpt[e] = p * (dpt[e] - (u % 2 ? dl.y : dl.x));
            }
          }
          // dV += P^T dO and dK += dS^T Q over the tile's queries, 16 a
          // step: dO and Q MN-major (dh contiguous) under the transpose bit
          uint32_t ph[BN / 16][4], pl[BN / 16][4], sh[BN / 16][4], sl[BN / 16][4];
          split_frags(ph, pl, st);
          split_frags(sh, sl, dpt);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BN / 16; ++kk) {
            const uint64_t ddo = make_desc(sdO(s) + kk * 16 * G::SW, BN * G::SW,
                                           G::SBO, G::LAYOUT);
            wgmma_rs<DH>(acc_dv, ph[kk], ddo);
            wgmma_rs<DH>(acc_dv, pl[kk], ddo);
          }
#pragma unroll
          for (int kk = 0; kk < BN / 16; ++kk) {
            const uint64_t dq_ = make_desc(sQ(s) + kk * 16 * G::SW, BN * G::SW,
                                           G::SBO, G::LAYOUT);
            wgmma_rs<DH>(acc_dk, sh[kk], dq_);
            wgmma_rs<DH>(acc_dk, sl[kk], dq_);
          }
          wgmma_commit();
          wgmma_wait0();
          fence_regs(acc_dv);
          fence_regs(acc_dk);
        }
        mbar_arrive(empty(s));
        // the slot refilled once both warpgroups are done with it
        if (threadIdx.x == 0 && j + STAGES < n_steps) {
          mbar_wait(empty(s), (j / STAGES) & 1);
          load_step(j + STAGES);
        }
        __syncwarp();   // warp 0 whole again before its next wgmma
      }
    }
    mbar_arrive(kv_empty);   // K and V read for the last time
    if (threadIdx.x == 0 && item + 1 < n_items) {
      mbar_wait(kv_empty, item & 1);
      load_kv(item + 1);
    }
    __syncwarp();

    // dk, dv [B, Tk, Kh, DH]: rows key0 and key0 + 8, columns 8 c8 + cq
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = key0 + 8 * i;
      if (key >= Tk) continue;
      const long long off = ((static_cast<long long>(b) * Tk + key) * Kh + kh) * DH + cq;
#pragma unroll
      for (int c8 = 0; c8 < DH / 8; ++c8) {
        *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * c8) = __floats2bfloat162_rn(
            acc_dk[4 * c8 + 2 * i] * scale, acc_dk[4 * c8 + 2 * i + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * c8) = __floats2bfloat162_rn(
            acc_dv[4 * c8 + 2 * i], acc_dv[4 * c8 + 2 * i + 1]);
      }
    }
  }
}

template <int DH>
__global__ void __launch_bounds__(DQ_THREADS, 1)
fa_bwd_dq(const __grid_constant__ CUtensorMap tq,
          const __grid_constant__ CUtensorMap tk,
          const __grid_constant__ CUtensorMap tv,
          const __grid_constant__ CUtensorMap tdo,
          const float* __restrict__ lse2, const float* __restrict__ delta,
          __nv_bfloat16* __restrict__ dq, int B, int Tq, int Tk, int Tp,
          int H, int Kh, float scale, int causal) {
  using G = Geo<DH>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base, sdO = base + G::BIG;
  auto sK = [&](int s) { return base + G::RING + s * 2 * G::SMALL; };
  auto sV = [&](int s) { return sK(s) + G::SMALL; };
  const uint32_t bar = base + G::BAR_OFF;
  auto full = [&](int s) { return bar + 8 * s; };
  auto empty = [&](int s) { return bar + 8 * (STAGES + s); };
  const uint32_t qbar = bar + 16 * STAGES;

  // block -> (query tile, head, batch), the last query tiles first
  const int n_qt = (Tq + TILE - 1) / TILE;
  const int hb = blockIdx.x % (H * B);
  const int h = hb % H, b = hb / H;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x / (H * B))) * TILE;
  const int kh = h / (H / Kh);
  const int q_last = min(q0 + TILE, Tq) - 1;
  const int k_end = causal ? min(Tk, q_last + 1) : Tk;
  const int n_kt = (k_end + BN - 1) / BN;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONSUMERS);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (wg == CONSUMERS / 128) {
    // ---- producer warp: one thread issues every load ----
    if (threadIdx.x != CONSUMERS) return;
    mbar_expect_tx(qbar, 2 * G::BIG);
    load_rows<DH, TILE>(sQ, &tq, qbar, h, q0, b);
    load_rows<DH, TILE>(sdO, &tdo, qbar, h, q0, b);
    for (int j = 0; j < n_kt; ++j) {
      const int s = j % STAGES, r = j / STAGES;
      if (r > 0) mbar_wait(empty(s), (r - 1) & 1);
      mbar_expect_tx(full(s), 2 * G::SMALL);
      load_rows<DH, BN>(sK(s), &tk, full(s), kh, j * BN, b);
      load_rows<DH, BN>(sV(s), &tv, full(s), kh, j * BN, b);
    }
    return;
  }

  // ---- consumer warpgroups: 64 query rows each ----
  const int t = threadIdx.x % 128, lane = t % 32;
  const int wq0 = q0 + wg * WG_ROWS;
  const int row0 = wq0 + (t / 32) * 16 + lane / 4;   // and row0 + 8
  const int cq = 2 * (lane % 4);
  const float sl2 = scale * LOG2E;
  float l2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    const long long at = (static_cast<long long>(b) * H + h) * Tp + row;
    l2[i] = row < Tq ? lse2[at] : 0.f;
    dl[i] = row < Tq ? delta[at] : 0.f;
  }
  float acc[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
  const uint32_t qa = sQ + wg * WG_ROWS * G::SW, doa = sdO + wg * WG_ROWS * G::SW;

  mbar_wait(qbar, 0);
  for (int j = 0; j < n_kt; ++j) {
    const int s = j % STAGES, c0 = j * BN;
    mbar_wait(full(s), (j / STAGES) & 1);
    // a key tile wholly after the warpgroup's rows adds 0
    if (causal && c0 > wq0 + WG_ROWS - 1) {
      mbar_arrive(empty(s));
      continue;
    }
    // S = Q K^T and dP = dO V^T over dh, 16 a step
    float sc[BN / 2], dp[BN / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const uint32_t oa = G::k_off(kk, TILE), ob = G::k_off(kk, BN);
      wgmma_ss_n64(sc, make_desc(qa + oa, 16, G::SBO, G::LAYOUT),
                   make_desc(sK(s) + ob, 16, G::SBO, G::LAYOUT), kk > 0);
      wgmma_ss_n64(dp, make_desc(doa + oa, 16, G::SBO, G::LAYOUT),
                   make_desc(sV(s) + ob, 16, G::SBO, G::LAYOUT), kk > 0);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(sc);
    fence_regs(dp);

    // entry e: row row0 + 8 ((e / 2) % 2), key c0 + 8 (e / 4) + cq + e % 2
    const bool edge = (causal && c0 + BN - 1 > wq0) || c0 + BN > Tk;
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) {
      const int i = (e / 2) % 2;
      float p = ex2(fmaf(sc[e], sl2, -l2[i]));
      if (edge) {
        const int key = c0 + 8 * (e / 4) + cq + e % 2;
        if (key >= Tk || (causal && key > row0 + 8 * i)) p = 0.f;
      }
      dp[e] = p * (dp[e] - dl[i]);
    }
    // dQ += dS K over the tile's keys, K MN-major under the transpose bit
    uint32_t hi[BN / 16][4], lo[BN / 16][4];
    split_frags(hi, lo, dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint64_t dk_ = make_desc(sK(s) + kk * 16 * G::SW, BN * G::SW,
                                     G::SBO, G::LAYOUT);
      wgmma_rs<DH>(acc, hi[kk], dk_);
      wgmma_rs<DH>(acc, lo[kk], dk_);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(acc);
    mbar_arrive(empty(s));
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= Tq) continue;
    __nv_bfloat16* out = dq + ((static_cast<long long>(b) * Tq + row) * H + h) * DH + cq;
#pragma unroll
    for (int c8 = 0; c8 < DH / 8; ++c8)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * c8) = __floats2bfloat162_rn(
          acc[4 * c8 + 2 * i] * scale, acc[4 * c8 + 2 * i + 1] * scale);
  }
}

// Rows of the prep pass's scratch a (batch, head): Tq rounded up to 64.
inline int padded_rows(int Tq) { return (Tq + BN - 1) / BN * BN; }

// Bytes of scratch the backward needs: lse log2(e) and delta, [B, H, Tp]
// f32 each.
inline long long scratch_bytes(int B, int Tq, int H) {
  return 2LL * 4 * B * H * padded_rows(Tq);
}

// the three launches, each where `parts` has its bit
constexpr int kPrep = 1, kDkDv = 2, kDq = 4;

template <int DH>
int launch(const void* q, const void* k, const void* v, const void* o,
           const float* lse, const void* dout, void* dq, void* dk, void* dv,
           void* scratch, int B, int Tq, int Tk, int H, int Kh, float scale,
           int causal, int parts, cudaStream_t s) {
  using bf = __nv_bfloat16;
  using G = Geo<DH>;
  const int Tp = padded_rows(Tq);
  float* lse2 = static_cast<float*>(scratch);
  float* delta = lse2 + static_cast<long long>(B) * H * Tp;
  const long long rows = static_cast<long long>(B) * Tp * H;
  const long long prep_blocks = (rows + 255) / 256;
  const int n_kt = (Tk + TILE - 1) / TILE;
  const long long kv_blocks = static_cast<long long>((n_kt + 1) / 2) * Kh * B;
  const long long q_blocks = static_cast<long long>((Tq + TILE - 1) / TILE) * H * B;
  if (prep_blocks > 0x7fffffff || kv_blocks > 0x7fffffff || q_blocks > 0x7fffffff)
    return cudaErrorInvalidValue;
  if (parts & kPrep) {
    fa_bwd_prep<DH><<<static_cast<unsigned>(prep_blocks), 256, 0, s>>>(
        static_cast<const bf*>(o), static_cast<const bf*>(dout), lse, lse2,
        delta, B, Tq, Tp, H);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  CUtensorMap mq, mk, mv, mdo;
  int err = fa_tc::encode<DH>(&mq, q, B, Tq, H, WG_ROWS);
  if (!err) err = fa_tc::encode<DH>(&mk, k, B, Tk, Kh, WG_ROWS);
  if (!err) err = fa_tc::encode<DH>(&mv, v, B, Tk, Kh, WG_ROWS);
  if (!err) err = fa_tc::encode<DH>(&mdo, dout, B, Tq, H, WG_ROWS);
  if (err) return err;
  if (parts & kDkDv) {
    cudaError_t e = cudaFuncSetAttribute(
        fa_bwd_dkdv<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
    if (e != cudaSuccess) return e;
    fa_bwd_dkdv<DH><<<static_cast<unsigned>(kv_blocks), CONSUMERS, G::SMEM, s>>>(
        mq, mk, mv, mdo, lse2, delta, static_cast<bf*>(dk), static_cast<bf*>(dv),
        Tq, Tk, Tp, H, Kh, scale, causal);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  if (parts & kDq) {
    cudaError_t e = cudaFuncSetAttribute(
        fa_bwd_dq<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
    if (e != cudaSuccess) return e;
    fa_bwd_dq<DH><<<static_cast<unsigned>(q_blocks), DQ_THREADS, G::SMEM, s>>>(
        mq, mk, mv, mdo, lse2, delta, static_cast<bf*>(dq), B, Tq, Tk, Tp, H,
        Kh, scale, causal);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace fa_bwd
