// Fused cycle kernels of the AM-CCA machine: up to K engine cycles per launch.
//
// Replace the TPU kernel `repro/kernels/cca_cycle/kernel.py::cycle_megakernel`
// (launched by `repro/kernels/cca_cycle/ops.py::cca_cycle_chunk`), whose
// semantics are `repro/kernels/cca_cycle/ref.py::frozen_cycles`: run K =
// cfg.chunk cycles of `engine.cycle_body` (hop -> staging -> phase0 -> io),
// freeze at quiescence, and report an int32 record [cycle, stat_hops,
// stat_exec, stat_stall, stat_allocs, quiescent, cycles_run, 0].  Its plain
// PyTorch version is `repro_torch/kernels/cca_cycle/ref.py`; running either
// kernel equals it leaf for leaf and bit for bit.  Scope: any lanes (the
// round-robin lane arbiter, the escape lane, transit parking and the park
// stage), any rhizome_cap (rhizome roots, the link protocol, the sibling
// broadcast and the IO cells' root choice), apps bfs/sssp/cc/ingest_only
// and the max-monotone widest and reliable, the vicinity and random
// allocators, the telemetry planes, a fault plan's hazards, seals and
// OP_REPAIR, and query batches of up to 32 slot apps (qbatch > 1).  Given a trace
// pointer, a launch also fills the row (active cells, messages in flight
// after the cycle) of each cycle it runs, the stats of `engine.cycle_step`.
//
// What bounds it.  Not bytes: the mutable state (85.6 MiB at the paper's
// 50K-vertex config, 7.8 MiB at 2000 vertices) is read and written once per
// launch at best, ~54 us over 3.35 TB/s, while a launch runs up to 512
// dependent machine cycles, each a chain of scattered single-word loads and
// stores per cell with ~10 barriers between its phases.  Latency of that
// chain and the barriers bound it.
//
// Two kernels, one C entry (`cca_cycle_launch`), chosen by the wrapper:
//
//  * the cluster kernel (`cca_cycle_cluster.cuh`), for grids whose per-cell
//    state fits: the grid cut into row bands over the CTAs of one
//    thread-block cluster, each band's per-cell leaves (action queue,
//    channels, active-action registers, counters) held in shared memory
//    across the K cycles, neighbours' leaves read through distributed shared
//    memory;
//  * the one-block kernel (below), for any grid: one thread block of up to
//    1024 threads, one thread per cell (striding over cells on grids above
//    1024 cells), every leaf in device memory, every phase split by
//    __syncthreads().
//
// Every stage of the reference is a whole-grid array operation that reads
// the state as it stood before the stage, so a cycle needs a barrier between
// each read phase and its write phase.  The hop stage runs four direction
// rounds N, S, W, E, each a read phase (`hop_read`: every sender checks each
// lane's head for admissibility at its receiver, grants the admissible lane
// closest after its round-robin pointer and copies that head into the
// outbox) and a write phase (`hop_write`: every receiver pushes its
// neighbour's outbox message into the same lane, then pops its own granted
// lane -- push before pop on one ring, as the reference does).  The park
// stage (lanes > 1), staging, phase 0 and io touch only the thread's own
// cell (io only row-0 cell i for IO cell i), and the thread that ran a
// cell's E write runs its exec, so they run back to back without barriers.
// The park ring (pk, pk_head) stays in device memory in both kernels: only
// its own cell's thread touches it, and only while pk_n, held with the
// other per-cell leaves, is above 0.  Quiescence is one OR over per-cell
// work flags a cycle; the per-cell sum of fq_n and fwd_pending over the
// slots is kept incrementally in `qwork` so the test does not rescan S slots
// per cycle.
//
// The per-cell device functions are shared by both kernels and templated on
// where the per-cell leaves live (`Cells<false, ...>`: device memory, indexed by
// cell; `Cells<true, ...>`: this CTA's shared memory, indexed by cell within the
// band, a neighbour band's cells through the cluster's shared memory
// window).  The slot-indexed leaves (vals .. fwd_pending), the vicinity
// table and the IO streams stay in device memory for both.
//
// Arithmetic is the reference's: floor division and modulo (fdiv/fmod),
// float payloads moved only by bit-cast, min-relax as `inc < v ? inc : v`,
// single IEEE adds (built with --fmad=false).  Bool leaves are torch.bool
// (one byte, 0 or 1) and are updated in place as bytes.
//
// Telemetry (cfg.telemetry, DESIGN §8) is a compile-time instance of both
// kernels (`kTm`), so the instance without it is the code of the kernels
// without telemetry.  Its three planes (tm_cell [H,W,9], tm_lane
// [H,W,4,L,3], tm_hiw [H,W,2], int32) stay in device memory in both
// kernels, so the cluster kernel's band layout does not change with it.
// Every entry belongs to one cell, and only that cell's thread adds to it:
// at cycle entry (lane occupancy), in hop_write (its grants and blocked
// lanes as the sender, its accepted flit as the receiver), and in the exec
// loop (park, staging, phase 0, io, then the hi-water marks), so the
// counts need no barrier of their own, and nothing in the kernel reads
// them.  Each count goes out as a reduction without a return value (RED:
// atomicAdd / atomicMax whose result is unused), so no thread waits on a
// plane's load; a plain read-modify-write there made the paper stream's
// launches 1.29x the instance without telemetry (PERF.md section 6).
//
// Built with -DCCA_PHASE_CLOCKS, thread 0 of each CTA sums clock64() stamps
// over the phases of a launch (`cca_cycle_clocks` reads them back); with
// -DCCA_SKELETON as well, the loop keeps its barriers and drops its phases
// (`tools/cca_cycle_variants.py`).  Neither is defined in the wrapper's
// build.
//
// Faults (cfg.faults, DESIGN §9) are a second compile-time parameter of
// both kernels (`kFlt`), so the instances without them are the code of the
// kernels without faults; the plan comes as data (Dims: the hash keys of
// the three hazards, their 16-bit thresholds, the blackout count; Leaves:
// the [n, 5] blackout table and the flt counters).  The sender decides, in
// hop_read: a blackout window masks the link's admissible lanes; a granted
// OP_APP / OP_REPAIR head may be dropped, duplicated or corrupted, each
// by `fault_hash16` of the machine cycle (the launch's starting cycle plus
// the cycles run) and the global link id cell * 4 + d.  A corruption
// flips a bit of the outbox copy only; the drop and dup flags ride the
// grant word beside the lane.  The receiver, in hop_write, counts a
// dropped flit as a departure (stat_hops) but delivers nothing, so
// departures less deliveries (TM_HOP) is the drop count; the sender pops
// unless the flit was duplicated, and moves its pointer on every
// departure.  Staging and io seal what they inject (word 4, the XOR of
// words 0..3); phase 0 pops an application message whose seal is wrong as
// a counted no-op.  Each thread sums its cells' fault counts as it sums
// the counters, and each CTA adds its sums into flt once a launch.  All of
// it is integer arithmetic, so the kernels equal the plain version bit for
// bit with faults too.
//
// Query batching (cfg.qbatch = Q > 1, DESIGN §10) is a third compile-time
// parameter of both kernels (`kQ`; never with kFlt, which the config
// refuses), so the instances without it are the code of the kernels
// without it: their records are the compile-time MSGW = 5 words.  In the
// kQ instances every record stride is the runtime msgw = 5 + Q - 1.
// Words 0..4 keep their registers; the extension words (payload slots
// 1..Q-1) move in loops straight between buffers and vals, fwd_val, cemit
// (Q floats a cell) and cout, never through a whole-record local array
// (`copy_rec`, `put_rec`: an `Ext` functor names word w's source).  Each
// slot q has its own app, 4 bits of QDims' qapp0..3: relaxes, edge_value,
// fwd_merge, reached and the neutral fills take its code.  An app-like
// message's word 3 is its qsel mask (0: every slot); a deselected slot
// relaxes against its app's init_val, a no-op.  A relax changes the cell
// where any slot changed, and the insert's, the ghost's and the link-ack's
// messages carry every slot's value, unchanged slots too (the reference's
// over-propagation).  Each changed slot adds one to this CTA's qchg sum
// and takes the machine cycle into its qlast maximum (shared memory,
// 2 x Q + 1 words after the cluster layout, the dynamic shared memory of
// the one-block kernel), added into the state's qchg / qlast once a launch:
// the cycle only grows, and the host sets qlast to the boundary cycle at
// admission, so a maximum is the reference's last write.
//
// Tiles (dist/cca.py, DESIGN §5) are a fourth compile-time parameter
// (`kTl`), with each mix of the other three that the kernels have: one
// cycle of a tile of a grid sharded over ranks, its arrays the tile's cells
// and a halo two cells deep, routing, addresses, the allocator, the IO cells
// and the fault hash in the grid's coordinates (TileGeo), the counters, the
// fault and query counts, the trace row and the quiescence test over its
// owned cells, the first quiescence test the grid's (a flag the ranks
// reduce between launches).  A halo cell runs the hop stage, so that the
// owned cells receive from it exactly, and counts nothing; its telemetry
// entries count what nobody reads.  Every tile adjustment sits in an `if
// constexpr (kTile)` branch beside the code it replaces, so the instances
// without kTl compile from the same text as before.
//
// One library holds the twelve instances without kTl, a second, built from
// the same text with -DCCA_TILES=1, the twelve tile instances: two nvcc
// runs side by side build them in half the time one would take.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

namespace cg = cooperative_groups;

#ifndef CCA_TILES
#define CCA_TILES 0   // this library's instances: 0 the whole grid's, 1 tiles
#endif

namespace {

enum { OP_NOP = 0, OP_INSERT_EDGE = 1, OP_APP = 2, OP_ALLOC = 3,
       OP_SET_FUTURE = 4, OP_RHIZOME_FWD = 5, OP_LINK_RHIZOME = 6,
       OP_REPAIR = 7 };
enum { TB_N = 0, TB_S = 1, TB_W = 2, TB_E = 3, TB_AQ = 4 };
enum { G_NULL = 0, G_PENDING = 1, G_SET = 2 };
enum { APP_BFS = 0, APP_SSSP = 1, APP_CC = 2, APP_INGEST_ONLY = 3,
       APP_WIDEST = 4, APP_RELIABLE = 5 };
enum { ALLOC_VICINITY = 0, ALLOC_RANDOM = 1 };
// telemetry plane entries (core/state.py's TM_* indices)
enum { TM_EXEC = 0, TM_ALLOC = 1, TM_STALL = 2, TM_HOP = 3, TM_STAGE = 4,
       TM_PARK = 5, TM_UNPARK = 6, TM_IO = 7, TM_BCAST = 8,
       N_TM_STAGES = 9 };
enum { TM_L_OCC = 0, TM_L_GRANT = 1, TM_L_BLOCK = 2, N_TM_LANE = 3 };
enum { TM_HW_AQ = 0, TM_HW_PK = 1, N_TM_HIW = 2 };
// fault counters (resilience/faults.py's FLT_* indices)
enum { FLT_DROP = 0, FLT_DUP = 1, FLT_CORRUPT = 2, FLT_BLACKOUT = 3,
       N_FLT = 4 };
// a grant word: the granted lane + 1 (0: none), and in the fault instances
// the drop and dup decisions on its flit
constexpr int GRANT_LANE = 0xFFFF, GRANT_DROP = 1 << 16, GRANT_DUP = 1 << 17;
constexpr int MSGW = 5;
constexpr float INF = 1e9f;
constexpr int MAX_QB = 32;   // query slots at most (the qsel mask's bits)
constexpr int MAX_CTAS = 16;   // the largest (non-portable) cluster

// Scalar geometry, in the order of ops.py::_dims.  telemetry 1 takes the
// kernels' telemetry instances, faults 1 their fault instances, with the
// plan's hash keys for salts 1..3 (drop, dup, corrupt), its 16-bit
// thresholds (0: the hazard is off) and its blackout count.  n_ctas 0 takes
// the one-block kernel; otherwise the cluster kernel with n_ctas CTAs,
// whose shared memory a CTA the wrapper has reckoned as smem_bytes.
struct Dims {
  int H, W, S, E, Q, FQ, LC, L, PK, IO, IOL;
  int root_slots, primary_slots, rhizome_cap, rhizome_stride;
  int aq_reserve, sys_reserve, n_offs, app, allocator, n_cycles, telemetry;
  int faults, flt_key1, flt_key2, flt_key3, drop_thr, dup_thr, corrupt_thr,
      n_blackouts;
  int n_ctas, smem_bytes;
};
constexpr int N_DIMS = sizeof(Dims) / sizeof(int);

// Query batching, the ints that follow Dims' in ops.py::_dims: Q, the
// record's words (5 + Q - 1), and slot q's app code in bits 4 (q % 8) ..
// of qapp[q / 8].  They ride at the end of Leaves, whose address the
// kernels take anyway: with them in Dims (152 bytes, not 128) the compiler
// stopped holding Dims in registers and reloaded its fields through its
// address at each use, and the instances without kQ lost 1-6 registers
// and 2-6% a chunk.
struct QDims {
  int qb, msgw, qapp0, qapp1, qapp2, qapp3;
};
constexpr int N_QDIMS = sizeof(QDims) / sizeof(int);

// Tile mode, the ints after QDims' in ops.py::_dims: tile 1 takes the
// kernels' tile instances (kTl), which run one cycle of a tile of a GH x GW
// grid sharded over ranks.  Dims' H x W are then the tile's arrays: its
// cells at global rows r0 .. r0 + H - 1 and columns c0 .. c0 + W - 1 (a halo
// two cells deep around the cells it owns; cells off the grid are phantoms,
// empty and never reached), of which it owns local rows [or0, or1) and
// columns [oc0, oc1).  They and the flag's pointer (after Leaves' in the
// pointer array) reach only the tile instances, as TileGeo: Leaves and the
// other instances' parameters stay as they were.
struct TDims {
  int tile, GH, GW, r0, c0, or0, or1, oc0, oc1;
};
constexpr int N_TDIMS = sizeof(TDims) / sizeof(int);

// Device pointers, in the order of ops.py::KERNEL_POINTERS.
struct Leaves {
  float* vals; int* nedges; int* edst; float* ew; int* gaddr; int* gstate;
  bool* rhz_on; int* rstate; int* nfree;
  int* fq; int* fq_n; int* fq_head; float* fwd_val; bool* fwd_pending;
  int* aq; int* aq_n; int* aq_head;
  int* ch; int* ch_n; int* ch_head; int* ch_rr;
  int* pk; int* pk_n; int* pk_head;
  int* cmsg; bool* cvalid; int* cphase; int* cT; float* cemit; int* cout;
  int* cdrain;
  const int* io_edges; int* io_n; int* io_pos;
  int* arot;
  int* cycle; int* stat_hops; int* stat_exec; int* stat_stall;
  int* stat_allocs;
  int* tm_cell; int* tm_lane; int* tm_hiw;   // 1x1 dummies without telemetry
  int* flt;          // [N_FLT] fault counters ([1] dummy without faults)
  const int* offs;   // [n_offs, 2] vicinity (dy, dx) table
  const int* blackouts;   // [n_blackouts, 5] (row, col, dir, start, n)
  int* outbox;       // [cells, msgw] granted heads of the current round
  int* grant;        // [cells] granted lane + 1, 0 for none
  int* qwork;        // [cells] sum over slots of fq_n + fwd_pending
  int* rec;          // [8] the launch record
  int* trace;        // [n_cycles, 2] (active, in_flight) a cycle, or null
  int* qchg;         // [Q] per-query changed relaxes ([1] dummy at Q = 1)
  int* qlast;        // [Q] per-query cycle of the last one
  QDims q;           // not a pointer: from the dims array (cca_cycle_launch)
};
constexpr int N_PTRS = offsetof(Leaves, q) / sizeof(void*);

// Phase clocks (probe builds only): 0 the quiescence test, 1 + 2d the read
// and 2 + 2d the write of hop direction d (N, S, W, E), 9 exec, 10 the
// prologue (band load, qwork), 11 the epilogue (write-back, record).
constexpr int N_PHASES = 12;
#ifdef CCA_PHASE_CLOCKS
__device__ long long cca_clocks[MAX_CTAS][N_PHASES];
struct PhaseClock {
  long long t, acc[N_PHASES];
  __device__ void start() {
    t = clock64();
    for (int k = 0; k < N_PHASES; ++k) acc[k] = 0;
  }
  __device__ void stamp(int k) {
    if (threadIdx.x == 0) {
      long long now = clock64();
      acc[k] += now - t;
      t = now;
    }
  }
  __device__ void flush(int rank) {
    if (threadIdx.x == 0)
      for (int k = 0; k < N_PHASES; ++k) cca_clocks[rank][k] = acc[k];
  }
};
#else
struct PhaseClock {
  __device__ void start() {}
  __device__ void stamp(int) {}
  __device__ void flush(int) {}
};
#endif

__device__ __forceinline__ int fdiv(int a, int b) {
  int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}
__device__ __forceinline__ int fmod_(int a, int b) {
  int r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}
__device__ __forceinline__ int f2i(float x) { return __float_as_int(x); }
__device__ __forceinline__ float i2f(int x) { return __int_as_float(x); }

__device__ __forceinline__ bool is_protocol(int op) {
  return op == OP_ALLOC || op == OP_SET_FUTURE || op == OP_LINK_RHIZOME ||
         op == OP_RHIZOME_FWD;
}

// YX dimension-ordered next buffer of a message at (row, col).
__device__ __forceinline__ int yx_tb(const Dims& D, int dst_cell, int row,
                                     int col) {
  int dr = fdiv(dst_cell, D.W), dc = fmod_(dst_cell, D.W);
  if (dr != row) return dr < row ? TB_N : TB_S;
  if (dc != col) return dc < col ? TB_W : TB_E;
  return TB_AQ;
}
// The same on a grid W cells wide (kTl: a tile's grid, not its arrays).
__device__ __forceinline__ int yx_tb_w(int W, int dst_cell, int row,
                                       int col) {
  int dr = fdiv(dst_cell, W), dc = fmod_(dst_cell, W);
  if (dr != row) return dr < row ? TB_N : TB_S;
  if (dc != col) return dc < col ? TB_W : TB_E;
  return TB_AQ;
}

// Action-queue admission of an external push (hop / io stage).
__device__ __forceinline__ bool ext_room(const Dims& D, int op, int aq_n) {
  return is_protocol(op) ? aq_n < D.Q - D.aq_reserve
                         : aq_n < D.Q - D.aq_reserve - D.sys_reserve;
}

// Virtual lane of a message (routing.msg_lane): protocol traffic on the
// escape lane 0, application traffic hashed by destination onto 1..L-1.
__device__ __forceinline__ int msg_lane(const Dims& D, int op, int dst) {
  if (D.L == 1 || is_protocol(op)) return 0;
  return 1 + fmod_(dst, D.L - 1);
}

// resilience/faults.py::fault_hash16 in uint32 arithmetic (wrapping
// multiplies, logical shifts): the 16-bit decision hash of (cycle, link)
// under `key`, the plan's key for one salt.
__device__ __forceinline__ unsigned fault_hash16(int key, int cycle,
                                                 int link) {
  unsigned h = (unsigned)cycle * 0x9E3779B1u + (unsigned)link * 0x85EBCA6Bu +
               (unsigned)key;
  h = (h ^ (h >> 16)) * 0x85EBCA6Bu;
  h = (h ^ (h >> 13)) * 0xC2B2AE35u;
  return (h ^ (h >> 16)) & 0xFFFFu;
}

// msg.msg_seal: the XOR of words 0..3.
__device__ __forceinline__ int msg_seal(const int* m) {
  return m[0] ^ m[1] ^ m[2] ^ m[3];
}

__device__ __forceinline__ bool max_app(int app) {
  return app == APP_WIDEST || app == APP_RELIABLE;
}

__device__ __forceinline__ float edge_value(int app, float v, float w) {
  if (app == APP_BFS) return __fadd_rn(v, 1.0f);
  if (app == APP_SSSP) return __fadd_rn(v, w);
  if (app == APP_WIDEST) return w < v ? w : v;
  if (app == APP_RELIABLE) return __fmul_rn(v, w);
  return v;   // cc, ingest_only
}

// The app's fwd_merge (min, or max for the max-monotone apps), its
// neutral element, and whether `inc` relaxes `v`.
__device__ __forceinline__ float fwd_merge(int app, float a, float b) {
  return max_app(app) ? (b > a ? b : a) : (b < a ? b : a);
}
__device__ __forceinline__ float fwd_neutral(int app) {
  return max_app(app) ? 0.0f : INF;
}
__device__ __forceinline__ bool relaxes(int app, float inc, float v) {
  if (app == APP_INGEST_ONLY) return false;
  return max_app(app) ? inc > v : inc < v;
}
// propagate_on_insert: a reached source vertex (never for ingest_only).
__device__ __forceinline__ bool reached(int app, float v) {
  if (app == APP_INGEST_ONLY) return false;
  return max_app(app) ? v > 0.0f : v < INF;
}

// (kQ) The slot apps' codes, 4 bits a slot, by value (so a functor that
// carries them takes no kernel parameter's address); init_val and
// fwd_neutral of a slot are the same element for every bundled app.
struct SlotApps {
  int w0, w1, w2, w3;
  __device__ __forceinline__ int operator()(int q) const {
    int w = q < 8 ? w0 : q < 16 ? w1 : q < 24 ? w2 : w3;
    return (w >> (4 * (q & 7))) & 15;
  }
};
__device__ __forceinline__ int slot_app(const QDims& Q, int q) {
  return SlotApps{Q.qapp0, Q.qapp1, Q.qapp2, Q.qapp3}(q);
}

// The dynamic shared memory of both kernels: the cluster kernel's band
// layout, and (kQ) the per-query sums.
extern __shared__ __align__(16) int cca_dyn_smem[];

// Add `v`, summed over the warp, into *at (one atomic a warp).  The lanes
// of a partial last warp are named exactly.
__device__ __forceinline__ void trace_add(int* at, int v) {
  const int lanes = min(32, (int)blockDim.x - (int)(threadIdx.x & ~31u));
  const unsigned mask = lanes == 32 ? 0xffffffffu : (1u << lanes) - 1u;
  v = __reduce_add_sync(mask, v);
  if ((threadIdx.x & 31) == 0 && v) atomicAdd(at, v);
}

__device__ __forceinline__ void copy_msg(int* dst, const int* src) {
#pragma unroll
  for (int w = 0; w < MSGW; ++w) dst[w] = src[w];
}


// Where the per-cell leaves of a kernel live.  Each pointer holds one
// entry per cell of the band [c0, c0 + nb), at local index l(c); the
// one-block kernel's band is the whole grid in device memory (c0 = 0), the
// cluster kernel's a row band in shared memory.  `outbox` and `grant` hold
// one buffer per hop direction, `box_dir` / `grant_dir` entries apart (0:
// one buffer shared by the four rounds).  `io_n` / `io_pos` are indexed by
// IO cell.  kTm: the telemetry instance, whose planes (`tm_cell`,
// `tm_lane`, `tm_hiw`) are in device memory, indexed by cell.  kFlt: the
// fault instance.  kTl: the tile instance, whose geometry (TileGeo) maps
// the arrays' cells to the grid.
template <bool kTl>
struct TileGeo {};
template <>
struct TileGeo<true> {
  int GH, GW, tr0, tc0, or0, or1, oc0, oc1;   // (tr0, tc0: TDims' r0, c0)
  const int* gquiet;   // the grid's quiescence at cycle entry
};

template <bool kCluster, bool kTm, bool kFlt, bool kQ, bool kTl>
struct Cells : TileGeo<kTl> {
  static constexpr bool kTelemetry = kTm;
  static constexpr bool kFaults = kFlt;
  static constexpr bool kQb = kQ;
  static constexpr bool kTile = kTl;
  int *aq, *aq_n, *aq_head, *ch, *ch_n, *ch_head, *ch_rr, *pk_n, *cmsg;
  bool* cvalid;
  int *cphase, *cT;
  float* cemit;
  int *cout, *cdrain, *arot, *nfree, *io_n, *io_pos, *qwork, *outbox,
      *grant;
  int *tm_cell, *tm_lane, *tm_hiw;
  int c0, nb, box_dir, grant_dir;
  int rank, n_ctas;   // cluster kernel: this CTA's rank, the CTA count
  int* qflag;         // cluster kernel: [MAX_CTAS] each CTA's busy flag
  int mw, qb;         // kQ: the record's words, the query slots
  int qsum_off;       // kQ: word offset of the qchg / qlast sums in
                      // cca_dyn_smem

  // (kTl) cell c's global row, column and id, and whether it lies on the
  // grid (a phantom does not) and is owned (counted, tested, executed).
  __device__ __forceinline__ int grow(const Dims& D, int c) const {
    return this->tr0 + c / D.W;
  }
  __device__ __forceinline__ int gcol(const Dims& D, int c) const {
    return this->tc0 + c % D.W;
  }
  __device__ __forceinline__ int gcell(const Dims& D, int c) const {
    return grow(D, c) * this->GW + gcol(D, c);
  }
  __device__ __forceinline__ bool on_grid(int r, int c) const {
    r += this->tr0;
    c += this->tc0;
    return r >= 0 && r < this->GH && c >= 0 && c < this->GW;
  }
  __device__ __forceinline__ bool owns(const Dims& D, int c) const {
    int r = c / D.W, q = c % D.W;
    return r >= this->or0 && r < this->or1 && q >= this->oc0 &&
           q < this->oc1;
  }
  // A record's words: MSGW, or at kQ the runtime 5 + Q - 1.
  __device__ __forceinline__ int wd() const {
    if constexpr (kQ) return mw; else return MSGW;
  }
  __device__ __forceinline__ int l(int c) const {
    return kCluster ? c - c0 : c;
  }
  // Entry `off` of cell c's `width`-wide row of leaf p, c in any band.
  template <class T>
  __device__ __forceinline__ T* peer(T* p, int c, int width, int off) const {
    if constexpr (!kCluster) return p + (size_t)c * width + off;
    int r = c / nb;
    T* at = p + (size_t)(c - r * nb) * width + off;
    return r == rank ? at : cg::this_cluster().map_shared_rank(at, r);
  }
  __device__ __forceinline__ int* box(int d, int c) const {
    return outbox + d * box_dir + l(c) * wd();
  }
  __device__ __forceinline__ int& granted(int d, int c) const {
    return grant[d * grant_dir + l(c)];
  }
  // Add one to cell c's entry k of tm_cell (a RED).
  __device__ __forceinline__ void count(int c, int k) const {
    atomicAdd(tm_cell + (size_t)c * N_TM_STAGES + k, 1);
  }
  // OR of `busy` over every thread of the kernel.  Also orders the
  // previous cycle's writes before the next cycle's reads, across CTAs.
  __device__ __forceinline__ bool any(int busy) const {
    int b = __syncthreads_or(busy);
    if constexpr (!kCluster) return b;
    if ((int)threadIdx.x < n_ctas)
      *cg::this_cluster().map_shared_rank(qflag + rank, threadIdx.x) = b;
    cg::this_cluster().sync();
    b = 0;
    for (int r = 0; r < n_ctas; ++r) b |= qflag[r];
    return b;
  }
  // The barrier after hop phase `k` (2d: read of direction d, 2d + 1: its
  // write).  The one-block kernel: always its block.  The cluster kernel:
  // N and S reach the neighbour band (N read, N write, S read end at a
  // cluster barrier; S write at a CTA one, since the W round reads only its
  // own band and no band reads a neighbour's leaves again before the next
  // quiescence test); W and E stay inside the band; exec after the E write
  // touches only the thread's own cell.
  __device__ __forceinline__ void sync(int k) const {
    if constexpr (!kCluster) {
      __syncthreads();
    } else if (k <= 2) {
      cg::this_cluster().sync();
    } else if (k < 7) {
      __syncthreads();
    }
  }
};

// A whole record of X's width from src to dst; at kQ words 5.. in a loop.
template <class C>
__device__ __forceinline__ void copy_rec(const C& X, int* dst,
                                         const int* src) {
  copy_msg(dst, src);
  if constexpr (C::kQb)
    for (int w = MSGW; w < X.wd(); ++w) dst[w] = src[w];
}

// A record into dst: words 0..4 from msg, at kQ words 5.. from ext(w),
// or zeros without an `ext` (a classic record's dead extension words).
template <class C, class Ext>
__device__ __forceinline__ void put_rec(const C& X, int* dst, const int* msg,
                                        const Ext& ext) {
  copy_msg(dst, msg);
  if constexpr (C::kQb)
    for (int w = MSGW; w < X.wd(); ++w) dst[w] = ext(w);
}
template <class C>
__device__ __forceinline__ void put_rec(const C& X, int* dst,
                                        const int* msg) {
  copy_msg(dst, msg);
  if constexpr (C::kQb)
    for (int w = MSGW; w < X.wd(); ++w) dst[w] = 0;
}

// routing.deliver for one cell: the local action queue (tb == TB_AQ, gated
// by aq_room) or lane `lane` of channel tb (gated by lane capacity).  The
// ring of (direction tb, lane) is entry (l * 4 + tb) * L + lane of ch_n.
// At kQ, `ext` (none, or one functor) gives the record's words 5.. .
template <class C, class... Ext>
__device__ bool deliver(const Dims& D, const C& X, int c, const int* msg,
                        int tb, int lane, bool aq_room, const Ext&... ext) {
  int l = X.l(c);
  if (tb == TB_AQ) {
    if (!aq_room) return false;
    int n = X.aq_n[l];
    int tail = fmod_(X.aq_head[l] + n, D.Q);
    put_rec(X, X.aq + ((size_t)l * D.Q + tail) * X.wd(), msg, ext...);
    X.aq_n[l] = n + 1;
    return true;
  }
  if (tb < 0 || tb > 3) return false;
  int k = (l * 4 + tb) * D.L + lane;
  int n = X.ch_n[k];
  if (n >= D.LC) return false;
  int tail = fmod_(X.ch_head[k] + n, D.LC);
  put_rec(X, X.ch + ((size_t)k * D.LC + tail) * X.wd(), msg, ext...);
  X.ch_n[k] = n + 1;
  return true;
}

__constant__ int kDy[4] = {-1, 1, 0, 0};  // N, S, W, E
__constant__ int kDx[4] = {0, 0, -1, 1};

// Whether the head of lane j (ring k) of a sender can enter receiver recv
// at (rr, rc) (kTl: of the grid): action-queue room if it has arrived, else
// room in the same lane of the receiver's next channel.  Sets `head` to it.
template <class C>
__device__ __forceinline__ bool admissible(const Dims& D, const C& X, int k,
                                           int j, int recv, int rr, int rc,
                                           const int*& head) {
  if (X.ch_n[k] <= 0) return false;
  head = X.ch + ((size_t)k * D.LC + fmod_(X.ch_head[k], D.LC)) * X.wd();
  int tb = yx_tb(D, fdiv(head[1], D.S), rr, rc);
  if constexpr (C::kTile) tb = yx_tb_w(X.GW, fdiv(head[1], D.S), rr, rc);
  return tb == TB_AQ ? ext_room(D, head[0], *X.peer(X.aq_n, recv, 1, 0))
                     : *X.peer(X.ch_n, recv, 4 * D.L, tb * D.L + j) < D.LC;
}

struct Counts {
  int hops, exec, stall, allocs;
  int drop, dup, corrupt, blackout;   // the fault instances' flt counts
};

// Whether a blackout window of the plan holds link d of cell (row, col)
// dead in machine cycle cyc.
__device__ __forceinline__ bool link_dead(const Dims& D, const Leaves& P,
                                          int row, int col, int d, int cyc) {
  for (int i = 0; i < D.n_blackouts; ++i) {
    const int* b = P.blackouts + 5 * i;
    if (b[0] == row && b[1] == col && b[2] == d && cyc >= b[3] &&
        cyc - b[3] < b[4])
      return true;
  }
  return false;
}

// The drop / dup / corrupt decisions on the flit granted on global link
// `link` (cell * 4 + d) in machine cycle cyc, application traffic only.  A
// corruption flips bit 8 + (h & 7) of word 2 of the outbox copy `box`,
// never of a dropped flit.  Returns the grant word's flags.
__device__ __forceinline__ int fault_flags(const Dims& D, int* box, int link,
                                           int cyc) {
  if (box[0] != OP_APP && box[0] != OP_REPAIR) return 0;
  bool drop = D.drop_thr &&
              fault_hash16(D.flt_key1, cyc, link) < (unsigned)D.drop_thr;
  bool dup = D.dup_thr &&
             fault_hash16(D.flt_key2, cyc, link) < (unsigned)D.dup_thr;
  if (D.corrupt_thr && !drop) {
    unsigned h = fault_hash16(D.flt_key3, cyc, link);
    if (h < (unsigned)D.corrupt_thr) box[2] ^= 1 << (8 + (h & 7));
  }
  // a dropped flit is never delivered, so never delivered twice
  return drop ? GRANT_DROP : dup ? GRANT_DUP : 0;
}

// Hop phase A: cell c as the sender on link d in machine cycle cyc.  Of the
// lanes whose head is admissible, the one closest after the link's
// round-robin pointer ch_rr wins (one lane: no arbiter).  The grant records
// that lane + 1 (0: none); the fault instance first masks a dead link
// (counting the admissible lanes it held back) and adds the flit's fault
// flags.
template <class C>
__device__ void hop_read(const Dims& D, const Leaves& P, const C& X, int c,
                         int d, int cyc, Counts& n) {
  int row = c / D.W, col = c % D.W;
  int rr = row + kDy[d], rc = col + kDx[d];
  int base = (X.l(c) * 4 + d) * D.L;
  int grant = 0;
  if (rr >= 0 && rr < D.H && rc >= 0 && rc < D.W) {
    int recv = rr * D.W + rc;
    if constexpr (C::kTile) {
      if (!X.on_grid(rr, rc)) {   // a phantom receiver takes nothing
        X.granted(d, c) = 0;
        return;
      }
      // from here on, in the grid's coordinates
      row += X.tr0; col += X.tc0; rr += X.tr0; rc += X.tc0;
    }
    const int* win = nullptr;
    int n_adm;   // admissible lanes
    if (D.L == 1) {
      grant = admissible(D, X, base, 0, recv, rr, rc, win);
      n_adm = grant;
    } else {
      int ptr = X.ch_rr[X.l(c) * 4 + d], best = D.L;
      n_adm = 0;
      for (int j = 0; j < D.L; ++j) {
        const int* head;
        if (!admissible(D, X, base + j, j, recv, rr, rc, head)) continue;
        ++n_adm;
        int key = fmod_(j - ptr, D.L);
        if (key < best) {
          best = key;
          grant = j + 1;
          win = head;
        }
      }
    }
    if constexpr (C::kFaults) {
      if (grant && link_dead(D, P, row, col, d, cyc)) {
        if constexpr (C::kTile) {   // a halo sender counts nothing
          if (X.owns(D, c)) n.blackout += n_adm;
        } else {
          n.blackout += n_adm;
        }
        grant = 0;
      }
    }
    if (grant) {
      int* box = X.box(d, c);
      copy_rec(X, box, win);
      if constexpr (C::kFaults) {
        int link = 4 * c + d;
        if constexpr (C::kTile) link = 4 * (row * X.GW + col) + d;
        grant |= fault_flags(D, box, link, cyc);
      }
    }
  }
  X.granted(d, c) = grant;
}

// Hop phase B: cell c receives its link-d neighbour's granted head into the
// same lane, then pops its own granted lane and moves its pointer past it.
// Returns the flits that left the sender for here: accepted, or (fault
// instance) dropped on the link.  The fault instance counts the drops and
// the duplicates it accepts, and keeps its own duplicated flit.
template <class C>
__device__ int hop_write(const Dims& D, const C& X, int c, int d,
                         Counts& n) {
  int row = c / D.W, col = c % D.W;
  int sr = row - kDy[d], sc = col - kDx[d];
  // (kTl) the receiver in the grid's coordinates; a phantom sender never
  // grants
  if constexpr (C::kTile) { row += X.tr0; col += X.tc0; }
  int hops = 0, rin = -1;   // rin: the lane of link d this cell received in
  bool delivered = false;
  if (sr >= 0 && sr < D.H && sc >= 0 && sc < D.W) {
    int snd = sr * D.W + sc;
    int g = *X.peer(X.grant + d * X.grant_dir, snd, 1, 0), flags = 0;
    if constexpr (C::kFaults) {
      flags = g & ~GRANT_LANE;
      g &= GRANT_LANE;
    }
    if (flags & GRANT_DROP) {
      hops = 1;   // a departure, never delivered
      if constexpr (C::kTile) {   // a halo receiver counts nothing
        if (X.owns(D, c)) n.drop += 1;
      } else {
        n.drop += 1;
      }
    } else if (g) {
      int msg[MSGW];
      if constexpr (C::kQb) {
        const int* src = X.peer(X.outbox + d * X.box_dir, snd, X.wd(), 0);
        copy_msg(msg, src);
        int tb = yx_tb(D, fdiv(msg[1], D.S), row, col);
        if constexpr (C::kTile) tb = yx_tb_w(X.GW, fdiv(msg[1], D.S), row, col);
        delivered = deliver(D, X, c, msg, tb, g - 1,
                            ext_room(D, msg[0], X.aq_n[X.l(c)]),
                            [src](int w) { return src[w]; });
        hops = delivered;
        if (delivered && tb == d) rin = g - 1;
      } else {
        copy_msg(msg, X.peer(X.outbox + d * X.box_dir, snd, MSGW, 0));
        int tb = yx_tb(D, fdiv(msg[1], D.S), row, col);
        if constexpr (C::kTile) tb = yx_tb_w(X.GW, fdiv(msg[1], D.S), row, col);
        delivered = deliver(D, X, c, msg, tb, g - 1,
                            ext_room(D, msg[0], X.aq_n[X.l(c)]));
        hops = delivered;
        if (delivered && tb == d) rin = g - 1;
      }
      if (delivered && (flags & GRANT_DUP)) {
        if constexpr (C::kTile) {
          if (X.owns(D, c)) n.dup += 1;
        } else {
          n.dup += 1;
        }
      }
    }
  }
  int g = X.granted(d, c);
  bool popped = g != 0;
  if constexpr (C::kFaults) {
    popped = g && !(g & GRANT_DUP);
    g &= GRANT_LANE;
  }
  if (g) {
    int k = (X.l(c) * 4 + d) * D.L + g - 1;
    if (popped) {
      X.ch_n[k] -= 1;
      X.ch_head[k] = fmod_(X.ch_head[k] + 1, D.LC);
    }
    X.ch_rr[X.l(c) * 4 + d] = g < D.L ? g : 0;   // (granted lane + 1) % L
  }
  if constexpr (C::kTelemetry) {
    // a grant is accepted (or dropped) by construction: the lane that
    // popped gets a grant, every other lane occupied at the round's start
    // (its count now, less the flit received into it above) a blocked
    // cycle, a duplicated one too
    const int* chn = X.ch_n + (X.l(c) * 4 + d) * D.L;
    int* tl = X.tm_lane + ((size_t)c * 4 + d) * D.L * N_TM_LANE;
    for (int j = 0; j < D.L; ++j) {
      if (j == g - 1 && popped) atomicAdd(tl + j * N_TM_LANE + TM_L_GRANT, 1);
      else if (chn[j] - (j == rin) > 0)
        atomicAdd(tl + j * N_TM_LANE + TM_L_BLOCK, 1);
    }
    if (delivered) X.count(c, TM_HOP);
  }
  return hops;
}

// routing.park_stage for cell c (lanes > 1): the park ring's head re-enters
// its lane of the YX next channel, or rotates to the ring's tail.  Never
// into the action queue (aq_room false).  pk and pk_head in device memory,
// indexed by cell.
template <class C>
__device__ void park(const Dims& D, const Leaves& P, const C& X, int c) {
  int l = X.l(c), n = X.pk_n[l];
  if (n <= 0) return;
  int h = P.pk_head[c];
  int head[MSGW];
  if constexpr (C::kQb) {
    const int W = X.wd();
    int* ring = P.pk + (size_t)c * D.PK * W;
    const int* hp = ring + fmod_(h, D.PK) * W;
    copy_msg(head, hp);
    int tb = yx_tb(D, fdiv(head[1], D.S), c / D.W, c % D.W);
    if constexpr (C::kTile)
      tb = yx_tb_w(X.GW, fdiv(head[1], D.S), X.grow(D, c), X.gcol(D, c));
    if (deliver(D, X, c, head, tb, msg_lane(D, head[0], head[1]), false,
                [hp](int w) { return hp[w]; })) {
      X.pk_n[l] = n - 1;
      if constexpr (C::kTelemetry) X.count(c, TM_UNPARK);
    } else {
      copy_rec(X, ring + fmod_(h + n, D.PK) * W, hp);
    }
  } else {
    int* ring = P.pk + (size_t)c * D.PK * MSGW;
    copy_msg(head, ring + fmod_(h, D.PK) * MSGW);
    int tb = yx_tb(D, fdiv(head[1], D.S), c / D.W, c % D.W);
    if constexpr (C::kTile)
      tb = yx_tb_w(X.GW, fdiv(head[1], D.S), X.grow(D, c), X.gcol(D, c));
    if (deliver(D, X, c, head, tb, msg_lane(D, head[0], head[1]), false)) {
      X.pk_n[l] = n - 1;
      if constexpr (C::kTelemetry) X.count(c, TM_UNPARK);
    } else {
      copy_msg(ring + fmod_(h + n, D.PK) * MSGW, head);
    }
  }
  P.pk_head[c] = fmod_(h + 1, D.PK);
}

// exec_stage.staging_stage for cell c: the active action stages its next
// emission.  Returns whether the cell had one (staging's `active`).
template <class C>
__device__ bool staging(const Dims& D, const Leaves& P, const C& X, int c,
                        Counts& n) {
  int l = X.l(c);
  if (!X.cvalid[l]) return false;
  int cphase = X.cphase[l], cT = X.cT[l];
  if (cphase < 1 || cphase > cT) return false;
  const int W = X.wd();
  const int* cm = X.cmsg + (size_t)l * W;
  int op = cm[0], dst = cm[1];
  int S = D.S, slot = fmod_(dst, S);
  size_t idx = (size_t)c * S + slot;
  int k = cphase - 1, cdrain = X.cdrain[l];
  // (kQ) the Q value slots of (cell, slot) and the Q-float emission
  // snapshot
  const size_t vi = C::kQb ? idx * X.qb : 0;
  const float* cev = C::kQb ? X.cemit + (size_t)l * X.qb : nullptr;
  float cemit = C::kQb ? cev[0] : X.cemit[l];
  // (fault instance) an OP_REPAIR emits as OP_APP does; only its ghost
  // forward keeps the opcode
  const bool is_rp = C::kFaults && op == OP_REPAIR;
  bool is_app = op == OP_APP || is_rp, is_sf = op == OP_SET_FUTURE,
       is_rf = op == OP_RHIZOME_FWD, is_appl = is_app || is_rf;
  int kd = k - cdrain;
  int ne = P.nedges[idx], gs = P.gstate[idx], ga = P.gaddr[idx];
  int n_bcast = (is_app && slot < D.root_slots && P.rstate[idx] == G_SET)
                    ? D.rhizome_cap - 1 : 0;
  bool is_bcast = is_app && kd >= ne && kd < ne + n_bcast;
  bool appl_is_fwd = is_appl && kd >= ne + n_bcast && k >= cdrain;
  int fqn = P.fq_n[idx], fqh = P.fq_head[idx];
  const int* fq_e = P.fq + (idx * D.FQ + fmod_(fqh, D.FQ)) * 3;
  bool sf_from_fq = is_sf && fqn > 0, sf_from_fwd = is_sf && fqn == 0;
  bool rf_drain = is_rf && k < cdrain;

  int emis[MSGW] = {0, 0, 0, 0, 0};
  // (kQ) where the extension words come from: zeros, the snapshot, its
  // edge values, the forward register, the slot apps' init_val, cout
  enum { X_ZERO, X_CEMIT, X_EDGE, X_FWD, X_INIT, X_COUT };
  int xk = X_ZERO;
  float ew = 0.0f;
  if (is_appl) {
    if (rf_drain) {
      emis[0] = OP_INSERT_EDGE; emis[1] = dst; emis[2] = fq_e[1];
      emis[3] = fq_e[2];
    } else if (appl_is_fwd) {
      emis[0] = is_rp ? OP_REPAIR : OP_APP; emis[1] = ga;
      emis[2] = f2i(cemit);
      xk = X_CEMIT;
    } else if (is_bcast) {
      int v = slot * (D.H * D.W) + c;
      int hi = D.rhizome_cap > 1 ? D.rhizome_cap - 1 : 1;
      int sib = min(max(kd - ne + 1, 1), hi);
      int cell = fmod_(v + sib * D.rhizome_stride, D.H * D.W);
      emis[0] = OP_RHIZOME_FWD;
      emis[1] = cell * S + sib * D.root_slots + fdiv(v, D.H * D.W);
      if constexpr (C::kTile) {   // the grid's cells and this cell's id
        const int NC = X.GH * X.GW;
        v = slot * NC + X.gcell(D, c);
        cell = fmod_(v + sib * D.rhizome_stride, NC);
        emis[1] = cell * S + sib * D.root_slots + fdiv(v, NC);
      }
      emis[2] = f2i(cemit);
      xk = X_CEMIT;
    } else {
      int ek = min(max(kd, 0), D.E - 1);
      emis[0] = OP_APP;
      emis[1] = P.edst[idx * D.E + ek];
      if constexpr (C::kQb) {
        ew = P.ew[idx * D.E + ek];
        emis[2] = f2i(edge_value(slot_app(P.q, 0), cemit, ew));
        xk = X_EDGE;
      } else {
        emis[2] = f2i(edge_value(D.app, cemit, P.ew[idx * D.E + ek]));
      }
    }
  } else if (is_sf) {
    if (sf_from_fq) {
      if (fq_e[0] == OP_INSERT_EDGE) {
        emis[0] = OP_INSERT_EDGE; emis[1] = ga; emis[2] = fq_e[1];
        emis[3] = fq_e[2];
      } else {
        emis[0] = OP_APP; emis[1] = ga; emis[2] = fq_e[1];
        xk = X_INIT;
      }
    } else {
      emis[0] = OP_APP; emis[1] = ga;
      emis[2] = f2i(P.fwd_val[C::kQb ? vi : idx]);
      xk = X_FWD;
    }
  } else {
    copy_msg(emis, X.cout + (size_t)l * W);
    xk = X_COUT;
  }
  // every emission is sealed, phase 0's cout too
  if constexpr (C::kFaults) emis[4] = msg_seal(emis);

  // an app forward onto a pending future coalesces into the monotone
  // forward register instead of entering the network (never stalls)
  bool to_reg = appl_is_fwd && gs == G_PENDING;
  bool ok_total, parked = false;
  if (to_reg) {
    if constexpr (C::kQb) {
      for (int q = 0; q < X.qb; ++q)
        P.fwd_val[vi + q] = fwd_merge(slot_app(P.q, q), P.fwd_val[vi + q],
                                      cev[q]);
    } else {
      P.fwd_val[idx] = fwd_merge(D.app, P.fwd_val[idx], cemit);
    }
    if (!P.fwd_pending[idx]) { P.fwd_pending[idx] = true; X.qwork[l] += 1; }
    ok_total = true;
  } else if constexpr (C::kQb) {
    // extension word w = slot q = w - 4 of the emission (the functor
    // carries its sources by value)
    const SlotApps sa{P.q.qapp0, P.q.qapp1, P.q.qapp2, P.q.qapp3};
    const float* fwd = P.fwd_val + vi;
    const int* crow = X.cout + (size_t)l * W;
    auto ext = [=](int w) -> int {
      int q = w - (MSGW - 1);
      switch (xk) {
        case X_CEMIT: return f2i(cev[q]);
        case X_EDGE: return f2i(edge_value(sa(q), cev[q], ew));
        case X_FWD: return f2i(fwd[q]);
        case X_INIT: return f2i(fwd_neutral(sa(q)));
        case X_COUT: return crow[w];
      }
      return 0;
    };
    int tb = yx_tb(D, fdiv(emis[1], S), c / D.W, c % D.W);
    if constexpr (C::kTile)
      tb = yx_tb_w(X.GW, fdiv(emis[1], S), X.grow(D, c), X.gcol(D, c));
    ok_total = deliver(D, X, c, emis, tb, msg_lane(D, emis[0], emis[1]),
                       X.aq_n[l] < D.Q, ext);
    if (!ok_total && D.L > 1 && tb != TB_AQ && X.pk_n[l] < D.PK) {
      int pn = X.pk_n[l];
      put_rec(X, P.pk + ((size_t)c * D.PK + fmod_(P.pk_head[c] + pn, D.PK)) *
                            W, emis, ext);
      X.pk_n[l] = pn + 1;
      n.stall += 1;
      ok_total = parked = true;
    }
  } else {
    int tb = yx_tb(D, fdiv(emis[1], S), c / D.W, c % D.W);
    if constexpr (C::kTile)
      tb = yx_tb_w(X.GW, fdiv(emis[1], S), X.grow(D, c), X.gcol(D, c));
    ok_total = deliver(D, X, c, emis, tb, msg_lane(D, emis[0], emis[1]),
                       X.aq_n[l] < D.Q);
    // transit parking (lanes > 1): a remote emission whose lane is full
    // goes into the park ring if it has room, and counts as a stall
    if (!ok_total && D.L > 1 && tb != TB_AQ && X.pk_n[l] < D.PK) {
      int pn = X.pk_n[l];
      copy_msg(P.pk + ((size_t)c * D.PK + fmod_(P.pk_head[c] + pn, D.PK)) *
                          MSGW, emis);
      X.pk_n[l] = pn + 1;
      n.stall += 1;
      ok_total = parked = true;
    }
  }
  if (ok_total && (sf_from_fq || rf_drain)) {
    P.fq_n[idx] = fqn - 1;
    P.fq_head[idx] = fmod_(fqh + 1, D.FQ);
    X.qwork[l] -= 1;
  }
  if (ok_total && sf_from_fwd) {
    if constexpr (C::kQb) {
      for (int q = 0; q < X.qb; ++q)
        P.fwd_val[vi + q] = fwd_neutral(slot_app(P.q, q));
    } else {
      P.fwd_val[idx] = fwd_neutral(D.app);
    }
    if (P.fwd_pending[idx]) { P.fwd_pending[idx] = false; X.qwork[l] -= 1; }
  }
  int new_phase = cphase + (ok_total ? 1 : 0);
  X.cphase[l] = new_phase;
  if (ok_total && new_phase > cT) { X.cvalid[l] = false; n.exec += 1; }
  if (!ok_total) n.stall += 1;
  if constexpr (C::kTelemetry) {
    // a park is no TM_STALL: sum(TM_STALL) + sum(TM_PARK) == stat_stall
    X.count(c, ok_total ? TM_STAGE : TM_STALL);
    if (parked) X.count(c, TM_PARK);
    if (ok_total && is_bcast && !to_reg) X.count(c, TM_BCAST);
  }
  return true;
}

// exec_stage.phase0_stage for cell c: an idle cell pops one action and runs
// its computing instruction.  Returns whether it popped one (phase 0's
// `pop`; a rotated head is no pop).
template <class C>
__device__ bool phase0(const Dims& D, const Leaves& P, const C& X, int c,
                       bool busy0, Counts& n) {
  int l = X.l(c);
  int aqn = X.aq_n[l];
  if (busy0 || aqn <= 0) return false;
  int S = D.S, NC = D.H * D.W, Q = D.Q;
  if constexpr (C::kTile) NC = X.GH * X.GW;   // the grid's cells
  int aqh = X.aq_head[l];
  const int W = X.wd();
  // the popped record stays at the queue's head while phase 0 runs: its
  // extension words are read from there
  const int* mrow = X.aq + ((size_t)l * Q + fmod_(aqh, Q)) * W;
  int m[MSGW];
  copy_msg(m, mrow);
  int op = m[0], dst = m[1], a0 = m[2], a1 = m[3];
  if constexpr (C::kFaults) {
    // the seal check: an application message corrupted in transit is
    // popped as a counted no-op
    if ((op == OP_APP || op == OP_REPAIR) && msg_seal(m) != m[4]) {
      op = OP_NOP;
      n.corrupt += 1;
    }
  }
  // (fault instance) the repair pass's relax, an OP_APP that re-diffuses
  // even where it changes nothing
  const bool is_rp = C::kFaults && op == OP_REPAIR;
  int slot = fmod_(dst, S);
  size_t idx = (size_t)c * S + slot;
  const size_t vi = C::kQb ? idx * X.qb : 0;   // (kQ) its Q value slots
  float vs = P.vals[C::kQb ? vi : idx];
  int ne = P.nedges[idx], gs = P.gstate[idx], fqn = P.fq_n[idx];
  int rs = P.rstate[idx];
  bool on_s = P.rhz_on[idx];
  bool fwdp = P.fwd_pending[idx];

  bool is_ins = op == OP_INSERT_EDGE, is_app = op == OP_APP,
       is_alc = op == OP_ALLOC, is_sf = op == OP_SET_FUTURE,
       is_rf = op == OP_RHIZOME_FWD, is_lr = op == OP_LINK_RHIZOME;
  bool in_sec = slot >= D.root_slots && slot < D.primary_slots;
  bool inactive = in_sec && !on_s;
  bool room = ne < D.E;
  bool p_room = is_ins && !inactive && room;
  bool p_fwd = is_ins && !inactive && !room && gs == G_SET;
  bool p_defer = is_ins && !inactive && !room && gs == G_PENDING;
  bool p_null = is_ins && !inactive && !room && gs == G_NULL;
  bool p_rlink = is_ins && inactive && rs == G_NULL;
  bool p_rdef = is_ins && inactive && rs == G_PENDING;

  // a deferred insert with a full future queue rotates to the queue tail
  if ((p_defer || p_rlink || p_rdef) && fqn >= D.FQ) {
    if constexpr (C::kQb)
      copy_rec(X, X.aq + ((size_t)l * Q + fmod_(aqh + aqn, Q)) * W, mrow);
    else
      copy_msg(X.aq + ((size_t)l * Q + fmod_(aqh + aqn, Q)) * MSGW, m);
    X.aq_head[l] = fmod_(aqh + 1, Q);
    n.stall += 1;
    if constexpr (C::kTelemetry) X.count(c, TM_STALL);
    return false;
  }

  int T = 0;
  int out[MSGW] = {0, 0, 0, 0, 0};
  bool set_out = false;
  // (kQ) where out's extension words come from: zeros, the edge values of
  // the slot's values, the values, the popped record's
  enum { OX_ZERO, OX_EDGE, OX_VALS, OX_MSG };
  int ox = OX_ZERO;
  int drain_n = 0;
  if (p_room) {
    size_t e = idx * D.E + min(ne, D.E - 1);
    P.edst[e] = a0;
    P.ew[e] = i2f(a1);
    P.nedges[idx] = ne + 1;
    // propagate on insert (Listing 4, line 7); at kQ where any tenant
    // would, the message carrying every slot's edge value
    if constexpr (C::kQb) {
      bool any = false;
      for (int q = 0; q < X.qb; ++q)
        any |= reached(slot_app(P.q, q), P.vals[vi + q]);
      T = any ? 1 : 0;
      out[2] = f2i(edge_value(slot_app(P.q, 0), vs, i2f(a1)));
      ox = OX_EDGE;
    } else {
      T = reached(D.app, vs) ? 1 : 0;
      out[2] = f2i(edge_value(D.app, vs, i2f(a1)));
    }
    out[0] = OP_APP; out[1] = a0;
    set_out = true;
  } else if (p_fwd) {
    T = 1;
    out[0] = OP_INSERT_EDGE; out[1] = P.gaddr[idx]; out[2] = a0; out[3] = a1;
    set_out = true;
  } else if (p_defer || p_null || p_rlink || p_rdef) {
    int tq = fmod_(P.fq_head[idx] + fqn, D.FQ);
    int* ent = P.fq + (idx * D.FQ + tq) * 3;
    ent[0] = OP_INSERT_EDGE; ent[1] = a0; ent[2] = a1;
    P.fq_n[idx] = fqn + 1;
    X.qwork[l] += 1;
    if (p_null) {
      P.gstate[idx] = G_PENDING;
      int arot = X.arot[l];
      int tgt;
      if (D.allocator == ALLOC_RANDOM) {
        // alloc.choose_alloc_cell's hash of (cell, arot), uint32 arithmetic
        unsigned x = (unsigned)c * 0x9E3779B9u;
        if constexpr (C::kTile) x = (unsigned)X.gcell(D, c) * 0x9E3779B9u;
        x += (unsigned)arot * 0x85EBCA6Bu;
        x ^= x >> 16;
        x *= 0xC2B2AE35u;
        x ^= x >> 13;
        tgt = (int)(x % (unsigned)NC);
      } else {
        int kk = fmod_(arot, D.n_offs);
        int r = min(max(c / D.W + P.offs[2 * kk], 0), D.H - 1);
        int cc = min(max(c % D.W + P.offs[2 * kk + 1], 0), D.W - 1);
        tgt = r * D.W + cc;
        if constexpr (C::kTile) {   // in the grid's rows and columns
          r = min(max(X.grow(D, c) + P.offs[2 * kk], 0), X.GH - 1);
          cc = min(max(X.gcol(D, c) + P.offs[2 * kk + 1], 0), X.GW - 1);
          tgt = r * X.GW + cc;
        }
      }
      X.arot[l] = arot + 1;
      T = 1;
      out[0] = OP_ALLOC; out[1] = tgt * S; out[2] = dst;
      out[3] = f2i(vs);
      ox = OX_VALS;   // the requester's value vector, slots 1..
      set_out = true;
    } else if (p_rlink) {
      P.rstate[idx] = G_PENDING;
      int kk = fdiv(slot, D.root_slots), j = fmod_(slot, D.root_slots);
      int home = fmod_(c - kk * D.rhizome_stride, NC);
      if constexpr (C::kTile)
        home = fmod_(X.gcell(D, c) - kk * D.rhizome_stride, NC);
      int owner = j * NC + home;
      T = 1;
      out[0] = OP_LINK_RHIZOME; out[1] = fmod_(owner, NC) * S + fdiv(owner, NC);
      out[2] = c * S + slot;
      if constexpr (C::kTile) out[2] = X.gcell(D, c) * S + slot;
      set_out = true;
    }
  } else if (is_app || is_rf || is_rp) {
    bool changed;
    if constexpr (C::kQb) {
      // the vector relax: slot q's payload (word 2, then 4 + q), or its
      // init_val where the qsel mask (word 3, 0 = all) leaves it out
      changed = false;
      int* qsum = cca_dyn_smem + X.qsum_off;
      const int cyc = qsum[2 * X.qb];   // this cycle (qsum_cycle)
      for (int q = 0; q < X.qb; ++q) {
        int app = slot_app(P.q, q);
        float v = P.vals[vi + q];
        float inc = (a1 == 0 || ((a1 >> q) & 1))
                        ? i2f(q ? mrow[MSGW - 1 + q] : a0)
                        : fwd_neutral(app);
        bool ch = relaxes(app, inc, v);
        P.vals[vi + q] = ch ? inc : v;
        X.cemit[(size_t)l * X.qb + q] = ch ? inc : v;
        if (ch) {
          changed = true;
          atomicAdd(qsum + q, 1);
          atomicMax(qsum + X.qb + q, cyc);
        }
      }
    } else {
      float inc = i2f(a0);
      // the app's relax: a min, a max for widest and reliable, or for
      // ingest_only no change at all
      changed = relaxes(D.app, inc, vs);
      P.vals[idx] = changed ? inc : vs;
      X.cemit[l] = changed ? inc : vs;
    }
    int gl = gs != G_NULL ? 1 : 0;
    if (is_app || is_rp) {
      int n_bcast = (slot < D.root_slots && rs == G_SET) ? D.rhizome_cap - 1
                                                         : 0;
      T = changed || is_rp ? ne + n_bcast + gl : 0;
    } else {
      if (in_sec && !on_s) { P.rhz_on[idx] = true; P.rstate[idx] = G_SET; }
      drain_n = (gs != G_PENDING && ne == 0) ? fqn : 0;
      T = drain_n + (changed ? ne + gl : 0);
    }
  } else if (is_lr) {
    P.rstate[idx] = G_SET;
    T = 1;
    out[0] = OP_RHIZOME_FWD; out[1] = a0; out[2] = f2i(vs);
    ox = OX_VALS;
    set_out = true;
  } else if (is_alc) {
    int g = X.nfree[l];
    T = 1;
    if (g < S) {
      size_t gi = (size_t)c * S + g;
      if constexpr (C::kQb) {
        // the ghost starts from the requester's value vector
        for (int q = 0; q < X.qb; ++q)
          P.vals[gi * X.qb + q] = i2f(q ? mrow[MSGW - 1 + q] : a1);
      } else {
        P.vals[gi] = i2f(a1);
      }
      P.nedges[gi] = 0;
      P.gaddr[gi] = -1;
      P.gstate[gi] = G_NULL;
      X.qwork[l] -= P.fq_n[gi] + (P.fwd_pending[gi] ? 1 : 0);
      P.fq_n[gi] = 0;
      P.fq_head[gi] = 0;
      if constexpr (C::kQb) {
        for (int q = 0; q < X.qb; ++q)
          P.fwd_val[gi * X.qb + q] = fwd_neutral(slot_app(P.q, q));
      } else {
        P.fwd_val[gi] = fwd_neutral(D.app);
      }
      P.fwd_pending[gi] = false;
      X.nfree[l] = g + 1;
      n.allocs += 1;
      if constexpr (C::kTelemetry) X.count(c, TM_ALLOC);
      out[0] = OP_SET_FUTURE; out[1] = a0; out[2] = c * S + g;
      if constexpr (C::kTile) out[2] = X.gcell(D, c) * S + g;
    } else {
      out[0] = OP_ALLOC; out[1] = fmod_(c + 1, NC) * S; out[2] = a0;
      if constexpr (C::kTile) out[1] = fmod_(X.gcell(D, c) + 1, NC) * S;
      out[3] = a1;
      ox = OX_MSG;   // the request's value vector travels on
    }
    set_out = true;
  } else if (is_sf) {
    P.gaddr[idx] = a0;
    P.gstate[idx] = G_SET;
    T = fqn + (fwdp ? 1 : 0);
  }

  if constexpr (C::kQb) {
    const SlotApps sa{P.q.qapp0, P.q.qapp1, P.q.qapp2, P.q.qapp3};
    const float* v = P.vals + vi;
    const float w_ins = i2f(a1);
    if (set_out)
      put_rec(X, X.cout + (size_t)l * W, out, [=](int w) -> int {
        int q = w - (MSGW - 1);
        switch (ox) {
          case OX_EDGE: return f2i(edge_value(sa(q), v[q], w_ins));
          case OX_VALS: return f2i(v[q]);
          case OX_MSG: return mrow[w];
        }
        return 0;
      });
  } else {
    if (set_out) copy_msg(X.cout + (size_t)l * MSGW, out);
  }
  X.aq_n[l] = aqn - 1;
  X.aq_head[l] = fmod_(aqh + 1, Q);
  if (T > 0) X.cvalid[l] = true; else n.exec += 1;
  if constexpr (C::kQb)
    copy_rec(X, X.cmsg + (size_t)l * W, mrow);
  else
    copy_msg(X.cmsg + (size_t)l * MSGW, m);
  X.cphase[l] = 1;
  X.cT[l] = T;
  X.cdrain[l] = is_rf ? drain_n : 0;
  if constexpr (C::kTelemetry) X.count(c, TM_EXEC);
  return true;
}

// ingest.io_stage for IO cell i (attached to row-0 cell i; kTl: of the
// grid).  The insert
// goes to the source's rhizome root k with the least dist + pref *
// half_diam (Manhattan distance from (0, i), pref = (k - pos) mod R), the
// lowest k on a tie; the edge's destination names its canonical root.  The
// fault instance seals the message, and turns a repair sentinel row (vid,
// -(k+1), value bits) into an OP_REPAIR at vid's rhizome root k.
template <class C>
__device__ void io(const Dims& D, const Leaves& P, const C& X, int i) {
  int pos = X.io_pos[i];
  if (pos >= X.io_n[i]) return;
  const int* e = P.io_edges + ((size_t)i * D.IOL + min(pos, D.IOL - 1)) * 3;
  int NC = D.H * D.W, R = D.rhizome_cap;
  if constexpr (C::kTile) NC = X.GH * X.GW;
  int tgt = fmod_(e[0], NC) * D.S + fdiv(e[0], NC);   // root 0
  if (R > 1) {
    int half_diam = max(1, (D.H + D.W - 2) / 2), best = 0;
    if constexpr (C::kTile) half_diam = max(1, (X.GH + X.GW - 2) / 2);
    for (int k = 0; k < R; ++k) {
      int cell = fmod_(e[0] + k * D.rhizome_stride, NC);
      int score = fdiv(cell, D.W) + abs(fmod_(cell, D.W) - i) +
                  fmod_(k - pos, R) * half_diam;
      if constexpr (C::kTile)
        score = fdiv(cell, X.GW) + abs(fmod_(cell, X.GW) - i) +
                fmod_(k - pos, R) * half_diam;
      if (k == 0 || score < best) {
        best = score;
        tgt = cell * D.S + k * D.root_slots + fdiv(e[0], NC);
      }
    }
  }
  int msg[MSGW];
  msg[0] = OP_INSERT_EDGE;
  msg[1] = tgt;
  msg[2] = fmod_(e[1], NC) * D.S + fdiv(e[1], NC);
  msg[3] = e[2];
  msg[4] = 0;
  if constexpr (C::kFaults) {
    if (e[1] < 0) {
      int k = -e[1] - 1;
      tgt = fmod_(e[0] + k * D.rhizome_stride, NC) * D.S +
            k * D.root_slots + fdiv(e[0], NC);
      msg[0] = OP_REPAIR; msg[1] = tgt; msg[2] = e[2]; msg[3] = 0;
    }
    msg[4] = msg_seal(msg);
  }
  if constexpr (C::kTile) {   // the arrays' cell of grid cell (0, i)
    const int lc = -X.tr0 * D.W + i - X.tc0;
    int tb = yx_tb_w(X.GW, fdiv(tgt, D.S), 0, i);
    if (deliver(D, X, lc, msg, tb, msg_lane(D, msg[0], msg[1]),
                X.aq_n[X.l(lc)] < D.Q - D.aq_reserve - D.sys_reserve)) {
      X.io_pos[i] = pos + 1;
      if constexpr (C::kTelemetry) X.count(lc, TM_IO);
    }
    return;
  }
  int tb = yx_tb(D, fdiv(tgt, D.S), 0, i);
  if (deliver(D, X, i, msg, tb, msg_lane(D, msg[0], msg[1]),
              X.aq_n[X.l(i)] < D.Q - D.aq_reserve - D.sys_reserve)) {
    X.io_pos[i] = pos + 1;
    if constexpr (C::kTelemetry) X.count(i, TM_IO);   // row 0, column i
  }
}

// engine.quiescent, per cell: any queued, in-flight, active, deferred or
// streamed work left at cell c.
template <class C>
__device__ __forceinline__ bool cell_busy(const Dims& D, const C& X, int c) {
  int l = X.l(c);
  if constexpr (C::kTile) {   // its IO cell, by its id in the grid
    const int gc = X.gcell(D, c);
    if (gc < D.IO && X.io_n[gc] != X.io_pos[gc]) return true;
    if (X.aq_n[l] != 0 || X.pk_n[l] != 0 || X.cvalid[l] || X.qwork[l] != 0)
      return true;
  } else if (X.aq_n[l] != 0 || X.pk_n[l] != 0 || X.cvalid[l] ||
             X.qwork[l] != 0 || (c < D.IO && X.io_n[c] != X.io_pos[c])) {
    return true;
  }
  const int* chn = X.ch_n + l * 4 * D.L;
#pragma unroll 4
  for (int k = 0; k < 4 * D.L; ++k)
    if (chn[k] != 0) return true;
  return false;
}

// Sum over cell c's slots of fq_n + fwd_pending: the deferred work that
// quiescence waits for, kept per cell in qwork over the launch.
template <class C>
__device__ void init_qwork(const Dims& D, const Leaves& P, const C& X,
                           int c) {
  int w = 0;
  for (int s = 0; s < D.S; ++s) {
    size_t idx = (size_t)c * D.S + s;
    w += P.fq_n[idx] + (P.fwd_pending[idx] ? 1 : 0);
  }
  X.qwork[X.l(c)] = w;
}

// Messages in cell c's channels (every lane) and park ring.
template <class C>
__device__ __forceinline__ int cell_in_flight(const Dims& D, const C& X,
                                              int c) {
  int l = X.l(c);
  const int* chn = X.ch_n + l * 4 * D.L;
  int n = X.pk_n[l];
  for (int k = 0; k < 4 * D.L; ++k) n += chn[k];
  return n;
}

// Telemetry at cycle entry: each lane's occupancy of cell c into TM_L_OCC.
template <class C>
__device__ void tm_occupancy(const Dims& D, const C& X, int c) {
  const int* chn = X.ch_n + X.l(c) * 4 * D.L;
  int* tl = X.tm_lane + (size_t)c * 4 * D.L * N_TM_LANE;
  for (int k = 0; k < 4 * D.L; ++k)
    if (chn[k]) atomicAdd(tl + k * N_TM_LANE + TM_L_OCC, chn[k]);
}

// Telemetry after the cell's exec stages: its queue hi-water marks (a
// depth of 0 is skipped: the marks start at 0 each increment and only grow).
template <class C>
__device__ __forceinline__ void tm_hiwater(const C& X, int c) {
  int* hw = X.tm_hiw + (size_t)c * N_TM_HIW;
  int aqn = X.aq_n[X.l(c)], pkn = X.pk_n[X.l(c)];
  if (aqn) atomicMax(hw + TM_HW_AQ, aqn);
  if (pkn) atomicMax(hw + TM_HW_PK, pkn);
}

// (kQ) The word of the CTA's per-query sums that holds the current cycle.
template <class C>
__device__ __forceinline__ int& qsum_cycle(const C& X) {
  return cca_dyn_smem[X.qsum_off + 2 * X.qb];
}

// Up to D.n_cycles machine cycles over the band of X, frozen at quiescence;
// the schedule of both kernels.  Returns the cycles run; `quiet` is the
// quiescence test's last value.  With P.trace, each thread counts its
// cells' activity in the exec loop and their channel occupancy in the next
// quiescence test (the one after a launch's last cycle too), and each warp
// adds its sums into the cycle's trace row: no barrier of its own.
//
// The tile instances (kTl) run at most one cycle (D.n_cycles 1): the first
// quiescence test is the grid's, the flag the ranks reduced after the last
// cycle (*gquiet: a tile quiescent alone must not freeze), and the test
// after the cycle is over the cells it owns, for the ranks to reduce again.
// They count, trace, test and run the exec stages of their owned cells
// only; the hop stage runs over every cell of the arrays, so that the owned
// cells receive from the halo exactly.
template <bool kCluster, bool kTm, bool kFlt, bool kQ, bool kTl>
__device__ int run_cycles(const Dims& D, const Leaves& P,
                          const Cells<kCluster, kTm, kFlt, kQ, kTl>& X,
                          Counts& n, int& quiet, PhaseClock& clk) {
  const int first = X.c0 + threadIdx.x, end = X.c0 + X.nb,
            nt = blockDim.x;
  // the machine cycle at launch start (the fault hash's and qlast's;
  // *P.cycle is written only after the last cycle)
  int cycle0 = 0;
  if constexpr (kFlt || kQ) cycle0 = *P.cycle;
  int ran = 0;
  for (;;) {
    int busy = 0;
    if constexpr (kTl) {
      if (ran == 0) {
        quiet = *X.gquiet;
        __syncthreads();   // the prologue's writes before the hop reads
      } else {
        for (int c = first; c < end; c += nt)
          if (X.owns(D, c)) busy |= cell_busy(D, X, c);
        quiet = !X.any(busy);
      }
    } else {
#ifdef CCA_SKELETON
    busy = 1;
#else
    for (int c = first; c < end; c += nt) busy |= cell_busy(D, X, c);
#endif
    quiet = !X.any(busy);
    }
    if (P.trace && ran > 0) {
      int in_flight = 0;
      for (int c = first; c < end; c += nt) {
        if constexpr (kTl)
          if (!X.owns(D, c)) continue;
        in_flight += cell_in_flight(D, X, c);
      }
      trace_add(P.trace + 2 * (ran - 1) + 1, in_flight);
    }
    clk.stamp(0);
    if (quiet || ran == D.n_cycles) break;
    // (kQ) this cycle for phase 0's qlast, read after the hop barriers
    if constexpr (kQ)
      if (threadIdx.x == 0) qsum_cycle(X) = cycle0 + ran;
    if constexpr (kTm)
      for (int c = first; c < end; c += nt) tm_occupancy(D, X, c);
#pragma unroll
    for (int d = 0; d < 4; ++d) {
#ifndef CCA_SKELETON
      for (int c = first; c < end; c += nt)
        hop_read(D, P, X, c, d, cycle0 + ran, n);
#endif
      X.sync(2 * d);
      clk.stamp(1 + 2 * d);
#ifndef CCA_SKELETON
      for (int c = first; c < end; c += nt) {
        if constexpr (kTl) {
          int h = hop_write(D, X, c, d, n);
          if (X.owns(D, c)) n.hops += h;
        } else {
          n.hops += hop_write(D, X, c, d, n);
        }
      }
#endif
      X.sync(2 * d + 1);
      clk.stamp(2 + 2 * d);
    }
#ifndef CCA_SKELETON
    int active = 0;
    for (int c = first; c < end; c += nt) {
      if constexpr (kTl)
        if (!X.owns(D, c)) continue;
      bool busy0 = X.cvalid[X.l(c)];
      if (D.L > 1) park(D, P, X, c);
      bool staged = staging(D, P, X, c, n);
      bool popped = phase0(D, P, X, c, busy0, n);
      active += staged | popped;
      if constexpr (kTl) {
        if (X.gcell(D, c) < D.IO) io(D, P, X, X.gcell(D, c));
      } else {
      if (c < D.IO) io(D, P, X, c);
      }
      if constexpr (kTm) tm_hiwater(X, c);
    }
    if (P.trace) trace_add(P.trace + 2 * ran, active);
#endif
    clk.stamp(9);
    ++ran;
  }
  return ran;
}

// The one-block kernel's view of the per-cell leaves: the whole grid in
// device memory, one outbox and grant buffer for the four rounds.  Built on
// the host and passed as a kernel parameter, as the leaves are, so its
// pointers are read from parameter space and held in no register.
template <bool kTm, bool kFlt, bool kQ, bool kTl>
Cells<false, kTm, kFlt, kQ, kTl> device_cells(const Dims& D, const Leaves& P,
                                              const TileGeo<kTl>& T) {
  Cells<false, kTm, kFlt, kQ, kTl> X;
  X.aq = P.aq; X.aq_n = P.aq_n; X.aq_head = P.aq_head;
  X.ch = P.ch; X.ch_n = P.ch_n; X.ch_head = P.ch_head; X.ch_rr = P.ch_rr;
  X.pk_n = P.pk_n; X.cmsg = P.cmsg; X.cvalid = P.cvalid;
  X.cphase = P.cphase; X.cT = P.cT; X.cemit = P.cemit; X.cout = P.cout;
  X.cdrain = P.cdrain; X.arot = P.arot; X.nfree = P.nfree;
  X.io_n = P.io_n; X.io_pos = P.io_pos; X.qwork = P.qwork;
  X.outbox = P.outbox; X.grant = P.grant;
  X.tm_cell = P.tm_cell; X.tm_lane = P.tm_lane; X.tm_hiw = P.tm_hiw;
  X.c0 = 0; X.nb = D.H * D.W; X.box_dir = 0; X.grant_dir = 0;
  X.rank = 0; X.n_ctas = 1; X.qflag = nullptr;
  X.mw = P.q.msgw; X.qb = P.q.qb; X.qsum_off = 0;
  if constexpr (kTl) static_cast<TileGeo<true>&>(X) = T;
  return X;
}

// (kQ) The CTA's per-query sums in cca_dyn_smem: qchg counts at 0..Q-1,
// qlast maxima (-1: none) at Q..2Q-1, and at 2Q the current machine cycle
// (thread 0 writes it as a cycle starts).  Set before the first quiescence
// test's barrier; added into the state's qchg / qlast once a launch, after
// the last one's.
template <class C>
__device__ void qsum_init(const C& X) {
  if constexpr (C::kQb) {
    int* sum = cca_dyn_smem + X.qsum_off;
    for (int i = threadIdx.x; i < 2 * X.qb; i += blockDim.x)
      sum[i] = i < X.qb ? 0 : -1;
  }
}
template <class C>
__device__ void qsum_flush(const Leaves& P, const C& X) {
  if constexpr (C::kQb) {
    __syncthreads();
    const int* sum = cca_dyn_smem + X.qsum_off;
    for (int q = threadIdx.x; q < X.qb; q += blockDim.x) {
      if (sum[q]) atomicAdd(P.qchg + q, sum[q]);
      if (sum[X.qb + q] >= 0) atomicMax(P.qlast + q, sum[X.qb + q]);
    }
  }
}

// (fault instances) Add the CTA's fault counts into P.flt: one sum a
// counter in `sum` (N_FLT ints of shared memory), one atomic a counter a
// CTA.  The threads that read `sum` last are the ones that reset it next.
template <bool kFlt>
__device__ void add_flt(const Leaves& P, int* sum, const Counts& n) {
  if constexpr (kFlt) {
    if (threadIdx.x < N_FLT) sum[threadIdx.x] = 0;
    __syncthreads();
    if (n.drop) atomicAdd(&sum[FLT_DROP], n.drop);
    if (n.dup) atomicAdd(&sum[FLT_DUP], n.dup);
    if (n.corrupt) atomicAdd(&sum[FLT_CORRUPT], n.corrupt);
    if (n.blackout) atomicAdd(&sum[FLT_BLACKOUT], n.blackout);
    __syncthreads();
    if (threadIdx.x < N_FLT && sum[threadIdx.x])
      atomicAdd(P.flt + threadIdx.x, sum[threadIdx.x]);
  }
}

template <bool kTm, bool kFlt, bool kQ, bool kTl>
__global__ void __launch_bounds__(1024, 1)
cca_cycle_kernel(const Dims D, const Leaves P,
                 const Cells<false, kTm, kFlt, kQ, kTl> X) {
  PhaseClock clk;
  clk.start();
  const int NC = D.H * D.W, tid = threadIdx.x, nt = blockDim.x;
  for (int c = tid; c < NC; c += nt) init_qwork(D, P, X, c);
  qsum_init(X);
  // the trace rows start at 0 (the first quiescence test's barrier orders
  // this before any warp adds into them)
  if (P.trace)
    for (int i = tid; i < 2 * D.n_cycles; i += nt) P.trace[i] = 0;
  clk.stamp(10);
  Counts n = {0, 0, 0, 0, 0, 0, 0, 0};
  int quiet;
  int ran = run_cycles(D, P, X, n, quiet, clk);
  qsum_flush(P, X);
  __shared__ int sum[4];
  add_flt<kFlt>(P, sum, n);
  if (tid < 4) sum[tid] = 0;
  __syncthreads();
  atomicAdd(&sum[0], n.hops);
  atomicAdd(&sum[1], n.exec);
  atomicAdd(&sum[2], n.stall);
  atomicAdd(&sum[3], n.allocs);
  __syncthreads();
  if (tid == 0) {
    *P.cycle += ran;
    *P.stat_hops += sum[0];
    *P.stat_exec += sum[1];
    *P.stat_stall += sum[2];
    *P.stat_allocs += sum[3];
    P.rec[0] = *P.cycle;
    P.rec[1] = *P.stat_hops;
    P.rec[2] = *P.stat_exec;
    P.rec[3] = *P.stat_stall;
    P.rec[4] = *P.stat_allocs;
    P.rec[5] = quiet;
    P.rec[6] = ran;
    P.rec[7] = 0;
  }
  clk.stamp(11);
  clk.flush(0);
}

// Launch the one-block kernel's instance (kTm, kFlt, kQ, kTl); kQ takes
// its per-query sums as dynamic shared memory.
template <bool kTm, bool kFlt, bool kQ, bool kTl>
void block_launch(const Dims& D, const Leaves& P, const TileGeo<true>& T,
                  int threads, cudaStream_t stream) {
  const int smem = kQ ? (2 * P.q.qb + 1) * (int)sizeof(int) : 0;
  TileGeo<kTl> t;
  if constexpr (kTl) t = T;
  cca_cycle_kernel<kTm, kFlt, kQ, kTl><<<1, threads, smem, stream>>>(
      D, P, device_cells<kTm, kFlt, kQ, kTl>(D, P, t));
}

}  // namespace

#include "cca_cycle_cluster.cuh"

// Launch one chunk on `stream`.  `ptrs` holds N_PTRS device pointers in the
// order of Leaves and the grid's quiescence flag (null but for a tile),
// `dims` N_DIMS ints in the order of Dims, N_QDIMS of QDims and N_TDIMS of
// TDims.  Writes the
// kernel launched to `*path` (0 the one-block kernel, 1 the cluster
// kernel).  Returns 0 when the kernel was queued, a CUDA error code, or a
// negative code of this file (`cca_cycle_error_string`).
extern "C" int cca_cycle_launch(void* const* ptrs, int n_ptrs,
                                const int* dims, int n_dims, void* stream,
                                int* path) {
  if (n_ptrs != N_PTRS + 1 || n_dims != N_DIMS + N_QDIMS + N_TDIMS)
    return cudaErrorInvalidValue;
  Dims D;
  Leaves P;
  TDims Td;
  memcpy(&D, dims, sizeof(D));
  memcpy(&P, ptrs, N_PTRS * sizeof(void*));
  memcpy(&P.q, dims + N_DIMS, sizeof(QDims));
  memcpy(&Td, dims + N_DIMS + N_QDIMS, sizeof(TDims));
  const TileGeo<true> T = {Td.GH, Td.GW, Td.r0, Td.c0, Td.or0, Td.or1,
                           Td.oc0, Td.oc1, (const int*)ptrs[N_PTRS]};
  // no instance has both faults and query batching (the config refuses it)
  const QDims& Q = P.q;
  if (Q.qb < 1 || Q.qb > MAX_QB || Q.msgw != MSGW + Q.qb - 1 ||
      (D.faults && Q.qb > 1))
    return cudaErrorInvalidValue;
  // the tile instances run one cycle, against the grid's flag
  if (Td.tile && (D.n_cycles > 1 || !T.gquiet)) return ERR_TILE;
  if (!Td.tile != !CCA_TILES) return ERR_LIBRARY;
  if (D.n_ctas > 0) {
    int err = cluster_launch(D, P, Td.tile, T, (cudaStream_t)stream);
    if (err) return err;
    *path = 1;
    return 0;
  }
  int cells = D.H * D.W;
  int threads = cells < 1024 ? cells : 1024;
  constexpr bool kTl = CCA_TILES;
  void (*launch)(const Dims&, const Leaves&, const TileGeo<true>&, int,
                 cudaStream_t) =
      Q.qb > 1 ? (D.telemetry ? block_launch<true, false, true, kTl>
                              : block_launch<false, false, true, kTl>)
      : D.telemetry ? (D.faults ? block_launch<true, true, false, kTl>
                                : block_launch<true, false, false, kTl>)
                    : (D.faults ? block_launch<false, true, false, kTl>
                                : block_launch<false, false, false, kTl>);
  launch(D, P, T, threads, (cudaStream_t)stream);
  int err = cudaGetLastError();
  if (!err) *path = 0;
  return err;
}

// Shared memory a CTA of the cluster kernel takes for `dims`' geometry, in
// bytes (the layout of `cluster_layout`), or a negative code if the
// geometry is not one the cluster kernel runs.
extern "C" int cca_cycle_cluster_smem(const int* dims, int n_dims) {
  if (n_dims != N_DIMS + N_QDIMS + N_TDIMS) return ERR_GEOMETRY;
  Dims D;
  QDims Q;
  TDims T;
  memcpy(&D, dims, sizeof(D));
  memcpy(&Q, dims + N_DIMS, sizeof(Q));
  memcpy(&T, dims + N_DIMS + N_QDIMS, sizeof(T));
  if (!cluster_geometry_ok(D, Q, T.tile)) return ERR_GEOMETRY;
  return layout_of(D, Q).bytes;
}

// Text of a code returned by cca_cycle_launch, for the wrapper's exception.
extern "C" const char* cca_cycle_error_string(int err) {
  if (err < 0) return cluster_error_string(err);
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

#ifdef CCA_PHASE_CLOCKS
// Copy the last launch's phase clocks, [MAX_CTAS][N_PHASES] int64, to
// `out` on the host (synchronising).  Returns a CUDA error code.
extern "C" int cca_cycle_clocks(long long* out) {
  return cudaMemcpyFromSymbol(out, cca_clocks, sizeof(cca_clocks));
}
#endif
