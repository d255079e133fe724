// Fused cycle kernel of the AM-CCA machine: up to K engine cycles per launch.
//
// Replaces the TPU kernel `repro/kernels/cca_cycle/kernel.py::cycle_megakernel`
// (launched by `repro/kernels/cca_cycle/ops.py::cca_cycle_chunk`), whose
// semantics are `repro/kernels/cca_cycle/ref.py::frozen_cycles`: run K =
// cfg.chunk cycles of `engine.cycle_body` (hop -> staging -> phase0 -> io),
// freeze at quiescence, and report an int32 record [cycle, stat_hops,
// stat_exec, stat_stall, stat_allocs, quiescent, cycles_run, 0].  Its plain
// PyTorch version is `repro_torch/kernels/cca_cycle/ref.py`; running this
// kernel equals it leaf for leaf and bit for bit.  Scope: lanes=1,
// rhizome_cap=1 (the rhizome handlers are carried but unreachable there),
// qbatch=1, no telemetry, no faults, apps bfs/sssp/cc.
//
// What bounds it.  Not bytes: the mutable state (85.6 MiB at the paper's
// 50K-vertex config, 7.8 MiB at 2000 vertices) is read and written once per
// launch at best, ~54 us over 3.35 TB/s, while a launch runs up to 512
// dependent machine cycles, each a chain of scattered single-word loads and
// stores per cell with ~10 block barriers between its phases.  Latency of
// that chain and the barriers bound it.
//
// Why one block.  Every stage of the reference is a whole-grid array
// operation that reads the state as it stood before the stage, so a cycle
// needs a barrier between each read phase and its write phase.  One thread
// block of up to 1024 threads -- one thread per cell, a thread striding over
// cells on grids above 1024 cells -- gets that from __syncthreads() with no
// grid-wide synchronisation; the state stays in device memory (in L2 at the
// small configs).  The hop stage runs four direction rounds N, S, W, E, each
// a read phase (phase A: every sender checks admissibility at its receiver
// and copies its granted head into the outbox) and a write phase (phase B:
// every receiver pushes its neighbour's outbox message, then pops its own
// granted lane -- push before pop on one ring, as the reference does).
// Staging, phase 0 and io touch only the thread's own cell (io only row-0
// cell i for IO cell i), so they run back to back without barriers.
// Quiescence is one __syncthreads_or per cycle over per-cell work flags;
// the per-cell sum of fq_n and fwd_pending over the slots is kept
// incrementally in `qwork` so the test does not rescan S slots per cycle.
//
// Arithmetic is the reference's: floor division and modulo (fdiv/fmod),
// float payloads moved only by bit-cast, min-relax as `inc < v ? inc : v`,
// single IEEE adds (built with --fmad=false).  Bool leaves are torch.bool
// (one byte, 0 or 1) and are updated in place as bytes.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

enum { OP_NOP = 0, OP_INSERT_EDGE = 1, OP_APP = 2, OP_ALLOC = 3,
       OP_SET_FUTURE = 4, OP_RHIZOME_FWD = 5, OP_LINK_RHIZOME = 6 };
enum { TB_N = 0, TB_S = 1, TB_W = 2, TB_E = 3, TB_AQ = 4 };
enum { G_NULL = 0, G_PENDING = 1, G_SET = 2 };
enum { APP_BFS = 0, APP_SSSP = 1, APP_CC = 2 };
constexpr int MSGW = 5;
constexpr float INF = 1e9f;

// Scalar geometry, in the order of ops.py::_dims.
struct Dims {
  int H, W, S, E, Q, FQ, LC, IO, IOL;
  int root_slots, primary_slots, rhizome_cap, rhizome_stride;
  int aq_reserve, sys_reserve, n_offs, app, n_cycles;
};
constexpr int N_DIMS = sizeof(Dims) / sizeof(int);

// Device pointers, in the order of ops.py::KERNEL_POINTERS.
struct Leaves {
  float* vals; int* nedges; int* edst; float* ew; int* gaddr; int* gstate;
  bool* rhz_on; int* rstate; int* nfree;
  int* fq; int* fq_n; int* fq_head; float* fwd_val; bool* fwd_pending;
  int* aq; int* aq_n; int* aq_head;
  int* ch; int* ch_n; int* ch_head; int* ch_rr;
  int* pk_n;
  int* cmsg; bool* cvalid; int* cphase; int* cT; float* cemit; int* cout;
  int* cdrain;
  const int* io_edges; int* io_n; int* io_pos;
  int* arot;
  int* cycle; int* stat_hops; int* stat_exec; int* stat_stall;
  int* stat_allocs;
  const int* offs;   // [n_offs, 2] vicinity (dy, dx) table
  int* outbox;       // [cells, MSGW] granted heads of the current round
  int* grant;        // [cells]
  int* qwork;        // [cells] sum over slots of fq_n + fwd_pending
  int* rec;          // [8] the launch record
};
constexpr int N_PTRS = sizeof(Leaves) / sizeof(void*);

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

// Action-queue admission of an external push (hop / io stage).
__device__ __forceinline__ bool ext_room(const Dims& D, int op, int aq_n) {
  return is_protocol(op) ? aq_n < D.Q - D.aq_reserve
                         : aq_n < D.Q - D.aq_reserve - D.sys_reserve;
}

__device__ __forceinline__ float edge_value(int app, float v, float w) {
  if (app == APP_BFS) return __fadd_rn(v, 1.0f);
  if (app == APP_SSSP) return __fadd_rn(v, w);
  return v;
}

__device__ __forceinline__ void copy_msg(int* dst, const int* src) {
#pragma unroll
  for (int w = 0; w < MSGW; ++w) dst[w] = src[w];
}

// routing.deliver for one cell: the local action queue (tb == TB_AQ, gated
// by aq_room) or lane 0 of channel tb (gated by lane capacity).
__device__ bool deliver(const Dims& D, const Leaves& P, int c,
                        const int* msg, int tb, bool aq_room) {
  if (tb == TB_AQ) {
    if (!aq_room) return false;
    int n = P.aq_n[c];
    int tail = fmod_(P.aq_head[c] + n, D.Q);
    copy_msg(P.aq + ((size_t)c * D.Q + tail) * MSGW, msg);
    P.aq_n[c] = n + 1;
    return true;
  }
  if (tb < 0 || tb > 3) return false;
  int k = c * 4 + tb;
  int n = P.ch_n[k];
  if (n >= D.LC) return false;
  int tail = fmod_(P.ch_head[k] + n, D.LC);
  copy_msg(P.ch + ((size_t)k * D.LC + tail) * MSGW, msg);
  P.ch_n[k] = n + 1;
  return true;
}

__constant__ int kDy[4] = {-1, 1, 0, 0};  // N, S, W, E
__constant__ int kDx[4] = {0, 0, -1, 1};

// Hop phase A: cell c as the sender on link d.
__device__ void hop_read(const Dims& D, const Leaves& P, int c, int d) {
  int row = c / D.W, col = c % D.W;
  int rr = row + kDy[d], rc = col + kDx[d];
  int k = c * 4 + d;
  bool granted = false;
  if (rr >= 0 && rr < D.H && rc >= 0 && rc < D.W && P.ch_n[k] > 0) {
    int recv = rr * D.W + rc;
    const int* head =
        P.ch + ((size_t)k * D.LC + fmod_(P.ch_head[k], D.LC)) * MSGW;
    int tb = yx_tb(D, fdiv(head[1], D.S), rr, rc);
    bool adm = tb == TB_AQ ? ext_room(D, head[0], P.aq_n[recv])
                           : P.ch_n[recv * 4 + tb] < D.LC;
    if (adm) {
      granted = true;
      copy_msg(P.outbox + (size_t)c * MSGW, head);
    }
  }
  P.grant[c] = granted;
}

// Hop phase B: cell c receives its link-d neighbour's granted head, then
// pops its own granted head.  Returns the flits accepted here.
__device__ int hop_write(const Dims& D, const Leaves& P, int c, int d) {
  int row = c / D.W, col = c % D.W;
  int sr = row - kDy[d], sc = col - kDx[d];
  int hops = 0;
  if (sr >= 0 && sr < D.H && sc >= 0 && sc < D.W) {
    int snd = sr * D.W + sc;
    if (P.grant[snd]) {
      const int* msg = P.outbox + (size_t)snd * MSGW;
      int tb = yx_tb(D, fdiv(msg[1], D.S), row, col);
      hops = deliver(D, P, c, msg, tb, ext_room(D, msg[0], P.aq_n[c]));
    }
  }
  if (P.grant[c]) {
    int k = c * 4 + d;
    P.ch_n[k] -= 1;
    P.ch_head[k] = fmod_(P.ch_head[k] + 1, D.LC);
    P.ch_rr[k] = 0;  // (granted lane + 1) % lanes, lanes == 1
  }
  return hops;
}

struct Counts { int hops, exec, stall, allocs; };

// exec_stage.staging_stage for cell c: the active action stages its next
// emission.
__device__ void staging(const Dims& D, const Leaves& P, int c, Counts& n) {
  if (!P.cvalid[c]) return;
  int cphase = P.cphase[c], cT = P.cT[c];
  if (cphase < 1 || cphase > cT) return;
  const int* cm = P.cmsg + (size_t)c * MSGW;
  int op = cm[0], dst = cm[1];
  int S = D.S, slot = fmod_(dst, S);
  size_t idx = (size_t)c * S + slot;
  int k = cphase - 1, cdrain = P.cdrain[c];
  float cemit = P.cemit[c];
  bool is_app = op == OP_APP, is_sf = op == OP_SET_FUTURE,
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
  if (is_appl) {
    if (rf_drain) {
      emis[0] = OP_INSERT_EDGE; emis[1] = dst; emis[2] = fq_e[1];
      emis[3] = fq_e[2];
    } else if (appl_is_fwd) {
      emis[0] = OP_APP; emis[1] = ga; emis[2] = f2i(cemit);
    } else if (is_bcast) {
      int v = slot * (D.H * D.W) + c;
      int hi = D.rhizome_cap > 1 ? D.rhizome_cap - 1 : 1;
      int sib = min(max(kd - ne + 1, 1), hi);
      int cell = fmod_(v + sib * D.rhizome_stride, D.H * D.W);
      emis[0] = OP_RHIZOME_FWD;
      emis[1] = cell * S + sib * D.root_slots + fdiv(v, D.H * D.W);
      emis[2] = f2i(cemit);
    } else {
      int ek = min(max(kd, 0), D.E - 1);
      emis[0] = OP_APP;
      emis[1] = P.edst[idx * D.E + ek];
      emis[2] = f2i(edge_value(D.app, cemit, P.ew[idx * D.E + ek]));
    }
  } else if (is_sf) {
    if (sf_from_fq) {
      if (fq_e[0] == OP_INSERT_EDGE) {
        emis[0] = OP_INSERT_EDGE; emis[1] = ga; emis[2] = fq_e[1];
        emis[3] = fq_e[2];
      } else {
        emis[0] = OP_APP; emis[1] = ga; emis[2] = fq_e[1];
      }
    } else {
      emis[0] = OP_APP; emis[1] = ga; emis[2] = f2i(P.fwd_val[idx]);
    }
  } else {
    copy_msg(emis, P.cout + (size_t)c * MSGW);
  }

  // an app forward onto a pending future coalesces into the monotone
  // forward register instead of entering the network (never stalls)
  bool to_reg = appl_is_fwd && gs == G_PENDING;
  bool ok_total;
  if (to_reg) {
    float fv = P.fwd_val[idx];
    P.fwd_val[idx] = cemit < fv ? cemit : fv;
    if (!P.fwd_pending[idx]) { P.fwd_pending[idx] = true; P.qwork[c] += 1; }
    ok_total = true;
  } else {
    int tb = yx_tb(D, fdiv(emis[1], S), c / D.W, c % D.W);
    ok_total = deliver(D, P, c, emis, tb, P.aq_n[c] < D.Q);
  }
  if (ok_total && (sf_from_fq || rf_drain)) {
    P.fq_n[idx] = fqn - 1;
    P.fq_head[idx] = fmod_(fqh + 1, D.FQ);
    P.qwork[c] -= 1;
  }
  if (ok_total && sf_from_fwd) {
    P.fwd_val[idx] = INF;
    if (P.fwd_pending[idx]) { P.fwd_pending[idx] = false; P.qwork[c] -= 1; }
  }
  int new_phase = cphase + (ok_total ? 1 : 0);
  P.cphase[c] = new_phase;
  if (ok_total && new_phase > cT) { P.cvalid[c] = false; n.exec += 1; }
  if (!ok_total) n.stall += 1;
}

// exec_stage.phase0_stage for cell c: an idle cell pops one action and runs
// its computing instruction.
__device__ void phase0(const Dims& D, const Leaves& P, int c, bool busy0,
                       Counts& n) {
  int aqn = P.aq_n[c];
  if (busy0 || aqn <= 0) return;
  int S = D.S, NC = D.H * D.W, Q = D.Q;
  int aqh = P.aq_head[c];
  int m[MSGW];
  copy_msg(m, P.aq + ((size_t)c * Q + fmod_(aqh, Q)) * MSGW);
  int op = m[0], dst = m[1], a0 = m[2], a1 = m[3];
  int slot = fmod_(dst, S);
  size_t idx = (size_t)c * S + slot;
  float vs = P.vals[idx];
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
    copy_msg(P.aq + ((size_t)c * Q + fmod_(aqh + aqn, Q)) * MSGW, m);
    P.aq_head[c] = fmod_(aqh + 1, Q);
    n.stall += 1;
    return;
  }

  int T = 0;
  int out[MSGW] = {0, 0, 0, 0, 0};
  bool set_out = false;
  int drain_n = 0;
  if (p_room) {
    size_t e = idx * D.E + min(ne, D.E - 1);
    P.edst[e] = a0;
    P.ew[e] = i2f(a1);
    P.nedges[idx] = ne + 1;
    T = vs < INF ? 1 : 0;
    out[0] = OP_APP; out[1] = a0;
    out[2] = f2i(edge_value(D.app, vs, i2f(a1)));
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
    P.qwork[c] += 1;
    if (p_null) {
      P.gstate[idx] = G_PENDING;
      int arot = P.arot[c];
      int kk = fmod_(arot, D.n_offs);
      int r = min(max(c / D.W + P.offs[2 * kk], 0), D.H - 1);
      int cc = min(max(c % D.W + P.offs[2 * kk + 1], 0), D.W - 1);
      P.arot[c] = arot + 1;
      T = 1;
      out[0] = OP_ALLOC; out[1] = (r * D.W + cc) * S; out[2] = dst;
      out[3] = f2i(vs);
      set_out = true;
    } else if (p_rlink) {
      P.rstate[idx] = G_PENDING;
      int kk = fdiv(slot, D.root_slots), j = fmod_(slot, D.root_slots);
      int home = fmod_(c - kk * D.rhizome_stride, NC);
      int owner = j * NC + home;
      T = 1;
      out[0] = OP_LINK_RHIZOME; out[1] = fmod_(owner, NC) * S + fdiv(owner, NC);
      out[2] = c * S + slot;
      set_out = true;
    }
  } else if (is_app || is_rf) {
    float inc = i2f(a0);
    bool changed = inc < vs;
    P.vals[idx] = changed ? inc : vs;
    P.cemit[c] = changed ? inc : vs;
    int gl = gs != G_NULL ? 1 : 0;
    if (is_app) {
      int n_bcast = (slot < D.root_slots && rs == G_SET) ? D.rhizome_cap - 1
                                                         : 0;
      T = changed ? ne + n_bcast + gl : 0;
    } else {
      if (in_sec && !on_s) { P.rhz_on[idx] = true; P.rstate[idx] = G_SET; }
      drain_n = (gs != G_PENDING && ne == 0) ? fqn : 0;
      T = drain_n + (changed ? ne + gl : 0);
    }
  } else if (is_lr) {
    P.rstate[idx] = G_SET;
    T = 1;
    out[0] = OP_RHIZOME_FWD; out[1] = a0; out[2] = f2i(vs);
    set_out = true;
  } else if (is_alc) {
    int g = P.nfree[c];
    T = 1;
    if (g < S) {
      size_t gi = (size_t)c * S + g;
      P.vals[gi] = i2f(a1);
      P.nedges[gi] = 0;
      P.gaddr[gi] = -1;
      P.gstate[gi] = G_NULL;
      P.qwork[c] -= P.fq_n[gi] + (P.fwd_pending[gi] ? 1 : 0);
      P.fq_n[gi] = 0;
      P.fq_head[gi] = 0;
      P.fwd_val[gi] = INF;
      P.fwd_pending[gi] = false;
      P.nfree[c] = g + 1;
      n.allocs += 1;
      out[0] = OP_SET_FUTURE; out[1] = a0; out[2] = c * S + g;
    } else {
      out[0] = OP_ALLOC; out[1] = fmod_(c + 1, NC) * S; out[2] = a0;
      out[3] = a1;
    }
    set_out = true;
  } else if (is_sf) {
    P.gaddr[idx] = a0;
    P.gstate[idx] = G_SET;
    T = fqn + (fwdp ? 1 : 0);
  }

  if (set_out) copy_msg(P.cout + (size_t)c * MSGW, out);
  P.aq_n[c] = aqn - 1;
  P.aq_head[c] = fmod_(aqh + 1, Q);
  if (T > 0) P.cvalid[c] = true; else n.exec += 1;
  copy_msg(P.cmsg + (size_t)c * MSGW, m);
  P.cphase[c] = 1;
  P.cT[c] = T;
  P.cdrain[c] = is_rf ? drain_n : 0;
}

// ingest.io_stage for IO cell i (attached to row-0 cell i).
__device__ void io(const Dims& D, const Leaves& P, int i) {
  int pos = P.io_pos[i];
  if (pos >= P.io_n[i]) return;
  const int* e = P.io_edges + ((size_t)i * D.IOL + min(pos, D.IOL - 1)) * 3;
  int NC = D.H * D.W;
  int msg[MSGW];
  msg[0] = OP_INSERT_EDGE;
  msg[1] = fmod_(e[0], NC) * D.S + fdiv(e[0], NC);
  msg[2] = fmod_(e[1], NC) * D.S + fdiv(e[1], NC);
  msg[3] = e[2];
  msg[4] = 0;
  int tb = yx_tb(D, fdiv(msg[1], D.S), 0, i);
  if (deliver(D, P, i, msg, tb,
              P.aq_n[i] < D.Q - D.aq_reserve - D.sys_reserve))
    P.io_pos[i] = pos + 1;
}

// engine.quiescent, per cell: any queued, in-flight, active, deferred or
// streamed work left at cell c.
__device__ __forceinline__ bool cell_busy(const Dims& D, const Leaves& P,
                                          int c) {
  const int* chn = P.ch_n + c * 4;
  return P.aq_n[c] != 0 || P.pk_n[c] != 0 || chn[0] != 0 || chn[1] != 0 ||
         chn[2] != 0 || chn[3] != 0 || P.cvalid[c] || P.qwork[c] != 0 ||
         (c < D.IO && P.io_n[c] != P.io_pos[c]);
}

__global__ void __launch_bounds__(1024, 1)
cca_cycle_kernel(const Dims D, const Leaves P) {
  const int NC = D.H * D.W, tid = threadIdx.x, nt = blockDim.x;
  for (int c = tid; c < NC; c += nt) {
    int w = 0;
    for (int s = 0; s < D.S; ++s) {
      size_t idx = (size_t)c * D.S + s;
      w += P.fq_n[idx] + (P.fwd_pending[idx] ? 1 : 0);
    }
    P.qwork[c] = w;
  }
  Counts n = {0, 0, 0, 0};
  int ran = 0, quiet;
  for (;;) {
    int busy = 0;
    for (int c = tid; c < NC; c += nt) busy |= cell_busy(D, P, c);
    quiet = !__syncthreads_or(busy);   // also orders the previous cycle
    if (quiet || ran == D.n_cycles) break;
    for (int d = 0; d < 4; ++d) {
      for (int c = tid; c < NC; c += nt) hop_read(D, P, c, d);
      __syncthreads();
      for (int c = tid; c < NC; c += nt) n.hops += hop_write(D, P, c, d);
      __syncthreads();
    }
    for (int c = tid; c < NC; c += nt) {
      bool busy0 = P.cvalid[c];
      staging(D, P, c, n);
      phase0(D, P, c, busy0, n);
      if (c < D.IO) io(D, P, c);
    }
    ++ran;
  }
  __shared__ int sum[4];
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
}

}  // namespace

// Launch one chunk on `stream`.  `ptrs` holds N_PTRS device pointers in the
// order of Leaves, `dims` N_DIMS ints in the order of Dims.  Returns the
// launch's error code (cudaSuccess when the kernel was queued).
extern "C" cudaError_t cca_cycle_launch(void* const* ptrs, int n_ptrs,
                                        const int* dims, int n_dims,
                                        void* stream) {
  if (n_ptrs != N_PTRS || n_dims != N_DIMS) return cudaErrorInvalidValue;
  Dims D;
  Leaves P;
  memcpy(&D, dims, sizeof(D));
  memcpy(&P, ptrs, sizeof(P));
  int cells = D.H * D.W;
  int threads = cells < 1024 ? cells : 1024;
  cca_cycle_kernel<<<1, threads, 0, (cudaStream_t)stream>>>(D, P);
  return cudaGetLastError();
}

// Text of a launch error code, for the wrapper's exception.
extern "C" const char* cca_cycle_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
