"""Machine state: the whole AM-CCA chip as one fixed-shape tuple of tensors.

Field names, shapes and dtypes are those of ``repro.core.state.
MachineState``, so a state crosses between the two packages as a dict of
numpy arrays (:func:`state_to_numpy` / :func:`state_from_numpy`), the
way weights cross between frameworks.  Scalars are 0-d int32 tensors;
every tensor of one state lies on one device.

Slot layout per cell: slots ``[0, P)`` with ``P = rhizome_cap *
root_slots`` are the root region -- slot ``j`` holds the vertex with
local index ``j``; slots ``[P, S)`` are ghost slots handed out by the
allocator.  A global address is ``addr = cell * S + slot`` (int32).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.config import EngineConfig
from repro_torch.core.msg import N_DIRS

# ghost-future states (paper Fig. 4)
G_NULL, G_PENDING, G_SET = 0, 1, 2

# ---- telemetry plane indices (DESIGN §8) ----
# Per-cell per-stage activity counts, ``tm_cell [H, W, N_TM_STAGES]``,
# cumulative over an increment (reset with the stat_* scalars), so the
# final plane reconciles with the counters: sum(TM_HOP) == stat_hops,
# sum(TM_EXEC) == stat_exec at quiescence, sum(TM_STALL) + sum(TM_PARK)
# == stat_stall, sum(TM_ALLOC) == stat_allocs.
TM_EXEC = 0     # actions popped by phase0 (== completed at quiescence)
TM_ALLOC = 1    # ghost allocations served here
TM_STALL = 2    # staging backpressure stalls + phase0 head rotations
TM_HOP = 3      # flits accepted into this cell by the hop stage
TM_STAGE = 4    # emissions staged successfully (network or local queue)
TM_PARK = 5     # remote emissions parked (lane full at staging time)
TM_UNPARK = 6   # parked messages re-injected into a lane
TM_IO = 7       # streamed edge inserts accepted at this IO cell
TM_BCAST = 8    # rhizome sibling broadcasts staged
N_TM_STAGES = 9

# Per-link per-lane counters, ``tm_lane [H, W, 4, L, N_TM_LANE]``.
TM_L_OCC = 0    # lane occupancy summed over cycles
TM_L_GRANT = 1  # arbiter grants won and accepted (== hops on this lane)
TM_L_BLOCK = 2  # cycles the lane was occupied but not granted
N_TM_LANE = 3

# Per-cell hi-water marks, ``tm_hiw [H, W, N_TM_HIW]``.
TM_HW_AQ = 0    # action-queue depth hi-water
TM_HW_PK = 1    # park-ring depth hi-water
N_TM_HIW = 2


class MachineState(NamedTuple):
    # --- RPVO slot storage [H, W, S, ...] ---
    vals: torch.Tensor        # [H,W,S,VN] f32  application values
    nedges: torch.Tensor      # [H,W,S]    i32  edges in this RPVO node
    edst: torch.Tensor        # [H,W,S,E]  i32  edge dst = root addr of dst
    ew: torch.Tensor          # [H,W,S,E]  f32  edge weight
    gaddr: torch.Tensor       # [H,W,S]    i32  ghost address (-1 if none)
    gstate: torch.Tensor      # [H,W,S]    i32  future state
    rhz_on: torch.Tensor      # [H,W,S]    bool secondary rhizome root active
    rstate: torch.Tensor      # [H,W,S]    i32  rhizome-link state
    nfree: torch.Tensor       # [H,W]      i32  next free ghost slot
    # --- future LCO deferred queues [H,W,S,FQ,3]: (op, arg0, arg1) ---
    fq: torch.Tensor
    fq_n: torch.Tensor        # [H,W,S] i32
    fq_head: torch.Tensor     # [H,W,S] i32
    # --- coalesced deferred app-forward ---
    fwd_val: torch.Tensor     # [H,W,S] f32
    fwd_pending: torch.Tensor  # [H,W,S] bool
    # --- per-cell action queue ---
    aq: torch.Tensor          # [H,W,Q,MSG] i32
    aq_n: torch.Tensor        # [H,W] i32
    aq_head: torch.Tensor     # [H,W] i32
    # --- per-cell, per-direction outgoing channels, lane-major ---
    ch: torch.Tensor          # [H,W,4,L,LC,MSG] i32
    ch_n: torch.Tensor        # [H,W,4,L] i32
    ch_head: torch.Tensor     # [H,W,4,L] i32
    ch_rr: torch.Tensor       # [H,W,4] i32  round-robin lane pointer
    # --- per-cell park buffer (1-deep dummy at lanes=1) ---
    pk: torch.Tensor          # [H,W,PK,MSG] i32
    pk_n: torch.Tensor        # [H,W] i32
    pk_head: torch.Tensor     # [H,W] i32
    # --- active-action registers ---
    cmsg: torch.Tensor        # [H,W,MSG] i32
    cvalid: torch.Tensor      # [H,W] bool
    cphase: torch.Tensor      # [H,W] i32   emissions staged so far + 1
    cT: torch.Tensor          # [H,W] i32   total emissions of the action
    cemit: torch.Tensor       # [H,W] f32   emission source value
    cout: torch.Tensor        # [H,W,MSG] i32 precomputed single emission
    cdrain: torch.Tensor      # [H,W] i32   deferred-queue drains
    # --- IO cells (streaming ingestion) ---
    io_edges: torch.Tensor    # [IO, L, 3] i32 (src vid, dst vid, weight bits)
    io_n: torch.Tensor        # [IO] i32 edges loaded
    io_pos: torch.Tensor      # [IO] i32 cursor
    # --- allocator rotation counters ---
    arot: torch.Tensor        # [H,W] i32
    # --- cycle counter and per-increment stats (0-d int32) ---
    cycle: torch.Tensor
    stat_hops: torch.Tensor
    stat_exec: torch.Tensor
    stat_stall: torch.Tensor
    stat_allocs: torch.Tensor
    # --- telemetry planes (cfg.telemetry; 1x1 dummies, never touched,
    #     while it is off) ---
    tm_cell: torch.Tensor     # [H,W,9] i32 per-cell stage activity
    tm_lane: torch.Tensor     # [H,W,4,L,3] i32 lane occ/grant/blocked
    tm_hiw: torch.Tensor      # [H,W,2] i32 AQ / park-ring hi-water
    # --- fault-injection counters (cfg.faults, DESIGN §9): [N_FLT] i32
    #     (resilience.faults' FLT_* indices), a [1] dummy, never touched,
    #     while it is off ---
    flt: torch.Tensor
    # --- planes of knobs the port does not carry yet: fixed-shape
    #     dummies, never touched (the JAX engine's off-path shapes) ---
    qchg: torch.Tensor        # [1] i32
    qlast: torch.Tensor       # [1] i32


def resolve_device(device) -> torch.device:
    """The port's entry points run on the card unless told otherwise:
    ``None`` means ``cuda``, and raises when there is no card."""
    if device is None and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card by "
                           "default; pass device='cpu' for the plain "
                           "PyTorch version")
    return torch.device("cuda" if device is None else device)


def init_state(cfg: EngineConfig, init_vals: float = 1e9,
               fwd_init: float = 1e9, device=None) -> MachineState:
    """Fresh machine: all vertices allocated as roots, no edges, empty
    queues.  ``device=None`` means ``cuda``."""
    from repro_torch.resilience.faults import N_FLT   # (imports core)
    cfg.validate()
    dev = resolve_device(device)
    H, W, S, E = cfg.height, cfg.width, cfg.slots, cfg.edge_cap
    VN, FQ, Q = cfg.n_vals, cfg.futq_cap, cfg.queue_cap
    VL, LC = cfg.lanes, cfg.lane_capacity
    IO, L = cfg.io_cells, cfg.io_stream_cap
    WM = cfg.msg_words

    def z32(*s):
        return torch.zeros(s, dtype=torch.int32, device=dev)

    def full(s, v, dt):
        return torch.full(s, v, dtype=dt, device=dev)

    return MachineState(
        vals=full((H, W, S, VN), init_vals, torch.float32),
        nedges=z32(H, W, S),
        edst=full((H, W, S, E), -1, torch.int32),
        ew=full((H, W, S, E), 0.0, torch.float32),
        gaddr=full((H, W, S), -1, torch.int32),
        gstate=z32(H, W, S),
        rhz_on=full((H, W, S), False, torch.bool),
        rstate=z32(H, W, S),
        nfree=full((H, W), cfg.primary_slots, torch.int32),
        fq=z32(H, W, S, FQ, 3),
        fq_n=z32(H, W, S), fq_head=z32(H, W, S),
        fwd_val=full((H, W, S), fwd_init, torch.float32),
        fwd_pending=full((H, W, S), False, torch.bool),
        aq=z32(H, W, Q, WM), aq_n=z32(H, W), aq_head=z32(H, W),
        ch=z32(H, W, N_DIRS, VL, LC, WM),
        ch_n=z32(H, W, N_DIRS, VL), ch_head=z32(H, W, N_DIRS, VL),
        ch_rr=z32(H, W, N_DIRS),
        pk=z32(H, W, cfg.park_capacity, WM),
        pk_n=z32(H, W), pk_head=z32(H, W),
        cmsg=z32(H, W, WM),
        cvalid=full((H, W), False, torch.bool),
        cphase=z32(H, W), cT=z32(H, W),
        cemit=full((H, W), 0.0, torch.float32),
        cout=z32(H, W, WM),
        cdrain=z32(H, W),
        io_edges=z32(IO, L, 3), io_n=z32(IO), io_pos=z32(IO),
        arot=z32(H, W),
        cycle=z32(), stat_hops=z32(), stat_exec=z32(),
        stat_stall=z32(), stat_allocs=z32(),
        tm_cell=z32(*((H, W) if cfg.telemetry else (1, 1)), N_TM_STAGES),
        tm_lane=z32(*((H, W, N_DIRS, VL) if cfg.telemetry
                      else (1, 1, 1, 1)), N_TM_LANE),
        tm_hiw=z32(*((H, W) if cfg.telemetry else (1, 1)), N_TM_HIW),
        flt=z32(N_FLT if cfg.faults is not None else 1),
        qchg=z32(1), qlast=z32(1),
    )


def state_to_numpy(st: MachineState) -> dict:
    """``{leaf name: numpy array}`` -- the exchange format with the JAX
    package (``{k: np.asarray(v) for k, v in jax_state._asdict().items()}``
    on the other side)."""
    return {k: v.detach().cpu().numpy() for k, v in st._asdict().items()}


def state_from_numpy(cfg: EngineConfig, arrays: dict,
                     device=None) -> MachineState:
    """Build a state from ``{leaf name: numpy array}``, checking every
    leaf's shape and dtype against :func:`init_state`'s layout for
    ``cfg``.  ``device=None`` means ``cuda``."""
    dev = resolve_device(device)
    like = init_state(cfg, device="meta")
    leaves = {}
    for name, ref in like._asdict().items():
        a = np.asarray(arrays[name])
        want = torch.empty((), dtype=ref.dtype).numpy().dtype
        if a.shape != tuple(ref.shape) or a.dtype != want:
            raise ValueError(
                f"leaf {name!r}: got {a.dtype}{list(a.shape)}, config "
                f"needs {want}{list(ref.shape)}")
        leaves[name] = torch.from_numpy(np.array(a)).to(dev)
    return MachineState(**leaves)


def tm_cell_add(st: MachineState, *counts) -> MachineState:
    """``st`` with ``tm_cell[..., k] += mask`` for each ``(k, mask)`` of
    ``counts`` (``[H, W]`` bool masks; telemetry planes)."""
    tm = st.tm_cell.clone()
    for k, m in counts:
        tm[..., k] += m.to(torch.int32)
    return st._replace(tm_cell=tm)


def root_addr(cfg: EngineConfig, vid):
    """Global address of vertex ``vid``'s RPVO root (floor div/mod, as
    the JAX engine)."""
    return (vid % cfg.n_cells) * cfg.slots + vid // cfg.n_cells
