"""The cycle engine: composes routing, execution and ingestion into one
``state -> state`` cycle, runs it to quiescence in K-cycle chunks, and
exposes the streaming-increment API the experiments use.

Cycle order (``cycle_body``, fixed-shape, vectorized over the cell grid):

  1. hop_stage      channel heads advance one link (YX DOR, backpressure,
                    the round-robin lane arbiter)
     park_stage     (lanes > 1) parked transit messages re-enter their lanes
  2. staging        active actions stage one ``propagate`` message
  3. phase0         idle cells pop one action and run its compute step
  4. io_stage       IO cells inject the next streamed edge

Quiescence (the paper's Terminator object): no queued actions, no channel
occupancy, no active action, no deferred future tasks, no pending IO.

Each chunk is one call of ``kernels.cca_cycle.ops.cca_cycle_chunk``: one
launch of the hand-written CUDA kernel for a state on the card, the plain
PyTorch version (``kernels/cca_cycle/ref.py``, built on ``cycle_body``)
for a state on the CPU.  The chunk loop runs on the host, one launch and
one read of the launch record per chunk, and reproduces the JAX engine's
device loop exactly: the cycle limit checked at chunk boundaries, the
no-progress counter on ``stat_exec + stat_hops``, ``LIVELOCK_CHUNKS`` and
the spill reload passes.  ``collect_traces=True`` takes the JAX engine's
traced host loop instead, with the kernel filling one ``(active,
in_flight)`` row a cycle.

With ``cfg.telemetry`` the cycle also accumulates the telemetry planes
(DESIGN §8; the kernels' telemetry instances on the card), reset with the
counters at each increment, and the chunk loop takes a frame of them
(``obs.frames.snapshot``) into a ring on the state's device after every
chunk, before it reads the launch record: no host read of its own.  A
pass reads its ring back in one transfer.  The frames are the JAX
engine's: one ring a pass of the device loop, its first frame the pass's
baseline (a pass quiescent on entry runs no chunk and keeps only it), and
one ring over the whole increment in the traced loop, with a frame also
for the chunk that runs no cycle after one ended on quiescence.  They come
back as ``IncrementResult.frames``, and on a livelock in
``LivelockError.frames``, whose message then carries the flight
recorder's wedge report.  A snapshot takes the quiescent bit from the
launch record it follows, not from a reduction over the state.

With ``cfg.faults`` (DESIGN §9) the cycle injects the plan's hazards (the
kernels' fault instances on the card), the ``flt`` counters reset with
the others, and both drivers end an increment with the loss detector: if
messages were lost, a bounded repair pass re-injects every durable value
as ``OP_REPAIR`` traffic through the IO cells and runs device-loop passes
under the plan's safe twin until the values are exact again.  Its cycles
count in the increment's; the device loop's counters and frames include
it, the traced loop adds no trace row and no frame for it.

On a sharded grid (``self.state`` a ``dist.cca.ShardedState``, placed by
``dist.cca.shard_state`` or ``restore(shardings=)``: the port's
counterparts of JAX's ``device_put`` under ``cca_state_shardings``) the
same drivers run over the tiles: each chunk is ``dist.cca.run_chunk``,
one tile step a tile a cycle, the counters and planes reduced over the
ranks on the device and a frame (``dist.cca.snapshot``) taken of the
whole grid, still one host read a chunk; the loss detector and the ingest
guard reduce over the owned cells; the repair pass, ``values`` and the
checkpoint read the leaves they need gathered.

Durable state and recovery (DESIGN §9) are host-side, as in the JAX
engine: ``checkpoint`` / ``restore`` and ``run_increment(ckpt=)`` write
and read the JAX engine's checkpoint format; ``run_increment(recover=)``
keeps a copy of the boundary on the state's device and, on a livelock,
migrates it into an escalated config and retries.  With
``cfg.ingest_guard`` each load of new edges is limited by a budget
learnt from the ``tm_hiw`` plane, updated before each spill reload of
the device loop and at each increment's end; as in the JAX engine, the
traced loop's spill reloads and the repair pass's rows are not limited.
"""
from __future__ import annotations

import dataclasses
import functools
import time
import types
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.alloc import rhizome_rcs
from repro_torch.core.apps import APPS, DiffusionApp
from repro_torch.core.config import EngineConfig
from repro_torch.core.exec_stage import phase0_stage, staging_stage
from repro_torch.core.ingest import _io_cells, io_stage, load_stream
from repro_torch.core.routing import hop_stage, park_stage
from repro_torch.core.state import (TM_HOP, TM_HW_AQ, TM_L_OCC,
                                    MachineState, init_state, owned,
                                    resolve_device, state_from_numpy)
from repro_torch.obs import frames as obs_frames
from repro_torch.obs.flight import render_wedge_report

# this many consecutive chunks with no executed action and no hop while
# work is pending => message-dependent deadlock (DESIGN §4.2)
LIVELOCK_CHUNKS = 8


def increment_reset_leaves(cfg: EngineConfig) -> tuple:
    """The leaves zeroed as an increment starts: the counters and, under
    their knobs, the per-query relax counters (``qlast`` persists, each
    slot's absolute settle cycle), the fault counters (the loss detector
    reconciles each increment on its own) and the telemetry planes (the
    increment's final frame reconciles with the counters).  The one list
    of both the whole and the sharded machine."""
    return (("stat_hops", "stat_exec", "stat_stall", "stat_allocs")
            + (("qchg",) if cfg.qbatch > 1 else ())
            + (("flt",) if cfg.faults is not None else ())
            + (("tm_cell", "tm_lane", "tm_hiw") if cfg.telemetry else ()))


def _cca():
    """``repro_torch.dist.cca``, the sharded machine (it imports this
    module)."""
    from repro_torch.dist import cca
    return cca


class CycleStats(NamedTuple):
    active: torch.Tensor      # cells doing compute/staging work this cycle
    in_flight: torch.Tensor   # messages sitting in channels
    backlog: torch.Tensor     # queued actions
    hops: torch.Tensor        # link traversals this cycle
    quiescent: torch.Tensor   # bool


def _rc(cfg: EngineConfig, device, tile=None, shape=None):
    """The global row and column of every cell of the state's arrays,
    ``[h, w]`` int32 each: the whole grid, or a ``tile``'s arrays of
    ``shape``."""
    h, w = (cfg.height, cfg.width) if tile is None else shape
    r0, c0 = (0, 0) if tile is None else (tile.r0, tile.c0)
    rows = torch.arange(r0, r0 + h, dtype=torch.int32, device=device)
    cols = torch.arange(c0, c0 + w, dtype=torch.int32, device=device)
    return rows[:, None].expand(h, w), cols[None, :].expand(h, w)


def quiescent(st: MachineState, tile=None) -> torch.Tensor:
    """0-d bool: no work left anywhere in the machine (on a ``tile``: in
    the cells and IO cells it owns)."""
    if tile is None:
        return ((st.aq_n.sum() == 0) & (st.ch_n.sum() == 0)
                & (st.pk_n.sum() == 0) & ~st.cvalid.any()
                & (st.fq_n.sum() == 0) & ~st.fwd_pending.any()
                & ((st.io_n - st.io_pos).sum() == 0))
    own = tile.own_mask(*st.aq_n.shape, st.aq_n.device)
    io = _io_cells(st.io_n.shape[0], tile, st.io_n.device)
    pending = (0 if io is None
               else (st.io_n[io[0]] - st.io_pos[io[0]]).sum())
    return (~(owned(st.aq_n != 0, own).any() | owned(st.ch_n != 0, own).any()
              | owned(st.pk_n != 0, own).any() | owned(st.cvalid, own).any()
              | owned(st.fq_n != 0, own).any()
              | owned(st.fwd_pending, own).any())
            & (pending == 0))


def cycle_body(cfg: EngineConfig, app: DiffusionApp, st: MachineState,
               tile=None):
    """One machine cycle: hop -> park (lanes > 1) -> staging -> phase0 ->
    io.  Returns the new state and the per-cell activity masks and hop
    count of the cycle.  On a ``tile`` (``core.state.Tile``) the stages
    route in global coordinates and count the owned cells only; the
    cells it does not own come out stale (its halo), for the caller's
    exchange to refresh."""
    dev = st.aq_n.device
    rows, cols = _rc(cfg, dev, tile, tuple(st.aq_n.shape))
    own = None if tile is None else tile.own_mask(*st.aq_n.shape, dev)
    busy0 = st.cvalid
    if cfg.telemetry:
        # lane occupancy at cycle entry (mean depth = TM_L_OCC / cycles)
        tm = st.tm_lane.clone()
        tm[..., TM_L_OCC] += st.ch_n
        st = st._replace(tm_lane=tm)
    st, hops = hop_stage(cfg, st, rows, cols, own)
    if cfg.lanes > 1:
        # while the lane slots the hops just vacated are free
        st = park_stage(cfg, st, rows, cols)
    st, active_a = staging_stage(cfg, app, st, rows, cols, own)
    st, popped = phase0_stage(cfg, app, st, rows, cols, busy0, own)
    st = io_stage(cfg, st, rows, cols, tile)
    if cfg.telemetry:
        hw = torch.stack([st.aq_n, st.pk_n], dim=-1)
        st = st._replace(tm_hiw=torch.maximum(st.tm_hiw, hw))
    st = st._replace(cycle=st.cycle + 1, stat_hops=st.stat_hops + hops)
    return st, (active_a, popped, hops)


def run_chunk(cfg: EngineConfig, app: DiffusionApp, st: MachineState):
    """One chunk of ``cfg.chunk`` cycles, frozen once quiescent
    (``repro/core/engine.py::run_chunk``): one launch of the cycle kernel
    for a state on the card, the plain version on the CPU.  Returns
    ``(state, int32 [quiescent at end, cycles run])``; the per-cycle
    stats of JAX's scan come from ``ops.cca_cycle_chunk(trace=)``."""
    from repro_torch.kernels.cca_cycle.ops import cca_cycle_chunk
    return cca_cycle_chunk(cfg, app, st)


def run_chunk_body(cfg: EngineConfig, app: DiffusionApp,
                   st: MachineState) -> MachineState:
    """Exactly ``cfg.chunk`` cycles, never frozen
    (``repro/core/engine.py::run_chunk_body``).  A cycle of a quiescent
    machine moves nothing but the cycle counter (no queue, channel, park
    ring, action, deferred task or stream entry to act on), so this is
    :func:`run_chunk` with the cycles it froze added to ``cycle``."""
    st, rec = run_chunk(cfg, app, st)
    return st._replace(cycle=st.cycle + (cfg.chunk - rec[1]))


def cycle_step(cfg: EngineConfig, app: DiffusionApp, st: MachineState):
    """``cycle_body`` and the cycle's :class:`CycleStats`: active is the
    count of cells that staged or popped an action, in-flight the channel
    and park occupancy after the cycle."""
    st, (active_a, popped, hops) = cycle_body(cfg, app, st)
    stats = CycleStats(
        active=(active_a | popped).sum(dtype=torch.int32),
        in_flight=st.ch_n.sum(dtype=torch.int32)
        + st.pk_n.sum(dtype=torch.int32),
        backlog=st.aq_n.sum(dtype=torch.int32),
        hops=hops, quiescent=quiescent(st))
    return st, stats


def _livelock_msg(cfg: EngineConfig) -> str:
    return ("engine livelock: no action executed and no message hopped "
            f"for {LIVELOCK_CHUNKS * cfg.chunk} cycles with work pending "
            "— every virtual lane is stuck. "
            f"Enable virtual lanes (lanes>=2, currently {cfg.lanes}) so "
            "protocol traffic escapes head-of-line blocking, and/or "
            "increase chan_cap (>=4) / queue_cap "
            f"(>= aq_reserve+sys_reserve+8 = "
            f"{cfg.aq_reserve + cfg.sys_reserve + 8}) — see "
            "DESIGN.md §4.2/§7 buffer-sizing rules.")


class LivelockError(RuntimeError):
    """Message-dependent deadlock detected (DESIGN §4.2): carries the
    machine ``cycle`` count of the increment at detection, the ``chunk``
    index and, when ``cfg.telemetry`` is on, the flight recorder's
    ``frames`` (:class:`repro_torch.obs.FrameLog`; ``None`` otherwise),
    like the JAX engine's error."""

    def __init__(self, msg: str, *, cycle: int, chunk: int, frames=None):
        super().__init__(msg)
        self.cycle = cycle
        self.chunk = chunk
        self.frames = frames


def _raise_livelock(cfg: EngineConfig, *, cycle: int, chunk: int,
                    frames=None):
    """Raise :class:`LivelockError`, with the flight recorder's wedge
    report appended when frames were captured."""
    msg = _livelock_msg(cfg)
    if frames is not None and len(frames) >= 2:
        msg = msg + "\n" + render_wedge_report(cfg, frames)
    raise LivelockError(msg, cycle=cycle, chunk=chunk, frames=frames)


@dataclasses.dataclass
class IncrementResult:
    cycles: int
    # per-cycle traces (``collect_traces=True``; empty int32 otherwise)
    active_per_cycle: np.ndarray
    in_flight_per_cycle: np.ndarray
    hops: int
    execs: int
    stalls: int
    allocs: int
    # the telemetry frame log (``cfg.telemetry``, else None): the last
    # ``cfg.frame_ring`` per-chunk frames of each pass, each pass's ring
    # read back in one transfer
    frames: obs_frames.FrameLog | None = None


def _roots(cfg: EngineConfig, n: int):
    """(row, col, slot) of every rhizome root of vertices ``0 .. n-1``,
    each ``[rhizome_cap, n]``; row 0 the canonical roots."""
    return rhizome_rcs(cfg, np.arange(n, dtype=np.int64)[None, :],
                       np.arange(cfg.rhizome_cap, dtype=np.int64)[:, None])


def _resolve_app(app) -> DiffusionApp:
    """A bundled app by name, or a :class:`DiffusionApp` whose app (or,
    for a composite, every slot app) is one the kernel has a code for."""
    if isinstance(app, DiffusionApp):
        for a in app.slot_apps or (app,):
            if APPS.get(a.name) != a:
                raise NotImplementedError(
                    f"repro_torch ports the apps {sorted(APPS)}, not "
                    f"{a.name!r}")
        return app
    if app not in APPS:
        raise NotImplementedError(
            f"repro_torch ports the apps {sorted(APPS)}, not {app!r}")
    return APPS[app]


class StreamingEngine:
    """Host-side driver: the accelerator-style main() of paper Listing 1.

    ``app`` is the name of a bundled app or a :class:`DiffusionApp`, such
    as a query-batched composite of ``repro_torch.mq.batch_app``, whose
    ``n_vals`` and ``qbatch`` the config takes.  ``device=None`` means the
    card (``cuda``); pass ``device="cpu"`` to run the plain PyTorch
    version.
    """

    def __init__(self, cfg: EngineConfig, app: str | DiffusionApp = "bfs",
                 device=None):
        self.app = _resolve_app(app)
        self.cfg = dataclasses.replace(cfg, n_vals=self.app.n_vals,
                                       qbatch=self.app.qbatch)
        self.device = resolve_device(device)
        self.state = init_state(self.cfg, init_vals=self.app.init_val,
                                fwd_init=self.app.fwd_neutral,
                                device=self.device)
        self.total_cycles = 0
        self.totals = dict(hops=0, execs=0, stalls=0, allocs=0)
        # resilience bookkeeping (DESIGN §9)
        self.stream_pos = 0         # increments done == checkpoint step
        self.recovery_log = []      # one dict a failed recovery attempt
        self._ingest_budget = None  # the ingest guard's admission limit

    def seed(self, vid: int, value: float, val_idx: int = 0):
        """Host-write a value into every rhizome root of ``vid`` (e.g. the
        BFS source gets level 0 before the stream), so the co-equal roots
        start value-synced."""
        r, c, s = rhizome_rcs(self.cfg, vid, np.arange(self.cfg.rhizome_cap))
        if self._sharded:
            _cca().write_cells(self.state, "vals", r, c, (s, val_idx), value)
            return
        r, c, s = (torch.as_tensor(a, device=self.device) for a in (r, c, s))
        self.state.vals[r, c, s, val_idx] = value

    # -- the state, whole or sharded over a mesh's tiles --

    @property
    def _sharded(self) -> bool:
        return not isinstance(self.state, MachineState)

    @property
    def _device(self) -> torch.device:
        """The state's device (a sharded state's: its tiles')."""
        return self.state.device if self._sharded else self.device

    def _leaves(self, *names):
        """The named leaves of the whole machine (gathered from the owned
        cells of a sharded state), as attributes."""
        if self._sharded:
            return types.SimpleNamespace(**{
                k: _cca().gather_leaf(self.state, k) for k in names})
        return types.SimpleNamespace(**{k: getattr(self.state, k)
                                        for k in names})

    def _over_cells(self, name: str, fn, op: str = "sum") -> torch.Tensor:
        """``fn`` of the per-cell leaf ``name``: of the whole leaf, or of
        each tile's owned cells reduced (``op``: ``"sum"`` or ``"max"``)
        over the tiles and ranks, on the device."""
        if self._sharded:
            return _cca().reduce_owned(self.state, name, fn, op)
        return fn(getattr(self.state, name))

    def _whole(self) -> MachineState:
        """The whole machine state (gathered, where sharded)."""
        return (_cca().gather_state(self.state) if self._sharded
                else self.state)

    def _load(self, cfg: EngineConfig, edges, limit=None):
        """``load_stream`` into the state; returns the spill."""
        if self._sharded:
            return _cca().load_stream(cfg, self.state, edges, limit)
        self.state, spill = load_stream(cfg, self.state, edges, limit=limit)
        return spill

    def _chunk(self, cfg: EngineConfig, st, trace=None):
        """One chunk (``run_chunk``, or ``dist.cca.run_chunk`` over the
        tiles): ``(state, int32 [quiescent, cycles run])``."""
        if self._sharded:
            return _cca().run_chunk(cfg, self.app, st, trace=trace)
        from repro_torch.kernels.cca_cycle.ops import cca_cycle_chunk
        return cca_cycle_chunk(cfg, self.app, st, trace=trace)

    def _counters(self, st) -> torch.Tensor:
        """int32 ``[cycle, hops, execs, stalls, allocs]`` on the device."""
        if self._sharded:
            return _cca().counters(st)
        return torch.stack([st.cycle, st.stat_hops, st.stat_exec,
                            st.stat_stall, st.stat_allocs])

    def _snapshot(self, cfg: EngineConfig, st, quiet=None) -> torch.Tensor:
        if self._sharded:
            return _cca().snapshot(cfg, st, quiet)
        return obs_frames.snapshot(cfg, st, quiet)

    def run_increment(self, edges: np.ndarray, max_cycles: int | None = None,
                      collect_traces: bool = False, recover=None,
                      ckpt=None, ckpt_block: bool = False) -> IncrementResult:
        """Ingest ``edges`` (int32 ``[m, 3]``: src, dst, weight bits) and
        run to quiescence.  Raises :class:`LivelockError` on a detected
        deadlock.  ``collect_traces=True`` returns the per-cycle
        ``active_per_cycle`` and ``in_flight_per_cycle`` (the same state
        and totals either way).

        The resilience knobs (DESIGN §9), both off by default:

        * ``ckpt`` -- a :class:`repro_torch.train.Checkpointer`: publish a
          boundary checkpoint (step ``stream_pos``) before this increment
          is ingested, async unless ``ckpt_block``.  A crash
          mid-increment restores the boundary and replays the increment
          bit-exactly.
        * ``recover`` -- a :class:`repro_torch.resilience.RecoveryPolicy`:
          on :class:`LivelockError`, go back to the boundary, escalate
          lanes / queue_cap as the policy says, back off exponentially and
          retry the increment.  Each failed attempt is appended to
          ``recovery_log`` (with the wedge report when telemetry is on);
          once the budget is spent the error re-raises with the attempt
          log in its message.  A successful escalation keeps the relieved
          config for the rest of the stream.  A failed attempt's cycles
          count in neither ``total_cycles`` nor ``totals``.
        """
        if ckpt is not None:
            self.checkpoint(ckpt, block=ckpt_block)
        if recover is None:
            return self._run_increment(edges, max_cycles, collect_traces)
        from repro_torch.resilience.recover import (boundary_snapshot,
                                                    migrate_state)
        base_cfg = self.cfg
        mesh = self.state.mesh if self._sharded else None
        # the boundary is the recovery point: quiescent, so migrate_state
        # can re-seat it under an escalated config (a sharded state's
        # boundary gathered, and sharded again after the migration)
        snapshot = boundary_snapshot(self._whole())
        for attempt in range(recover.max_attempts + 1):
            try:
                return self._run_increment(edges, max_cycles, collect_traces)
            except LivelockError as e:
                entry = dict(attempt=attempt, cycle=e.cycle, chunk=e.chunk,
                             lanes=self.cfg.lanes,
                             queue_cap=self.cfg.queue_cap, wedge=str(e))
                self.recovery_log.append(entry)
                if attempt >= recover.max_attempts:
                    log = "\n".join(
                        f"  attempt {n['attempt']}: lanes={n['lanes']} "
                        f"queue_cap={n['queue_cap']} wedged at cycle "
                        f"{n['cycle']}" for n in self.recovery_log)
                    raise LivelockError(
                        f"{e}\nrecovery budget exhausted "
                        f"({recover.max_attempts} escalations):\n{log}",
                        cycle=e.cycle, chunk=e.chunk,
                        frames=e.frames) from e
                new_cfg = recover.escalate(base_cfg, attempt + 1)
                delay = recover.backoff_s * (2 ** attempt)
                entry["backoff_s"] = delay
                entry["escalated_to"] = dict(lanes=new_cfg.lanes,
                                             queue_cap=new_cfg.queue_cap)
                if delay:
                    time.sleep(delay)
                self.cfg = new_cfg
                self.state = migrate_state(new_cfg, self.app, snapshot)
                if mesh is not None:
                    self.state = _cca().shard_state(new_cfg, self.state,
                                                    mesh)
                self._ingest_budget = None  # re-learn under the new sizing

    def _run_increment(self, edges, max_cycles, collect_traces):
        cfg = self.cfg
        limit = max_cycles or cfg.max_cycles
        spill = self._load(cfg, edges, self._ingest_limit())
        self._reset_increment(cfg)
        if collect_traces:
            cycles, spill, traces, frames = self._run_traced(cfg, spill,
                                                             limit)
        else:
            rings = []
            cycles, q, noprog, counters, spill = self._passes(
                cfg, spill, limit, rings)
            frames = obs_frames.FrameLog.from_rings(rings) if rings else None
            if not q and noprog >= LIVELOCK_CHUNKS:
                _raise_livelock(cfg, cycle=cycles, chunk=cycles // cfg.chunk,
                                frames=frames)
            traces = (np.zeros(0, np.int32), np.zeros(0, np.int32))
        if len(spill):
            raise RuntimeError(self._spill_msg(limit, spill))
        if cfg.faults is not None:
            # the traced loop's repair tail adds no trace row and no frame
            cycles = self._repair_rounds(limit, cycles,
                                         [] if collect_traces else rings)
            if not collect_traces and rings:
                frames = obs_frames.FrameLog.from_rings(rings)
        if collect_traces or cfg.faults is not None:
            counters = tuple(self._counters(self.state)[1:].tolist())
        if cfg.ingest_guard:
            # learn the next increment's admission budget from this one's
            # action-queue hi-water marks
            self._update_ingest_budget()
        self.stream_pos += 1
        self.total_cycles += cycles
        res = IncrementResult(cycles, *traces, *counters, frames)
        for k, v in zip(("hops", "execs", "stalls", "allocs"), counters):
            self.totals[k] += v
        return res

    def _reset_increment(self, cfg: EngineConfig) -> None:
        """``increment_reset_leaves(cfg)`` zeroed (on every tile, where
        sharded)."""
        if self._sharded:
            _cca().reset_increment(cfg, self.state)
            return
        self.state = self.state._replace(**{
            k: torch.zeros_like(getattr(self.state, k))
            for k in increment_reset_leaves(cfg)})

    # -- the ingest guard: tm_hiw-gated admission (DESIGN §9) --

    def _ingest_limit(self) -> int | None:
        return self._ingest_budget if self.cfg.ingest_guard else None

    def _update_ingest_budget(self) -> None:
        """AIMD-style admission control from the action-queue hi-water
        plane: halve the admission budget a load when a cell's queue
        crested within the reserve band of ``queue_cap`` (the §4.2
        pre-wedge signature), double it back while the fabric runs below
        half the band; never below ``io_cells``, never above the stream
        buffers' ``io_cells * io_stream_cap``."""
        cfg = self.cfg
        ceiling = cfg.queue_cap - cfg.aq_reserve - cfg.sys_reserve
        cap = cfg.io_cells * cfg.io_stream_cap
        hiw = int(self._over_cells("tm_hiw", lambda t: t[..., TM_HW_AQ]
                                   .max(), "max"))
        cur = cap if self._ingest_budget is None else self._ingest_budget
        if hiw >= ceiling:
            cur = max(cfg.io_cells, cur // 2)
        elif hiw < max(1, ceiling // 2):
            cur = min(cap, cur * 2)
        self._ingest_budget = cur

    # -- durable state: boundary checkpoint / restore (DESIGN §9) --

    def checkpoint(self, ckpt, step: int | None = None,
                   block: bool = True) -> int:
        """Publish every state leaf, the stream cursor and the config
        fingerprint through ``ckpt`` (a
        :class:`repro_torch.train.Checkpointer`) at step ``step`` (default
        ``stream_pos``); a sharded state's whole grid, gathered (every
        process of a mesh gathers, the one holding rank 0 writes).  Sound
        only at an increment boundary, where
        ``run_increment(ckpt=...)`` calls it.  ``block=False`` copies the
        state to host memory and writes on the writer thread.  The files
        are the JAX engine's: it restores them (strictly under its
        ``backend="jnp"``, the backend the fingerprint names)."""
        from repro_torch.resilience.checkpoint import stream_manifest
        step = self.stream_pos if step is None else step
        save = ckpt.save if block else ckpt.save_async
        state = self._whole()
        if self._sharded and 0 not in self.state.ranks:
            return step        # one process of a mesh writes: rank 0's
        save(step, state._asdict(), extra=stream_manifest(self))
        return step

    @classmethod
    def restore(cls, cfg: EngineConfig, app: str | DiffusionApp, ckpt,
                step: int | None = None, shardings=None, strict: bool = True,
                verify: bool = True, device=None) -> "StreamingEngine":
        """An engine rebuilt from a boundary checkpoint on ``device``
        (``None``: the card): replaying the rest of the stream from its
        ``stream_pos`` reproduces the uninterrupted run bit-exactly.
        ``shardings`` ``(mesh, specs)``, the specs
        ``dist.sharding.cca_state_shardings(mesh, ...)`` gives (a spec
        names no mesh, so the pair does), restores the state sharded over
        ``mesh`` (``dist.cca.shard_state``) on its transport's device:
        JAX's ``restore(shardings=)``.  ``strict`` refuses a checkpoint
        saved under another config or app; it accepts one written by the
        JAX engine under either of its backends (both run one state
        layout bit-exactly).  Every leaf must have the dtype and shape
        ``init_state`` gives ``cfg``."""
        from repro_torch.resilience.checkpoint import (JAX_BACKENDS,
                                                       config_fingerprint)
        mesh = None
        if shardings is not None:
            from repro_torch.dist.sharding import cca_state_shardings
            if not (isinstance(shardings, tuple) and len(shardings) == 2):
                raise TypeError("shardings must be (mesh, "
                                "cca_state_shardings(mesh, state))")
            mesh, specs = shardings
            if device is not None and torch.device(device) \
                    != mesh.transport.device:
                raise ValueError(f"device {device} is not the mesh's "
                                 f"{mesh.transport.device}")
            device = mesh.transport.device
        eng = cls(cfg, app, device=device)
        like = init_state(eng.cfg, device="meta")
        if mesh is not None and specs != cca_state_shardings(mesh, like):
            raise ValueError("shardings: the sharded engine lays the state "
                             "out by cca_state_shardings' specs only")
        tree, extra, step = ckpt.restore(like._asdict(), step=step,
                                         verify=verify)
        if strict:
            fps = [config_fingerprint(eng.cfg, b) for b in JAX_BACKENDS]
            if extra.get("config") not in fps:
                raise ValueError(
                    f"checkpoint step {step} was saved under config "
                    f"{extra.get('config')}, engine is {fps[0]}: restoring "
                    "across configs would reinterpret the address/queue "
                    "layout silently (strict=False only for post-mortem "
                    "inspection)")
            if extra.get("app") != eng.app.name:
                raise ValueError(
                    f"checkpoint app '{extra.get('app')}' != engine app "
                    f"'{eng.app.name}'")
        eng.state = state_from_numpy(eng.cfg, tree, device=eng.device)
        if mesh is not None:
            eng.state = _cca().shard_state(eng.cfg, eng.state, mesh)
        eng.stream_pos = int(extra.get("stream_pos", step))
        eng.total_cycles = int(extra.get("total_cycles", 0))
        eng.totals.update({k: int(v) for k, v in
                           extra.get("totals", {}).items()})
        return eng

    @staticmethod
    def _spill_msg(limit: int, spill) -> str:
        return (f"cycle limit {limit} exhausted with {len(spill)} spilled "
                "edges not yet ingested; raise max_cycles or io_stream_cap")

    def _passes(self, cfg: EngineConfig, spill, limit: int, rings: list,
                cycles: int = 0):
        """The device loop's passes under ``cfg`` until quiescence with
        the spill drained, or the cycle or livelock budget (``limit``
        less the ``cycles`` the increment has run).  Appends each pass's
        frame ring (on the host) to ``rings`` when telemetry is on.
        Returns ``(cycles, quiescent, no-progress chunks, counters,
        spill)``, ``cycles`` the increment's so far."""
        while True:
            ran, q, noprog, counters = self._pass(cfg, limit - cycles, rings)
            cycles += ran
            if q and len(spill):
                # io_stream_cap overflow residue: the loaded prefix is
                # consumed at quiescence, so reload the rest
                if cfg.ingest_guard:
                    self._update_ingest_budget()
                spill = self._load(cfg, spill, self._ingest_limit())
                continue
            return cycles, q, noprog, counters, spill

    # -- detection and repair: the §8 invariants as a loss detector (§9) --

    def _loss_count(self) -> int:
        """Messages lost this increment: the dropped and the corrupted
        (the fault counters) and, with telemetry, at least link
        departures (``stat_hops``) less deliveries (``sum(TM_HOP)``) plus
        the corrupted, a count that does not read the injection's own
        bookkeeping."""
        from repro_torch.resilience.faults import FLT_CORRUPT, FLT_DROP
        st = self.state
        flt = (_cca().reduce_tiles(st, lambda t, g: t.flt) if self._sharded
               else st.flt).tolist()
        lost = flt[FLT_DROP] + flt[FLT_CORRUPT]
        if self.cfg.telemetry:
            arrived = self._over_cells("tm_cell", lambda t: t[..., TM_HOP]
                                       .sum(dtype=torch.int32))
            hops = self._counters(st)[1]
            lost = max(lost, int(hops - arrived) + flt[FLT_CORRUPT])
        return lost

    def _repair_entries(self) -> np.ndarray:
        """Stream rows that re-inject every finite durable value at every
        active rhizome root of its vertex: sentinel rows ``(vid, -(k+1),
        value bits)`` that the IO cells turn into ``OP_REPAIR``.  The
        roots' values are combined with the app's ``combine`` and a
        vertex still at ``init_val`` is skipped.  Their forced
        re-diffusion over the intact edge storage is one full monotone
        relaxation from correct sources: it reaches the exact fixpoint in
        one fault-free round."""
        cfg, app = self.cfg, self.app
        r, c, s = _roots(cfg, cfg.n_vertices)                  # [R, n]
        st = self._leaves("vals", "rhz_on")
        vals = st.vals[..., 0].cpu().numpy()[r, c, s]
        on = st.rhz_on.cpu().numpy()[r, c, s]
        on[0, :] = True                # the canonical root is always live
        v = functools.reduce(app.combine, vals)                  # [n]
        tgt = on & (v != np.float32(app.init_val))[None, :]
        kk, vv = np.nonzero(tgt)
        bits = np.ascontiguousarray(v[vv].astype(np.float32)).view(np.int32)
        return np.stack([vv.astype(np.int32), (-(kk + 1)).astype(np.int32),
                         bits], axis=1).astype(np.int32)

    def _repair_rounds(self, limit: int, cycles: int, rings: list) -> int:
        """The bounded repair pass: while the loss detector fires at the
        end of the increment, re-inject the durable values as
        ``OP_REPAIR`` traffic and run to quiescence under the plan's
        zero-rate twin (``FaultPlan.safe()``: the repair rides a reliable
        transport, and the state keeps its shapes).  A round that leaves
        the loss count as it was ends the pass.  Returns the increment's
        cycles, the repair's included; appends the repair passes' frame
        rings to ``rings``."""
        cfg = self.cfg
        plan = cfg.faults
        if self._loss_count() == 0:
            return cycles
        safe_cfg = dataclasses.replace(cfg, faults=plan.safe())
        for _ in range(plan.max_repair_rounds):
            before = self._loss_count()
            entries = self._repair_entries()
            if not len(entries):
                break                  # nothing durable to re-diffuse
            spill = self._load(cfg, entries)
            cycles, q, noprog, _, spill = self._passes(
                safe_cfg, spill, limit, rings, cycles)
            if not q and noprog >= LIVELOCK_CHUNKS:
                _raise_livelock(
                    safe_cfg, cycle=cycles, chunk=cycles // cfg.chunk,
                    frames=(obs_frames.FrameLog.from_rings(rings)
                            if rings else None))
            if len(spill):
                raise RuntimeError(self._spill_msg(limit, spill))
            if self._loss_count() == before:
                break                  # a clean round: the fixpoint
        else:
            raise RuntimeError(
                f"repair budget exhausted: {plan.max_repair_rounds} "
                "rounds each lost messages — the repair transport is "
                "expected to be fault-free (FaultPlan.safe()); see "
                "DESIGN.md §9")
        return cycles

    def _run_traced(self, cfg: EngineConfig, spill, limit: int):
        """The JAX engine's traced host loop (``_run_increment_traced``):
        the cycle limit checked before each chunk over the whole
        increment, the no-progress count on ``stat_exec + stat_hops``
        taken on chunks that ran in full and kept across spill reloads.
        Each chunk is one ``cca_cycle_chunk`` call that fills a trace row
        a cycle, read back with the launch record (this is the debug path:
        one host read a chunk).  With telemetry, one frame ring over the
        whole increment: a baseline frame, then a frame every loop turn,
        also a turn that launches nothing because the last chunk ended on
        quiescence (JAX's frozen chunk).  Returns ``(cycles, spill,
        (active, in_flight), frames or None)``."""
        trace = torch.empty((cfg.chunk, 2), dtype=torch.int32,
                            device=self._device)
        ring = None
        if cfg.telemetry:
            ring = obs_frames.ring_store(
                obs_frames.init_ring(cfg, self._device),
                self._snapshot(cfg, self.state))
        rows = []
        cycles, last, noprog, quiet, qr = 0, 0, 0, False, None
        while cycles < limit:
            ran = 0
            if not quiet:
                # (a state quiescent at the end of a full chunk runs no
                # cycle in the next: JAX's chunk freezes at once)
                self.state, qr = self._chunk(cfg, self.state, trace)
            if ring is not None:
                ring = obs_frames.ring_store(
                    ring, self._snapshot(cfg, self.state, qr[0]))
            if not quiet:
                c = self._counters(self.state)
                buf = torch.cat([qr, (c[2] + c[1])[None],
                                 trace.view(-1)]).cpu().numpy()
                quiet, ran, prog = bool(buf[0]), int(buf[1]), int(buf[2])
                rows.append(buf[3:3 + 2 * ran].reshape(ran, 2))
            cycles += ran
            if ran < cfg.chunk:          # quiescent within this chunk
                if len(spill):
                    spill = self._load(cfg, spill)
                    quiet = False
                    continue
                break
            noprog = noprog + 1 if prog == last else 0
            last = prog
            if noprog >= LIVELOCK_CHUNKS:
                _raise_livelock(cfg, cycle=cycles, chunk=cycles // cfg.chunk,
                                frames=self._frames(ring))
        rows = np.concatenate(rows) if rows else np.zeros((0, 2), np.int32)
        return cycles, spill, (np.ascontiguousarray(rows[:, 0]),
                               np.ascontiguousarray(rows[:, 1])), \
            self._frames(ring)

    @staticmethod
    def _frames(ring):
        return (None if ring is None
                else obs_frames.FrameLog.from_rings([ring.host()]))

    def _pass(self, cfg: EngineConfig, limit: int, rings: list):
        """Chunks until quiescence, the cycle ``limit`` (checked between
        chunks) or ``LIVELOCK_CHUNKS`` chunks without progress.  With
        telemetry, a frame ring for the pass: the baseline frame, then a
        frame after every chunk, taken on the device before the host reads
        the launch record, and appended to ``rings`` in one transfer at
        the end.  Returns ``(cycles run, quiescent, no-progress chunks,
        (hops, execs, stalls, allocs))``; the counters are
        increment-cumulative."""
        st = self.state
        ring = None
        if cfg.telemetry:
            ring = obs_frames.ring_store(
                obs_frames.init_ring(cfg, self._device),
                self._snapshot(cfg, st))
        start, hops, execs, stalls, allocs = self._counters(st).tolist()
        cycle, last, noprog, q = start, hops + execs, 0, None
        while cycle - start < limit and noprog < LIVELOCK_CHUNKS:
            st, qr = self._chunk(cfg, st)
            if ring is not None:
                stored = obs_frames.ring_store(
                    ring, self._snapshot(cfg, st, qr[0]))
            cycle, hops, execs, stalls, allocs, q, ran = torch.cat(
                [self._counters(st), qr]).tolist()
            # a state quiescent on entry runs no cycle, and JAX's loop no
            # chunk: its frame is not counted (its slot was still free)
            if ring is not None and ran:
                ring = stored
            noprog = noprog + 1 if hops + execs == last else 0
            last = hops + execs
            if q:
                break
        if q is None:
            q = bool(_cca().quiescent(st) if self._sharded
                     else quiescent(st))
        self.state = st
        if ring is not None:
            rings.append(ring.host())
        return cycle - start, bool(q), noprog, (hops, execs, stalls, allocs)

    def values(self, n: int | None = None, val_idx: int = 0,
               combine=None) -> np.ndarray:
        """Vertex values of value slot ``val_idx``, ``float32 [n]``: the
        app's ``combine`` (min, or max for the max-monotone apps) over
        every rhizome root of each vertex, or ``combine`` when given (a
        query-batched composite passes the combine of the query living in
        ``val_idx``)."""
        r, c, s = _roots(self.cfg, n or self.cfg.n_vertices)
        v = self._leaves("vals").vals[..., val_idx].cpu().numpy()[r, c, s]
        return functools.reduce(combine or self.app.combine, v)

    def vertex_object_stats(self) -> dict:
        """Ghost usage and locality of the hierarchical vertex objects,
        and at ``rhizome_cap > 1`` the rhizome fan-out and the spread of
        the active co-equal roots over the mesh."""
        cfg = self.cfg
        st = self._leaves("gstate", "gaddr", "nfree", "rhz_on")
        gs = st.gstate.cpu().numpy()
        ga = st.gaddr.cpu().numpy()
        used = int(np.sum(st.nfree.cpu().numpy() - cfg.primary_slots))
        out = dict(ghosts=used, mean_hops=0.0, max_hops=0,
                   rhizomes=0, multi_root_vertices=0, max_fanout=1,
                   mean_rhizome_hops=0.0)
        have = gs == 2
        if have.any():
            rr, cc, _ = np.nonzero(have)
            tgt = ga[have] // cfg.slots
            d = np.abs(rr - tgt // cfg.width) + np.abs(cc - tgt % cfg.width)
            out.update(mean_hops=float(d.mean()), max_hops=int(d.max()))
        if cfg.rhizome_cap > 1:
            r, c, s = _roots(cfg, cfg.n_vertices)
            act = st.rhz_on.cpu().numpy()[r, c, s][1:]   # secondary roots
            fan = 1 + act.sum(axis=0)
            d = np.abs(r[1:] - r[0]) + np.abs(c[1:] - c[0])
            out.update(rhizomes=int(fan.sum() - cfg.n_vertices),
                       multi_root_vertices=int((fan > 1).sum()),
                       max_fanout=int(fan.max()),
                       mean_rhizome_hops=(float(d[act].mean())
                                          if act.any() else 0.0))
        return out
