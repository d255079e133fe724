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
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.alloc import rhizome_rcs
from repro_torch.core.apps import APPS, DiffusionApp
from repro_torch.core.config import EngineConfig
from repro_torch.core.exec_stage import phase0_stage, staging_stage
from repro_torch.core.ingest import io_stage, load_stream
from repro_torch.core.routing import hop_stage, park_stage
from repro_torch.core.state import (TM_HOP, TM_L_OCC, MachineState,
                                    init_state, resolve_device)
from repro_torch.obs import frames as obs_frames
from repro_torch.obs.flight import render_wedge_report

# this many consecutive chunks with no executed action and no hop while
# work is pending => message-dependent deadlock (DESIGN §4.2)
LIVELOCK_CHUNKS = 8


class CycleStats(NamedTuple):
    active: torch.Tensor      # cells doing compute/staging work this cycle
    in_flight: torch.Tensor   # messages sitting in channels
    backlog: torch.Tensor     # queued actions
    hops: torch.Tensor        # link traversals this cycle
    quiescent: torch.Tensor   # bool


def _rc(cfg: EngineConfig, device):
    rows = torch.arange(cfg.height, dtype=torch.int32, device=device)
    cols = torch.arange(cfg.width, dtype=torch.int32, device=device)
    return (rows[:, None].expand(cfg.height, cfg.width),
            cols[None, :].expand(cfg.height, cfg.width))


def quiescent(st: MachineState) -> torch.Tensor:
    """0-d bool: no work left anywhere in the machine."""
    return ((st.aq_n.sum() == 0) & (st.ch_n.sum() == 0)
            & (st.pk_n.sum() == 0) & ~st.cvalid.any()
            & (st.fq_n.sum() == 0) & ~st.fwd_pending.any()
            & ((st.io_n - st.io_pos).sum() == 0))


def cycle_body(cfg: EngineConfig, app: DiffusionApp, st: MachineState):
    """One machine cycle: hop -> park (lanes > 1) -> staging -> phase0 ->
    io.  Returns the new state and the per-cell activity masks and hop
    count of the cycle."""
    rows, cols = _rc(cfg, st.aq_n.device)
    busy0 = st.cvalid
    if cfg.telemetry:
        # lane occupancy at cycle entry (mean depth = TM_L_OCC / cycles)
        tm = st.tm_lane.clone()
        tm[..., TM_L_OCC] += st.ch_n
        st = st._replace(tm_lane=tm)
    st, hops = hop_stage(cfg, st, rows, cols)
    if cfg.lanes > 1:
        # while the lane slots the hops just vacated are free
        st = park_stage(cfg, st, rows, cols)
    st, active_a = staging_stage(cfg, app, st, rows, cols)
    st, popped = phase0_stage(cfg, app, st, rows, cols, busy0)
    st = io_stage(cfg, st, rows, cols)
    if cfg.telemetry:
        hw = torch.stack([st.aq_n, st.pk_n], dim=-1)
        st = st._replace(tm_hiw=torch.maximum(st.tm_hiw, hw))
    st = st._replace(cycle=st.cycle + 1, stat_hops=st.stat_hops + hops)
    return st, (active_a, popped, hops)


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


class StreamingEngine:
    """Host-side driver: the accelerator-style main() of paper Listing 1.

    ``device=None`` means the card (``cuda``); pass ``device="cpu"`` to
    run the plain PyTorch version.
    """

    def __init__(self, cfg: EngineConfig, app: str = "bfs", device=None):
        if app not in APPS:
            raise NotImplementedError(
                f"repro_torch ports the apps {sorted(APPS)}, not {app!r}")
        self.app = APPS[app]
        self.cfg = dataclasses.replace(cfg, n_vals=self.app.n_vals,
                                       qbatch=self.app.qbatch)
        self.device = resolve_device(device)
        self.state = init_state(self.cfg, init_vals=self.app.init_val,
                                fwd_init=self.app.fwd_neutral,
                                device=self.device)
        self.total_cycles = 0
        self.totals = dict(hops=0, execs=0, stalls=0, allocs=0)
        self.stream_pos = 0

    def seed(self, vid: int, value: float, val_idx: int = 0):
        """Host-write a value into every rhizome root of ``vid`` (e.g. the
        BFS source gets level 0 before the stream), so the co-equal roots
        start value-synced."""
        r, c, s = (torch.as_tensor(a, device=self.device) for a in
                   rhizome_rcs(self.cfg, vid,
                               np.arange(self.cfg.rhizome_cap)))
        self.state.vals[r, c, s, val_idx] = value

    def run_increment(self, edges: np.ndarray, max_cycles: int | None = None,
                      collect_traces: bool = False, recover=None,
                      ckpt=None) -> IncrementResult:
        """Ingest ``edges`` (int32 ``[m, 3]``: src, dst, weight bits) and
        run to quiescence.  Raises :class:`LivelockError` on a detected
        deadlock.  ``collect_traces=True`` returns the per-cycle
        ``active_per_cycle`` and ``in_flight_per_cycle`` (the same state
        and totals either way)."""
        for name, on in (("recover", recover is not None),
                         ("ckpt", ckpt is not None)):
            if on:
                raise NotImplementedError(
                    f"repro_torch does not port run_increment({name}=...) "
                    "yet (ROADMAP.md queue 1, item 4(b): durable state and "
                    "recovery)")
        cfg = self.cfg
        limit = max_cycles or cfg.max_cycles
        self.state, spill = load_stream(cfg, self.state, edges)
        zero = torch.zeros((), dtype=torch.int32, device=self.device)
        self.state = self.state._replace(
            stat_hops=zero.clone(), stat_exec=zero.clone(),
            stat_stall=zero.clone(), stat_allocs=zero.clone())
        if cfg.faults is not None:
            # the fault counters reset with the counters: the loss
            # detector reconciles each increment on its own
            self.state = self.state._replace(
                flt=torch.zeros_like(self.state.flt))
        if cfg.telemetry:
            # the planes reset with the counters, so the increment's final
            # frame reconciles with them
            self.state = self.state._replace(
                tm_cell=torch.zeros_like(self.state.tm_cell),
                tm_lane=torch.zeros_like(self.state.tm_lane),
                tm_hiw=torch.zeros_like(self.state.tm_hiw))
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
            counters = tuple(torch.stack(
                [self.state.stat_hops, self.state.stat_exec,
                 self.state.stat_stall, self.state.stat_allocs]).tolist())
        self.stream_pos += 1
        self.total_cycles += cycles
        res = IncrementResult(cycles, *traces, *counters, frames)
        for k, v in zip(("hops", "execs", "stalls", "allocs"), counters):
            self.totals[k] += v
        return res

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
                self.state, spill = load_stream(cfg, self.state, spill)
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
        flt = self.state.flt.tolist()
        lost = flt[FLT_DROP] + flt[FLT_CORRUPT]
        if self.cfg.telemetry:
            gap = int(self.state.stat_hops
                      - self.state.tm_cell[..., TM_HOP].sum())
            lost = max(lost, gap + flt[FLT_CORRUPT])
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
        vals = self.state.vals[..., 0].cpu().numpy()[r, c, s]
        on = self.state.rhz_on.cpu().numpy()[r, c, s]
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
            self.state, spill = load_stream(cfg, self.state, entries)
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
        from repro_torch.kernels.cca_cycle.ops import cca_cycle_chunk
        trace = torch.empty((cfg.chunk, 2), dtype=torch.int32,
                            device=self.device)
        ring = None
        if cfg.telemetry:
            ring = obs_frames.ring_store(
                obs_frames.init_ring(cfg, self.device),
                obs_frames.snapshot(cfg, self.state))
        rows = []
        cycles, last, noprog, quiet, qr = 0, 0, 0, False, None
        while cycles < limit:
            ran = 0
            if not quiet:
                # (a state quiescent at the end of a full chunk runs no
                # cycle in the next: JAX's chunk freezes at once)
                st, qr = cca_cycle_chunk(cfg, self.app, self.state,
                                         trace=trace)
                self.state = st
            if ring is not None:
                ring = obs_frames.ring_store(
                    ring, obs_frames.snapshot(cfg, self.state, qr[0]))
            if not quiet:
                buf = torch.cat([qr, (st.stat_exec + st.stat_hops)[None],
                                 trace.view(-1)]).cpu().numpy()
                quiet, ran, prog = bool(buf[0]), int(buf[1]), int(buf[2])
                rows.append(buf[3:3 + 2 * ran].reshape(ran, 2))
            cycles += ran
            if ran < cfg.chunk:          # quiescent within this chunk
                if len(spill):
                    self.state, spill = load_stream(cfg, self.state, spill)
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
        from repro_torch.kernels.cca_cycle.ops import cca_cycle_chunk
        st = self.state
        ring = None
        if cfg.telemetry:
            ring = obs_frames.ring_store(
                obs_frames.init_ring(cfg, st.aq.device),
                obs_frames.snapshot(cfg, st))
        start, hops, execs, stalls, allocs = torch.stack(
            [st.cycle, st.stat_hops, st.stat_exec, st.stat_stall,
             st.stat_allocs]).tolist()
        cycle, last, noprog, q = start, hops + execs, 0, None
        while cycle - start < limit and noprog < LIVELOCK_CHUNKS:
            st, qr = cca_cycle_chunk(cfg, self.app, st)
            if ring is not None:
                stored = obs_frames.ring_store(
                    ring, obs_frames.snapshot(cfg, st, qr[0]))
            cycle, hops, execs, stalls, allocs, q, ran = torch.cat(
                [torch.stack([st.cycle, st.stat_hops, st.stat_exec,
                              st.stat_stall, st.stat_allocs]), qr]).tolist()
            # a state quiescent on entry runs no cycle, and JAX's loop no
            # chunk: its frame is not counted (its slot was still free)
            if ring is not None and ran:
                ring = stored
            noprog = noprog + 1 if hops + execs == last else 0
            last = hops + execs
            if q:
                break
        if q is None:
            q = bool(quiescent(st))
        self.state = st
        if ring is not None:
            rings.append(ring.host())
        return cycle - start, bool(q), noprog, (hops, execs, stalls, allocs)

    def values(self, n: int | None = None, val_idx: int = 0) -> np.ndarray:
        """Vertex values, ``float32 [n]``: the app's ``combine`` (min, or
        max for the max-monotone apps) over every rhizome root of each
        vertex."""
        r, c, s = _roots(self.cfg, n or self.cfg.n_vertices)
        v = self.state.vals[..., val_idx].cpu().numpy()[r, c, s]
        return functools.reduce(self.app.combine, v)

    def vertex_object_stats(self) -> dict:
        """Ghost usage and locality of the hierarchical vertex objects,
        and at ``rhizome_cap > 1`` the rhizome fan-out and the spread of
        the active co-equal roots over the mesh."""
        cfg, st = self.cfg, self.state
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
