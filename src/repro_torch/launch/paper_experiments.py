"""The paper's experiments on the port (``benchmarks/paper_experiments.py``
of the JAX package, and the cycle-count half of its
``benchmarks/engine_throughput.py::bench_engine``): one function per table
or figure, with the same scales, engine config and row keys.

  Fig. 8/9   bench_cycles_per_increment: cycles per increment, ingestion
             only against ingestion plus BFS
  Table 2    bench_energy: energy (uJ) and time (us) at 1 GHz of the
             modelled chip (``core/energy.py``)
  Fig. 5     bench_allocator: vicinity against random ghost allocation
  Fig. 6/7   bench_activation: per-cycle active-cell traces
             bench_skew: rhizome vertex objects against the serial ghost
             chain on a power-law (R-MAT) stream
             bench_lanes: virtual lanes against the single-FIFO channel on
             the same stream at the normal queue size
             bench_engine_throughput, bench_engine: the simulator's own
             cycle counts (and wall times on the card)
             fault_smoke (``--faults``): ``bench_engine``'s stream under
             a seeded fault plan, repaired to the exact BFS values
             (``benchmarks/resilience_smoke.py::fault_smoke``)
             kill_resume_smoke, recovery_smoke, profile_resilience
             (``--resilience``): a checkpointed stream killed and
             resumed bit-exactly, the lanes=1 hub wedge recovered by
             escalation, and the checkpoint cadence's cost
             (``benchmarks/resilience_smoke.py``)

Cycle counts, hops, execs, energies and modelled times do not depend on
the device; wall times are reported only where the engine ran on the card.
Every chunk is one launch of the cycle kernel on the card (the plain
PyTorch version on the CPU).  The rows are printed as JSON, one line a
benchmark; only ``--profile`` writes files (the telemetry run's Chrome
trace and congestion heatmap, under ``build/profile/``) and ``--out``
(the fault smokes' records, under the directory it names); the
resilience smokes' checkpoints go to temporary directories (under
``--out`` when given), removed when each run ends.

    PYTHONPATH=src python -m repro_torch.launch.paper_experiments --scale ci
    PYTHONPATH=src python -m repro_torch.launch.paper_experiments \\
        --scale ci --device cpu --only energy
    PYTHONPATH=src python -m repro_torch.launch.paper_experiments \\
        --only engine --profile
    PYTHONPATH=src python -m repro_torch.launch.paper_experiments \\
        --faults --out build/faults
    PYTHONPATH=src python -m repro_torch.launch.paper_experiments \\
        --resilience --scale paper --out build/ckpt
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import pathlib
import tempfile
import time

import numpy as np
import torch

from repro_torch.core import EngineConfig, LivelockError, StreamingEngine
from repro_torch.core.energy import DEFAULT as ENERGY
from repro_torch.core.engine import quiescent
from repro_torch.core.reference import bfs_levels
from repro_torch.core.state import (TM_ALLOC, TM_EXEC, TM_HOP, TM_IO,
                                    TM_PARK, TM_STALL, resolve_device)
from repro_torch.graph.streams import StreamSpec, hub_edges, make_stream
from repro_torch.kernels.cca_cycle import ops
from repro_torch.resilience import FLT_CORRUPT, FLT_DROP, FaultPlan

SCALES = {
    "ci": dict(n_vertices=2000, n_edges=20_000),
    "mid": dict(n_vertices=10_000, n_edges=100_000),
    "paper": dict(n_vertices=50_000, n_edges=1_000_000),
}
# benchmarks/engine_throughput.py's grids
ENGINE_SCALES = {
    "ci": dict(height=8, width=8, n_vertices=256, n_edges=2048, chunk=64),
    "mid": dict(height=16, width=16, n_vertices=2048, n_edges=16_384,
                chunk=128),
}
MAX_CYCLES = 2_000_000


def _scale(scale) -> dict:
    """A ``SCALES`` name, or a dict of ``n_vertices`` and ``n_edges``."""
    return dict(scale) if isinstance(scale, dict) else SCALES[scale]


def _key(scale):
    return tuple(sorted(scale.items())) if isinstance(scale, dict) else scale


@functools.lru_cache(maxsize=2)
def _increments(spec: StreamSpec) -> tuple:
    incs = make_stream(spec)
    for e in incs:
        e.setflags(write=False)       # shared by every caller
    return tuple(incs)


def stream_increments(sampling: str, scale) -> tuple:
    """The ten increments of ``run_stream``'s stream (seed 1), read-only,
    generated once for the last two streams asked for (a 1M-edge stream
    takes seconds to draw)."""
    return _increments(StreamSpec(increments=10, sampling=sampling, seed=1,
                                  **_scale(scale)))


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def experiment_config(n_vertices: int, n_edges: int = 0,
                      allocator="vicinity", chunk=512) -> EngineConfig:
    """``benchmarks/paper_experiments.py::_engine``'s 32x32 config."""
    # ghost capacity must cover the spilled edge blocks: ~E/edge_cap
    # RPVO blocks across 1024 cells, x2 for placement skew (exhausting
    # ghost slots livelocks the allocate forwarding chain -- DESIGN §4.2)
    ghosts = max(64, 2 * n_edges // (8 * 1024), 3 * n_vertices // 1024)
    return EngineConfig(height=32, width=32, n_vertices=n_vertices,
                        edge_cap=8, ghost_slots=ghosts,
                        queue_cap=64, chan_cap=16, futq_cap=16,
                        io_stream_cap=2 ** 21, chunk=chunk,
                        allocator=allocator)


def _engine(n_vertices: int, app: str, allocator="vicinity", chunk=512,
            n_edges: int = 0, device=None) -> StreamingEngine:
    eng = StreamingEngine(experiment_config(n_vertices, n_edges, allocator,
                                            chunk), app, device=device)
    if app != "ingest_only":
        eng.seed(0, 0.0)
    return eng


_CACHE: dict = {}


def run_stream(app: str, sampling: str, scale, allocator="vicinity",
               verify=False, collect_traces=False, device=None):
    """One ten-increment stream, seed 1: ``(rows, engine)``, one row an
    increment.  Cached by its arguments; an untraced request is served by
    a traced run of the same stream (the same totals)."""
    dev = resolve_device(device)
    key = (app, sampling, _key(scale), allocator, collect_traces, str(dev))
    if key in _CACHE and not verify:
        return _CACHE[key]
    if not collect_traces and not verify:
        traced = _CACHE.get(key[:4] + (True, str(dev)))
        if traced is not None:
            return traced
    spec = StreamSpec(increments=10, sampling=sampling, seed=1,
                      **_scale(scale))
    incs = stream_increments(sampling, scale)
    eng = _engine(spec.n_vertices, app, allocator, n_edges=spec.n_edges,
                  device=dev)
    rows = []
    for i, e in enumerate(incs):
        r = eng.run_increment(e, max_cycles=MAX_CYCLES,
                              collect_traces=collect_traces)
        rows.append(dict(increment=i, edges=len(e), cycles=r.cycles,
                         execs=r.execs, hops=r.hops, allocs=r.allocs,
                         stalls=r.stalls,
                         active=r.active_per_cycle))
    if verify and app == "bfs":
        want = bfs_levels(spec.n_vertices, np.concatenate(incs), 0)
        got = eng.values(spec.n_vertices)
        assert (got == want).all(), "BFS mismatch vs the oracle"
    _CACHE[key] = (rows, eng)
    return rows, eng


# ------------------- Fig 8/9: cycles per increment -------------------

def bench_cycles_per_increment(scale="ci", sampling="edge", device=None):
    """Paper Fig. 8/9: per-increment cycles, ingestion-only vs +BFS.
    Returns ``(rows, seconds)``; the seconds only on the card, else
    ``None``."""
    dev = resolve_device(device)
    t0 = time.time()
    ing, _ = run_stream("ingest_only", sampling, scale, device=dev)
    bfs, _ = run_stream("bfs", sampling, scale, verify=(scale == "ci"),
                        device=dev)
    out = []
    for a, b in zip(ing, bfs):
        out.append(dict(increment=a["increment"], edges=a["edges"],
                        ingest_cycles=a["cycles"],
                        ingest_bfs_cycles=b["cycles"]))
    return out, (time.time() - t0 if dev.type == "cuda" else None)


# ------------------- Table 2: energy & time -------------------

def bench_energy(scale="ci", device=None):
    """Paper Table 2 analogue: energy (uJ) + time (us) of the modelled chip
    at 1 GHz."""
    rows = []
    for sampling in ("edge", "snowball"):
        for app, label in (("ingest_only", "Ingestion"),
                           ("bfs", "Ingestion & BFS")):
            data, eng = run_stream(app, sampling, scale, device=device)
            cycles = sum(r["cycles"] for r in data)
            hops = sum(r["hops"] for r in data)
            execs = sum(r["execs"] for r in data)
            allocs = sum(r["allocs"] for r in data)
            injects = sum(r["edges"] for r in data)
            rows.append(dict(
                sampling=sampling, mode=label,
                energy_uj=round(ENERGY.estimate_uj(
                    hops=hops, execs=execs, allocs=allocs,
                    injects=injects), 1),
                time_us=round(ENERGY.cycles_to_us(cycles), 2),
                cycles=cycles))
    return rows


# ------------------- Fig 5: allocator policies -------------------

def bench_allocator(scale="ci", device=None):
    """Vicinity vs random ghost allocation: locality + cycle cost."""
    rows = []
    for alloc in ("vicinity", "random"):
        data, eng = run_stream("bfs", "edge", scale, allocator=alloc,
                               device=device)
        stats = eng.vertex_object_stats()
        rows.append(dict(allocator=alloc,
                         cycles=sum(r["cycles"] for r in data),
                         hops=sum(r["hops"] for r in data),
                         ghosts=stats["ghosts"],
                         mean_ghost_hops=round(stats["mean_hops"], 2),
                         max_ghost_hops=stats["max_hops"]))
    return rows


# ------------------- Fig 6/7: activation traces -------------------

def bench_activation(scale="ci", sampling="edge", device=None):
    """Per-cycle active-cell counts (chip occupancy traces), summarised."""
    ing, _ = run_stream("ingest_only", sampling, scale, collect_traces=True,
                        device=device)
    bfs, _ = run_stream("bfs", sampling, scale, collect_traces=True,
                        device=device)
    trace_i = np.concatenate([r["active"] for r in ing])
    trace_b = np.concatenate([r["active"] for r in bfs])

    def summarize(t):
        return dict(cycles=len(t), mean_active=round(float(t.mean()), 1),
                    peak_active=int(t.max()),
                    mean_util_pct=round(100 * float(t.mean()) / 1024, 2))
    return dict(ingest=summarize(trace_i), ingest_bfs=summarize(trace_b))


# ------------- rhizomes and virtual lanes on skewed streams -------------

SKEW_SCALES = {
    "ci": dict(height=8, width=8, n_vertices=256, n_edges=4096),
    "mid": dict(height=16, width=16, n_vertices=2048, n_edges=32_768),
    "paper": dict(height=32, width=32, n_vertices=16_384, n_edges=262_144),
}
LANES_QUEUE_CAP = 48      # the normal queue size, shared by both benchmarks
SKEW_MAX_CYCLES = 4_000_000


def _skew_scale(scale) -> dict:
    """A ``SKEW_SCALES`` name, or a dict of its four keys."""
    return dict(scale) if isinstance(scale, dict) else SKEW_SCALES[scale]


@functools.lru_cache(maxsize=2)
def _skew_increments(key) -> tuple:
    p = dict(key) if isinstance(key, tuple) else SKEW_SCALES[key]
    incs = make_stream(StreamSpec(n_vertices=p["n_vertices"],
                                  n_edges=p["n_edges"], increments=4,
                                  kind="rmat", seed=2))
    for e in incs:
        e.setflags(write=False)
    return tuple(incs)


def skew_increments(scale) -> tuple:
    """The four increments of the R-MAT stream (seed 2) of both benchmarks,
    read-only, generated once for the last two scales asked for."""
    return _skew_increments(_key(scale))


def skew_config(scale, queue_cap: int = LANES_QUEUE_CAP, lanes: int = 2,
                rhizome_cap: int = 1) -> EngineConfig:
    """The config ``bench_skew`` (``lanes=2``) and ``bench_lanes``
    (``rhizome_cap=1``) build at ``scale``."""
    p = _skew_scale(scale)
    return EngineConfig(
        height=p["height"], width=p["width"], n_vertices=p["n_vertices"],
        edge_cap=8, ghost_slots=max(64, 4 * p["n_edges"]
                                    // (8 * p["height"] * p["width"])),
        queue_cap=queue_cap, chan_cap=32, futq_cap=8, io_stream_cap=2 ** 20,
        chunk=512, rhizome_cap=rhizome_cap, lanes=lanes)


def skew_row(scale, queue_cap: int = LANES_QUEUE_CAP, lanes: int = 2,
             rhizome_cap: int = 1, max_cycles: int = SKEW_MAX_CYCLES,
             verify: bool = True, device=None):
    """One config of ``skew_config`` over the R-MAT stream, BFS from vertex
    0, each increment run with ``max_cycles``.  Returns ``(row, engine)``.

    ``row["status"]`` is ``"ok"`` (every increment quiescent, and with
    ``verify`` the values the oracle's), ``"livelock"`` (``row
    ["livelock"]``: the increment, the cycle and chunk at which the engine
    raised ``LivelockError``, and its counters up to there) or
    ``"budget"`` (an increment ran out of ``max_cycles``).  ``increments``
    holds the counters of each increment that finished; ``launches`` the
    cycle-kernel launches by kernel; ``wall_s`` the wall time on the
    card."""
    dev = resolve_device(device)
    incs = skew_increments(scale)
    eng = StreamingEngine(skew_config(scale, queue_cap, lanes, rhizome_cap),
                          "bfs", device=dev)
    eng.seed(0, 0.0)
    before = dict(ops.path_launches)
    rows, status, livelock = [], "ok", None
    _sync(dev)
    t0 = time.time()
    for i, e in enumerate(incs):
        try:
            r = eng.run_increment(e, max_cycles=max_cycles)
        except LivelockError as ex:
            st = eng.state
            hops, execs, stalls, allocs = torch.stack(
                [st.stat_hops, st.stat_exec, st.stat_stall,
                 st.stat_allocs]).tolist()
            status, livelock = "livelock", dict(
                increment=i, cycle=ex.cycle, chunk=ex.chunk, hops=hops,
                execs=execs, stalls=stalls, allocs=allocs)
            break
        rows.append(dict(edges=len(e), cycles=r.cycles, hops=r.hops,
                         execs=r.execs, stalls=r.stalls, allocs=r.allocs))
        if not bool(quiescent(eng.state)):
            status = "budget"
            break
    _sync(dev)
    wall = time.time() - t0
    row = dict(queue_cap=queue_cap, lanes=lanes, rhizome_cap=rhizome_cap,
               status=status, increments=rows,
               cycles=sum(r["cycles"] for r in rows),
               hops=sum(r["hops"] for r in rows),
               stalls=sum(r["stalls"] for r in rows),
               launches={p: ops.path_launches[p] - before[p]
                         for p in ops.PATHS})
    if livelock:
        row["livelock"] = livelock
    if dev.type == "cuda":
        row["wall_s"] = wall
    if status == "ok" and verify:
        n = eng.cfg.n_vertices
        want = bfs_levels(n, np.concatenate(incs), 0)
        if not (eng.values(n) == want).all():
            raise AssertionError(f"BFS mismatch vs the oracle at lanes="
                                 f"{lanes}, rhizome_cap={rhizome_cap}")
    return row, eng


def _max_degree(scale) -> int:
    return int(np.bincount(np.concatenate(skew_increments(scale))[:, 0])
               .max())


def bench_skew(scale="ci", rhizome_caps=(1, 2, 4), verify=True,
               device=None):
    """Power-law (R-MAT) stream: the serial ghost chain (rhizome_cap=1)
    against rhizome vertex objects, at ``lanes=2`` and ``queue_cap=48``;
    values checked against the oracle.  Raises ``LivelockError`` where a
    config livelocks, as the JAX package's benchmark does."""
    deg = _max_degree(scale)
    rows = []
    for R in rhizome_caps:
        row, eng = skew_row(scale, rhizome_cap=R, verify=verify,
                            device=device)
        if row["status"] == "livelock":
            ll = row["livelock"]
            raise LivelockError(
                f"engine livelock at rhizome_cap={R} (increment "
                f"{ll['increment']})", cycle=ll["cycle"], chunk=ll["chunk"])
        s = eng.vertex_object_stats()
        rows.append(dict(rhizome_cap=R, cycles=row["cycles"],
                         hops=row["hops"], stalls=row["stalls"],
                         max_degree=deg,
                         degree_over_edge_cap=round(deg / 8, 1),
                         rhizomes=s["rhizomes"],
                         multi_root_vertices=s["multi_root_vertices"],
                         max_fanout=s["max_fanout"], ghosts=s["ghosts"]))
    return rows


def bench_lanes(scale="ci", lanes_list=(1, 2, 4), verify=True,
                out_json=None, device=None):
    """Virtual lanes on the R-MAT hub stream of :func:`bench_skew` at
    ``queue_cap=48``, and the ``lanes=1`` workaround with a 4x queue
    (``queue_cap=192``).  Returns ``(rows, baseline)``.  ``lanes=1`` may
    livelock; a ``lanes >= 2`` row or the baseline that does not finish
    raises ``SystemExit`` (the lanes-smoke gate).  ``out_json``, if given
    (under ``build/``, say), gets the rows under ``lanes_<scale>``."""
    deg = _max_degree(scale)

    def run(lanes, queue_cap):
        row, _ = skew_row(scale, queue_cap, lanes, 1, verify=verify,
                          device=device)
        ok = row["status"] == "ok"
        return dict(status=row["status"], cycles=row["cycles"] if ok else None,
                    stalls=row["stalls"] if ok else None)

    rows = []
    for L in lanes_list:
        r = run(L, LANES_QUEUE_CAP)
        r.update(lanes=L, queue_cap=LANES_QUEUE_CAP, max_degree=deg)
        rows.append(r)
    base = run(1, 192)
    base.update(lanes=1, queue_cap=192)
    bad = [r["lanes"] for r in rows if r["lanes"] >= 2
           and r["status"] != "ok"]
    if bad or base["status"] != "ok":
        raise SystemExit(
            f"lanes-smoke gate: livelock with lanes in {bad} "
            f"(baseline {base['status']})")
    if out_json:
        p = _skew_scale(scale)
        path = pathlib.Path(out_json)
        path.parent.mkdir(parents=True, exist_ok=True)
        data = json.loads(path.read_text()) if path.exists() else {}
        data[f"lanes_{scale}"] = dict(
            scale=scale, grid=f'{p["height"]}x{p["width"]}',
            n_edges=p["n_edges"], rows=rows, oversize_baseline=base)
        path.write_text(json.dumps(data, indent=1))
    return rows, base


# ------------------- engine throughput -------------------

def _walls(cycles: int, dt: float, n_cells: int) -> dict:
    return dict(wall_s=dt, cyc_per_s=cycles / dt,
                cell_cycles_per_s=cycles / dt * n_cells)


def bench_engine_throughput(scale="ci", device=None):
    """Simulator performance: the second increment of a two-increment
    stream (seed 2) after a 1000-edge warm-up; cell-cycles per wall second
    on the card."""
    dev = resolve_device(device)
    spec = StreamSpec(increments=2, sampling="edge", seed=2, **_scale(scale))
    incs = make_stream(spec)
    eng = _engine(spec.n_vertices, "bfs", device=dev)
    eng.run_increment(incs[0][:1000], max_cycles=20_000)
    _sync(dev)
    t0 = time.time()
    r = eng.run_increment(incs[1], max_cycles=MAX_CYCLES)
    _sync(dev)
    out = dict(cycles=r.cycles)
    if dev.type == "cuda":
        out.update(_walls(r.cycles, time.time() - t0, eng.cfg.n_cells))
    return out


def engine_config(scale, **kw) -> EngineConfig:
    """``benchmarks/engine_throughput.py::_cfg``: the engine config of
    ``bench_engine`` and ``fault_smoke`` on ``ENGINE_SCALES[scale]``'s
    grid, with ``kw`` on top."""
    p = ENGINE_SCALES[scale]
    base = dict(height=p["height"], width=p["width"],
                n_vertices=p["n_vertices"], edge_cap=8,
                ghost_slots=max(64, 4 * p["n_edges"]
                                // (8 * p["height"] * p["width"])),
                queue_cap=64, chan_cap=16, futq_cap=8, io_stream_cap=2 ** 18,
                chunk=p["chunk"])
    base.update(kw)
    return EngineConfig(**base)


def bench_engine(scale="ci", device=None, profile=False, profile_dir=None):
    """``benchmarks/engine_throughput.py::bench_engine``'s stream (seed 3,
    two edge-sampled increments, BFS from vertex 0) on its ``ci`` or
    ``mid`` grid: the second increment's cycles, execs and hops and the
    stream's total cycles, BFS checked against the oracle; its wall time on
    the card.  ``profile=True`` (``--profile``) adds the same run with
    ``telemetry=True`` under ``"profile"`` (``_profile``), its dumps
    written under ``profile_dir`` (default ``build/profile/`` of the
    repository)."""
    dev = resolve_device(device)
    p = ENGINE_SCALES[scale]
    spec = StreamSpec(n_vertices=p["n_vertices"], n_edges=p["n_edges"],
                      increments=2, sampling="edge", seed=3)
    incs = make_stream(spec)
    want = bfs_levels(p["n_vertices"], np.concatenate(incs), 0)
    cfg = engine_config(scale)
    eng = StreamingEngine(cfg, "bfs", device=dev)
    eng.seed(0, 0.0)
    eng.run_increment(incs[0], max_cycles=MAX_CYCLES)
    _sync(dev)
    t0 = time.time()
    r = eng.run_increment(incs[1], max_cycles=MAX_CYCLES)
    _sync(dev)
    dt = time.time() - t0
    np.testing.assert_array_equal(eng.values(p["n_vertices"]), want)
    out = dict(scale=scale, grid=f'{p["height"]}x{p["width"]}',
               n_vertices=p["n_vertices"], n_edges=p["n_edges"],
               chunk=p["chunk"], cycles=r.cycles, execs=r.execs,
               hops=r.hops, total_cycles=eng.total_cycles)
    if dev.type == "cuda":
        out.update(_walls(r.cycles, dt, cfg.n_cells))
    if profile:
        out["profile"] = _profile(cfg, incs, r, dt, dev,
                                  pathlib.Path(profile_dir or PROFILE_DIR),
                                  scale)
    return out


PROFILE_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "profile"


def check_frames(r, n_edges: int) -> None:
    """Raise unless increment result ``r``'s final frame reconciles with
    its counters exactly: hops, execs, stalls (``TM_STALL + TM_PARK``),
    allocs, the increment's ``n_edges`` inserts (``TM_IO``), and no
    backlog or message in flight at quiescence."""
    t, cell = r.frames.totals(), r.frames.last()["cell"]
    got = dict(hops=int(cell[..., TM_HOP].sum()),
               execs=int(cell[..., TM_EXEC].sum()),
               stalls=int(cell[..., TM_STALL].sum()
                          + cell[..., TM_PARK].sum()),
               allocs=int(cell[..., TM_ALLOC].sum()),
               edges=int(cell[..., TM_IO].sum()))
    want = dict(hops=r.hops, execs=r.execs, stalls=r.stalls,
                allocs=r.allocs, edges=n_edges)
    totals = {k: t[k] for k in ("hops", "execs", "stalls", "allocs")}
    if got != want or totals != {k: want[k] for k in totals} or \
            (t["backlog"], t["in_flight"], t["quiescent"]) != (0, 0, True):
        raise AssertionError(f"final frame {got} {t} != counters {want}")


def telemetry_replay(rec: dict, max_cycles: int, pinned_spec: dict,
                     device=None):
    """One stream of ``data/telemetry_fingerprint.json`` through the port,
    recorded as ``tools/record_torch_fingerprint.py --telemetry`` records
    the JAX engine: each increment's counters and ``frame_record`` (its
    final frame reconciled by :func:`check_frames`), ``bench_engine``'s ci
    heatmap, and a livelock's increment, cycle, chunk, full text and frame
    log.  ``pinned_spec`` is the pinned stream's ``StreamSpec`` fields
    (``tests/data/pre_lanes_reference.json``).  Returns ``(record,
    engine)``."""
    from repro_torch.obs import congestion_heatmap
    from repro_torch.obs.frames import frame_record
    cfg = EngineConfig(**{k: v for k, v in rec["cfg"].items()
                          if k in EngineConfig.__dataclass_fields__})
    if rec["kind"] == "pinned":
        incs = make_stream(StreamSpec(**pinned_spec))
    elif rec["kind"] == "skew":
        incs = skew_increments(rec["args"][0])
    elif rec["kind"] == "engine":
        p = ENGINE_SCALES["ci"]
        incs = make_stream(StreamSpec(
            n_vertices=p["n_vertices"], n_edges=p["n_edges"], increments=2,
            sampling="edge", seed=3))
    else:   # the 8x8 hub stream of the JAX package's tests/test_obs.py
        e = hub_edges(128, 0, 200, seed=3)
        one = np.float32(1.0).view(np.int32)
        incs = [np.concatenate([e, np.full((len(e), 1), one, np.int64)],
                               1).astype(np.int32)]
    eng = StreamingEngine(cfg, "bfs", device=device)
    eng.seed(0, 0.0)
    out, rows = {}, []
    for i, e in enumerate(incs):
        try:
            r = eng.run_increment(e, max_cycles=max_cycles)
        except LivelockError as ex:
            out["livelock"] = dict(increment=i, cycle=ex.cycle,
                                   chunk=ex.chunk, message=str(ex),
                                   **frame_record(ex.frames))
            break
        check_frames(r, len(e))
        rows.append(dict(edges=len(e), cycles=r.cycles, hops=r.hops,
                         execs=r.execs, stalls=r.stalls, allocs=r.allocs,
                         **frame_record(r.frames)))
        if rec["kind"] == "engine" and i == 1:
            out["heatmap"] = congestion_heatmap(cfg, r.frames)
    out["increments"] = rows
    return json.loads(json.dumps(out)), eng


def _profile(cfg, incs, plain, plain_wall_s: float, dev, out_dir, scale):
    """``_profile_backend`` of the JAX package's benchmark: the timed
    increment again with ``telemetry=True``; its counters and cycles equal
    the plain run's and its final frame reconciles with them
    (``check_frames``); the frame count, ``engine_rates``, and the Chrome
    trace and congestion heatmap written to ``out_dir``; on the card the
    wall and its ratio to the plain run's."""
    from repro_torch.obs import (engine_rates, write_chrome_trace,
                                 write_heatmap)
    cfg = dataclasses.replace(cfg, telemetry=True)
    eng = StreamingEngine(cfg, "bfs", device=dev)
    eng.seed(0, 0.0)
    eng.run_increment(incs[0], max_cycles=MAX_CYCLES)
    _sync(dev)
    t0 = time.time()
    r = eng.run_increment(incs[1], max_cycles=MAX_CYCLES)
    _sync(dev)
    dt = time.time() - t0
    keys = ("cycles", "hops", "execs", "stalls", "allocs")
    if [getattr(r, k) for k in keys] != [getattr(plain, k) for k in keys]:
        raise AssertionError("telemetry changed the increment's counters")
    check_frames(r, len(incs[1]))
    out = dict(frames=len(r.frames), dropped=r.frames.dropped,
               rates=engine_rates(r.frames),
               trace=write_chrome_trace(out_dir / f"trace_{scale}.json",
                                        cfg, r.frames),
               heatmap=write_heatmap(out_dir / f"heatmap_{scale}.json",
                                     cfg, r.frames))
    if dev.type == "cuda":
        out.update(wall_s=dt, wall_vs_plain=dt / plain_wall_s)
    return out


# ------------------- faults, seals and repair (DESIGN §9) -------------------

def smoke_plan(chunk: int) -> FaultPlan:
    """``fault_smoke``'s plan: drop, duplicate and corrupt at 4, 2 and 2
    per cent, seed 7, and the row-0 link W out of cell (0, 1) dead for the
    first ``chunk`` cycles."""
    return FaultPlan(seed=7, drop_rate=0.04, dup_rate=0.02,
                     corrupt_rate=0.02, blackouts=((0, 1, 2, 0, chunk),))


def lost(eng: StreamingEngine) -> int:
    """Messages the last increment lost before its repair: the dropped and
    the corrupted (the repair pass ran where this is above 0)."""
    flt = eng.state.flt.tolist()
    return flt[FLT_DROP] + flt[FLT_CORRUPT]


def fault_smoke(scale="ci", device=None, out_dir=None) -> dict:
    """``benchmarks/resilience_smoke.py::fault_smoke``: ``bench_engine``'s
    grid and stream (seed 3, edge sampling) in three increments under
    ``smoke_plan`` with telemetry on; messages must be lost (``flt`` > 0)
    and the BFS values still equal the oracle's after the repair pass.
    The record has the JAX benchmark's fields (``wall_s`` on the card
    only, else None) and each increment's cycles, counters, ``flt``,
    frames and whether the repair ran; with ``out_dir`` it is also written
    to ``out_dir/fault_smoke_<scale>.json`` (nowhere else)."""
    dev = resolve_device(device)
    p = ENGINE_SCALES[scale]
    incs = make_stream(StreamSpec(n_vertices=p["n_vertices"],
                                  n_edges=p["n_edges"], increments=3,
                                  sampling="edge", seed=3))
    want = bfs_levels(p["n_vertices"], np.concatenate(incs), 0)
    eng = StreamingEngine(engine_config(scale, faults=smoke_plan(p["chunk"]),
                                        telemetry=True), "bfs", device=dev)
    eng.seed(0, 0.0)
    _sync(dev)
    t0 = time.time()
    rows, flt = [], np.zeros(4, np.int64)
    for e in incs:
        r = eng.run_increment(e, max_cycles=MAX_CYCLES)
        f = eng.state.flt.tolist()       # the counters reset each increment
        flt += f
        rows.append(dict(cycles=r.cycles, hops=r.hops, execs=r.execs,
                         stalls=r.stalls, allocs=r.allocs, flt=f,
                         frames=len(r.frames), repaired=lost(eng) > 0))
    _sync(dev)
    wall = time.time() - t0
    if flt[FLT_DROP] + flt[FLT_CORRUPT] == 0:
        raise AssertionError(f"the fault plan injected nothing: {flt}")
    np.testing.assert_array_equal(eng.values(p["n_vertices"]), want)
    rec = dict(status="exact-after-repair", scale=scale,
               cycles=sum(r["cycles"] for r in rows),
               wall_s=wall if dev.type == "cuda" else None,
               dropped=int(flt[0]), duplicated=int(flt[1]),
               corrupted=int(flt[2]), blackout_hits=int(flt[3]),
               increments=rows)
    if out_dir is not None:
        out = pathlib.Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        (out / f"fault_smoke_{scale}.json").write_text(
            json.dumps(rec, indent=1) + "\n")
    return rec


def hub_stream(n=256, degree=120, seed=3) -> np.ndarray:
    """The 8x8 hub stream of the JAX package's ``tests/test_resilience.py``:
    ``degree`` edges out of vertex 0 among ``n`` vertices, weight 1."""
    e = hub_edges(n, 0, degree, seed=seed)
    one = np.float32(1.0).view(np.int32)
    return np.concatenate([e, np.full((len(e), 1), one, np.int64)],
                          1).astype(np.int32)


def fault_replay(rec: dict, pinned_spec: dict, device=None):
    """One stream of ``data/fault_fingerprint.json`` through the port,
    recorded as ``tools/record_torch_fingerprint.py --faults`` records the
    JAX engine: each increment's counters, ``flt``, frame count and the
    digest of every leaf of the state it ends in (``obs.frames.
    state_digests``), and a livelock's increment, cycle, chunk and
    ``flt``.  ``rec["kind"]`` names the stream: ``"smoke"``
    (``fault_smoke``'s at ``rec["scale"]``), ``"hub"`` (``hub_stream`` cut
    at ``rec["splits"]``), ``"paper"`` (``run_stream``'s ten increments at
    ``rec["size"]``, vertices and edges) or ``"pinned"`` (``pinned_spec``,
    the pinned stream's ``StreamSpec`` fields).  Returns ``(record,
    engine)``."""
    from repro_torch.core.state import state_to_numpy
    from repro_torch.obs.frames import state_digests
    plan = rec["plan"]
    cfg = EngineConfig(**dict(
        {k: v for k, v in rec["cfg"].items()
         if k in EngineConfig.__dataclass_fields__ and k != "faults"},
        faults=FaultPlan(**dict(plan, blackouts=tuple(
            tuple(b) for b in plan["blackouts"])))))
    if rec["kind"] == "smoke":
        p = ENGINE_SCALES[rec["scale"]]
        incs = make_stream(StreamSpec(n_vertices=p["n_vertices"],
                                      n_edges=p["n_edges"], increments=3,
                                      sampling="edge", seed=3))
    elif rec["kind"] == "hub":
        e = hub_stream()
        incs = [e[lo:hi] for lo, hi in rec["splits"]]
    elif rec["kind"] == "paper":
        n, m = rec["size"]
        incs = stream_increments("edge", dict(n_vertices=n, n_edges=m))
    else:
        incs = make_stream(StreamSpec(**pinned_spec))
    eng = StreamingEngine(cfg, "bfs", device=device)
    eng.seed(0, 0.0)
    rows, out = [], {}
    for i, e in enumerate(incs):
        try:
            r = eng.run_increment(e, max_cycles=MAX_CYCLES)
        except LivelockError as ex:
            out["livelock"] = dict(increment=i, cycle=ex.cycle,
                                   chunk=ex.chunk, flt=eng.state.flt.tolist())
            break
        rows.append(dict(cycles=r.cycles, hops=r.hops, execs=r.execs,
                         stalls=r.stalls, allocs=r.allocs,
                         flt=eng.state.flt.tolist(),
                         frames=len(r.frames) if r.frames else 0,
                         state=state_digests(state_to_numpy(eng.state))))
    out["increments"] = rows
    return out, eng


# ------------------- durable state and recovery (DESIGN §9) -------------------

def same_state(a, b) -> str | None:
    """The first leaf in which states ``a`` and ``b`` differ (float leaves
    compared as bits), or None."""
    for name in a._fields:
        x, y = getattr(a, name), getattr(b, name)
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        if x.shape != y.shape or not torch.equal(x, y.to(x.device)):
            return name
    return None


def kill_resume_smoke(scale="ci", device=None, out_dir=None) -> dict:
    """``benchmarks/resilience_smoke.py::kill_resume_smoke``: ``fault_smoke``'s
    grid and stream (seed 3, three increments) without faults, run once
    uninterrupted and once with an async checkpoint before each of the
    first two increments and a blocking one after them; that engine is
    dropped (the "kill"), a new one restored from the checkpoint replays
    the last increment, and every leaf must equal the uninterrupted run's,
    as must the totals and BFS the oracle's.  Checkpoints go under
    ``out_dir`` (default: a temporary directory), removed at the end."""
    from repro_torch.core.state import state_to_numpy
    from repro_torch.obs.frames import state_digests
    from repro_torch.train import Checkpointer
    dev = resolve_device(device)
    p = ENGINE_SCALES[scale]
    incs = make_stream(StreamSpec(n_vertices=p["n_vertices"],
                                  n_edges=p["n_edges"], increments=3,
                                  sampling="edge", seed=3))
    want = bfs_levels(p["n_vertices"], np.concatenate(incs), 0)
    cfg = engine_config(scale)
    ref = StreamingEngine(cfg, "bfs", device=dev)
    ref.seed(0, 0.0)
    for e in incs:
        ref.run_increment(e, max_cycles=MAX_CYCLES)
    with tempfile.TemporaryDirectory(dir=out_dir) as d:
        eng = StreamingEngine(cfg, "bfs", device=dev)
        eng.seed(0, 0.0)
        ck = Checkpointer(d)
        for e in incs[:2]:
            eng.run_increment(e, ckpt=ck, max_cycles=MAX_CYCLES)
        eng.checkpoint(ck)
        del eng                                       # the "kill"
        res = StreamingEngine.restore(cfg, "bfs", Checkpointer(d),
                                      device=dev)
        resumed_at = res.stream_pos
        res.run_increment(incs[2], max_cycles=MAX_CYCLES)
    bad = same_state(res.state, ref.state)
    if bad or (res.totals, res.total_cycles) != (ref.totals,
                                                 ref.total_cycles):
        raise AssertionError(f"kill-and-resume diverged (leaf {bad}, totals "
                             f"{res.totals} / {ref.totals})")
    np.testing.assert_array_equal(res.values(p["n_vertices"]), want)
    return dict(status="bit-exact", scale=scale, resumed_at=resumed_at,
                totals=dict(res.totals), total_cycles=res.total_cycles,
                state=state_digests(state_to_numpy(res.state)))


def wedge_config(**kw) -> EngineConfig:
    """The lanes=1 hub wedge of the JAX package's
    ``benchmarks/resilience_smoke.py::recovery_smoke`` (and
    ``tests/test_resilience.py::_wedge_cfg``), with ``kw`` on top."""
    return EngineConfig(**dict(dict(
        height=8, width=8, n_vertices=128, edge_cap=4, ghost_slots=48,
        queue_cap=20, chan_cap=16, futq_cap=4, chunk=64, lanes=1,
        max_cycles=200_000, telemetry=True), **kw))


def recovery_smoke(device=None) -> dict:
    """``benchmarks/resilience_smoke.py::recovery_smoke``: the degree-200
    hub stream on ``wedge_config`` wedges at lanes=1 and completes under
    ``RecoveryPolicy(max_attempts=2)`` at lanes=2, BFS equal to the
    oracle, one attempt logged with the flight recorder's report naming
    the wedged cells.  The record has the JAX benchmark's fields, the log
    and the increment's counters and final leaf digests."""
    from repro_torch.core.state import state_to_numpy
    from repro_torch.obs.frames import state_digests
    from repro_torch.resilience import RecoveryPolicy
    dev = resolve_device(device)
    edges = hub_stream(128, 200)
    eng = StreamingEngine(wedge_config(), "bfs", device=dev)
    eng.seed(0, 0.0)
    r = eng.run_increment(edges, recover=RecoveryPolicy(max_attempts=2))
    np.testing.assert_array_equal(eng.values(),
                                  bfs_levels(128, edges[:, :2], 0))
    log = eng.recovery_log
    if eng.cfg.lanes != 2 or len(log) != 1 or \
            "wedged cell" not in log[0]["wedge"]:
        raise AssertionError(f"recovery: lanes {eng.cfg.lanes}, log {log}")
    return dict(status="recovered", escalated_lanes=eng.cfg.lanes,
                attempts=len(log), wedge_cycle=log[0]["cycle"], log=log,
                cycles=r.cycles, hops=r.hops, execs=r.execs,
                stalls=r.stalls, allocs=r.allocs,
                state=state_digests(state_to_numpy(eng.state)))


def profile_resilience(scale="ci", device=None,
                       cadences=(0, 1, 2, 2, 1, 0), ckpt_dir=None) -> dict:
    """``benchmarks/resilience_smoke.py::profile_resilience``'s checkpoint
    cadence sweep: a stream whose first increment is run untimed, then the
    rest timed with an async checkpoint before every ``n``-th increment
    (``n = 0``: none), one fresh engine a run of ``cadences``, in that
    order (by default in turns); the wall is taken after ``ckpt.wait()``.
    ``scale`` ``ci`` or ``mid``: the JAX benchmark's ``bench_engine``
    stream (seed 3, four increments) on its grid; ``paper``: the paper
    experiments' 50K / 1M stream (ten increments) on ``_engine``'s 32x32
    config.  Each run records its wall and each save's bytes, host
    snapshot and (writer-thread) write seconds; checkpoints go under
    ``ckpt_dir`` (default: a temporary directory), removed after each
    run.  Walls are reported on the card only."""
    from repro_torch.train import Checkpointer
    dev = resolve_device(device)
    if scale in ENGINE_SCALES:
        p = ENGINE_SCALES[scale]
        incs = make_stream(StreamSpec(n_vertices=p["n_vertices"],
                                      n_edges=p["n_edges"], increments=4,
                                      sampling="edge", seed=3))
        cfg = engine_config(scale)
    else:
        incs = stream_increments("edge", scale)
        cfg = experiment_config(**_scale(scale))
    runs = []
    for every in cadences:
        eng = StreamingEngine(cfg, "bfs", device=dev)
        eng.seed(0, 0.0)
        eng.run_increment(incs[0], max_cycles=MAX_CYCLES)
        saves = []
        with tempfile.TemporaryDirectory(dir=ckpt_dir) as d:
            ck = Checkpointer(d)
            _sync(dev)
            t0 = time.time()
            for i, e in enumerate(incs[1:]):
                use = every and i % every == 0
                if use and ck.last:
                    ck.wait()
                    saves.append(dict(ck.last))
                eng.run_increment(e, max_cycles=MAX_CYCLES,
                                  ckpt=ck if use else None)
            ck.wait()
            _sync(dev)
            wall = time.time() - t0
            if ck.last:
                saves.append(dict(ck.last))
        runs.append(dict(every=every, wall_s=wall if dev.type == "cuda"
                         else None, total_cycles=eng.total_cycles,
                         saves=saves))
        del eng
    if len({r["total_cycles"] for r in runs}) != 1:
        raise AssertionError(f"the cadences changed the stream's cycles: "
                             f"{[r['total_cycles'] for r in runs]}")
    return dict(scale=scale, increments=len(incs) - 1, runs=runs)

def guard_budgets(eng: StreamingEngine) -> list:
    """Hook ``eng``'s ingest guard: the returned list collects every
    budget ``_update_ingest_budget`` sets, in order."""
    traj, update = [], eng._update_ingest_budget

    def hooked():
        update()
        traj.append(eng._ingest_budget)

    eng._update_ingest_budget = hooked
    return traj


def resilience_replay(rec: dict, device=None) -> dict:
    """One stream of ``data/resilience_fingerprint.json`` through the
    port, recorded as ``tools/record_torch_fingerprint.py --resilience``
    records the JAX engine, by ``rec["kind"]``: ``"kill_resume"``
    (``kill_resume_smoke`` at ``rec["scale"]``), ``"recovery"``
    (``recovery_smoke``), ``"guard"`` (the hub stream under the guard,
    cut at ``rec["splits"]``, through the device loop and the traced
    loop: every budget the guard sets, counters and final leaf digests)
    or ``"paper_recover"`` (the paper experiments' 32x32 config at
    ``rec["size"]`` under ``rec["plan"]`` with ``RecoveryPolicy(
    **rec["policy"])``: each increment's counters, lanes, failed attempts
    and digests, and where the budget runs out the increment, cycle,
    chunk, message, attempts and digests).  Returns the record's
    measured fields; the caller compares them with ``rec``'s."""
    from repro_torch.core.state import state_to_numpy
    from repro_torch.obs.frames import state_digests
    from repro_torch.resilience import RecoveryPolicy

    def digests(eng):
        return state_digests(state_to_numpy(eng.state))

    def config(**kw):
        return EngineConfig(**{k: v for k, v in dict(rec["cfg"], **kw)
                               .items()
                               if k in EngineConfig.__dataclass_fields__})

    kind = rec["kind"]
    if kind == "kill_resume":
        got = kill_resume_smoke(rec["scale"], device)
        return {k: got[k] for k in ("resumed_at", "totals", "total_cycles",
                                    "state")}
    if kind == "recovery":
        got = recovery_smoke(device)
        eng_keys = ("log", "cycles", "hops", "execs", "stalls", "allocs",
                    "state")
        return dict({k: got[k] for k in eng_keys},
                    lanes=got["escalated_lanes"],
                    totals={k: got[k] for k in ("hops", "execs", "stalls",
                                                "allocs")},
                    total_cycles=got["cycles"])
    if kind == "guard":
        e = hub_stream()
        drivers = {}
        for name in ("device", "traced"):
            eng = StreamingEngine(config(), "bfs", device=device)
            eng.seed(0, 0.0)
            traj, rows = guard_budgets(eng), []
            for lo, hi in rec["splits"]:
                before = eng._ingest_budget
                r = eng.run_increment(e[lo:hi],
                                      collect_traces=name == "traced")
                rows.append(dict(budget_before=before,
                                 budget_after=eng._ingest_budget,
                                 budgets=list(traj), cycles=r.cycles,
                                 hops=r.hops, execs=r.execs,
                                 stalls=r.stalls, allocs=r.allocs,
                                 state=digests(eng)))
                traj.clear()
            drivers[name] = rows
        return dict(drivers=drivers)
    plan = rec["plan"]
    cfg = config(faults=FaultPlan(**dict(plan, blackouts=tuple(
        tuple(b) for b in plan["blackouts"]))))
    n, m = rec["size"]
    incs = stream_increments("edge", dict(n_vertices=n, n_edges=m))
    eng = StreamingEngine(cfg, "bfs", device=device)
    eng.seed(0, 0.0)
    rows, out = [], {}
    for i, e in enumerate(incs):
        log0 = len(eng.recovery_log)
        try:
            r = eng.run_increment(e, max_cycles=MAX_CYCLES,
                                  recover=RecoveryPolicy(**rec["policy"]))
        except LivelockError as ex:
            out["exhausted"] = dict(
                increment=i, cycle=ex.cycle, chunk=ex.chunk,
                message=str(ex), log=eng.recovery_log[log0:],
                state=digests(eng))
            break
        rows.append(dict(cycles=r.cycles, hops=r.hops, execs=r.execs,
                         stalls=r.stalls, allocs=r.allocs,
                         flt=eng.state.flt.tolist(), lanes=eng.cfg.lanes,
                         queue_cap=eng.cfg.queue_cap,
                         log=eng.recovery_log[log0:], state=digests(eng)))
    out.update(increments=rows,
               outcome="exhausted" if "exhausted" in out else "recovered")
    return json.loads(json.dumps(out))

BENCHES = {
    "increments": lambda s, d: {
        sampling: bench_cycles_per_increment(s, sampling, d)[0]
        for sampling in ("edge", "snowball")},
    "energy": bench_energy,
    "allocator": bench_allocator,
    "activation": bench_activation,
    "skew": lambda s, d: bench_skew(s, device=d),
    "lanes": lambda s, d: dict(zip(("rows", "oversize_baseline"),
                                   bench_lanes(s, device=d))),
    "throughput": bench_engine_throughput,
    "engine": lambda s, d: [bench_engine(e, d) for e in ENGINE_SCALES],
}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", choices=sorted(SCALES), default="ci")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--only", choices=sorted(BENCHES), action="append",
                    help="run only these benchmarks (repeatable)")
    ap.add_argument("--profile", action="store_true",
                    help="engine: also run with telemetry and write its "
                         "trace and heatmap under build/profile/")
    ap.add_argument("--faults", action="store_true",
                    help="run only the fault smokes, at the engine grids "
                         "ci and mid")
    ap.add_argument("--resilience", action="store_true",
                    help="run only the durable-state and recovery smokes: "
                         "kill-and-resume at the engine grids ci and mid, "
                         "the recovery smoke, and the checkpoint cadence "
                         "sweep at --scale (ci, mid: the engine grids; "
                         "paper: the 50K / 1M stream)")
    ap.add_argument("--out", default=None,
                    help="--faults: write each smoke's record under this "
                         "directory; --resilience: write the checkpoints "
                         "there (in temporary directories, removed after)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.out is not None:
        pathlib.Path(args.out).mkdir(parents=True, exist_ok=True)
    if args.resilience:
        runs = [("kill_resume_smoke", scale, functools.partial(
            kill_resume_smoke, scale, dev, args.out))
            for scale in ENGINE_SCALES]
        runs += [("recovery_smoke", "ci", functools.partial(
            recovery_smoke, dev)),
            ("profile_resilience", args.scale, functools.partial(
                profile_resilience, args.scale, dev, ckpt_dir=args.out))]
        for name, scale, fn in runs:
            t0 = time.time()
            rec = fn()
            rec.pop("state", None)
            out = {"bench": name, "scale": scale, "rows": rec}
            if dev.type == "cuda":
                out["seconds"] = time.time() - t0
            print(json.dumps(out), flush=True)
        return
    if args.faults:
        for scale in ENGINE_SCALES:
            t0 = time.time()
            out = {"bench": "fault_smoke", "scale": scale,
                   "rows": fault_smoke(scale, dev, args.out)}
            if dev.type == "cuda":
                out["seconds"] = time.time() - t0
            print(json.dumps(out), flush=True)
        return
    benches = dict(BENCHES)
    if args.profile:
        benches["engine"] = lambda s, d: [bench_engine(e, d, profile=True)
                                          for e in ENGINE_SCALES]
    for name in args.only or benches:
        t0 = time.time()
        out = {"bench": name, "scale": args.scale,
               "rows": benches[name](args.scale, dev)}
        if dev.type == "cuda":
            out["seconds"] = time.time() - t0
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
