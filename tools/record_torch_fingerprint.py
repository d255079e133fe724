"""Record the fingerprints that the PyTorch port is held to.

Default mode: runs the JAX engine (``repro``) on the default stream of
``examples/streaming_bfs.py`` -- 2000 vertices, 20k SBM edges, edge
sampling, seed 1, ten increments, on a 32x32 chip -- and writes the
per-increment counters and the final BFS values to
``src/repro_torch/data/fingerprint_32x32.json``.

``--paper-ci``: runs the paper experiments' streams at ``SCALES["ci"]``
(``benchmarks/paper_experiments.py``: 2000 vertices, 20k edges, ten
increments, seed 1, ``_engine``'s 32x32 config) through the JAX engine,
one process a stream, all started together: (ingest_only, edge) and
(bfs, edge) with per-cycle traces, (ingest_only, snowball), (bfs,
snowball) and (bfs, edge) under the random allocator without.  Writes
each stream's per-increment counters, final values and
``vertex_object_stats``, and the two traced streams' ``active`` and
``in_flight`` per cycle, to ``src/repro_torch/data/paper_ci_fingerprint.json``.

``--skew``: runs the skew and lanes experiments' streams
(``benchmarks/paper_experiments.py::bench_skew`` and ``bench_lanes``: an
R-MAT stream, four increments, seed 2, at ``SKEW_SCALES`` ci, mid and
paper) through the JAX engine, one process a config, all started
together: the configs ``(queue_cap, lanes, rhizome_cap)`` (48, 2, 1),
(48, 2, 2), (48, 2, 4), (48, 1, 1), (48, 4, 1) and (192, 1, 1) at ci and
mid, and ``bench_skew``'s three, (48, 2, 4), (48, 2, 2) and (48, 2, 1),
at paper (``bench_skew``'s R = 1 row and ``bench_lanes``' lanes = 2 row
are the same config).  Writes
each config's per-increment counters and, where it finishes, its final
values and ``vertex_object_stats``; where it livelocks, the increment and
the cycle at which ``LivelockError`` fires and the counters up to there,
to ``src/repro_torch/data/skew_fingerprint.json``.

``--telemetry``: runs the JAX engine with ``telemetry=True`` (the
sync-free device loop) on the pinned 8x8 stream
(``tests/data/pre_lanes_reference.json``, ``frame_ring=16``), the six ci
configs of ``--skew`` and ``bench_engine``'s ci stream
(``benchmarks/engine_throughput.py``: 8x8, 256 vertices, 2,048 edges, seed
3), one process a stream, all started together.  Writes each increment's
counters, frame count, ``dropped``, ``FrameLog.totals()`` and the final
frame's planes, each as its shape and a digest (``plane_digest``), and
for ``bench_engine``'s second increment its ``congestion_heatmap``; for
the livelocks (the ci lanes=1 config, the 8x8 hub stream of
``tests/test_obs.py`` at ``frame_ring=16`` and ``bench_skew``'s
rhizome_cap=4 row at paper scale) the increment, cycle and chunk of the
error and its full text, the flight recorder's wedge report included, to
``src/repro_torch/data/telemetry_fingerprint.json``.

``--faults``: runs the JAX engine with ``telemetry=True`` under fault
plans (DESIGN §9), one process a stream, all started together: the fault
smoke (``benchmarks/resilience_smoke.py::fault_smoke``'s plan and stream,
the jnp backend only) at the engine grids ci and mid, the 8x8 hub stream of
``tests/test_resilience.py`` under a zero-rate plan and its four plans
(drop, dup and corrupt; two blackouts; dups only; drop and corrupt over
three increments), the
pinned 8x8 stream at lanes=1 under drop and corrupt, and the paper
experiments' 32x32 config (``benchmarks/paper_experiments.py::_engine``)
at 20,000 vertices and 400,000 edges (ten edge-sampled increments, seed 1)
under the paper plan of ``chip_smoke.py`` (the fault smoke's with a
512-cycle blackout), whose repair pass livelocks.  Writes each
increment's counters, ``flt``, frame count (telemetry on; the 32x32 row
runs without it) and the digest of every leaf of the state it ends in
(``obs.frames.state_digests``), and a livelock's increment, cycle, chunk
and ``flt``, to ``src/repro_torch/data/fault_fingerprint.json``.

``chip_smoke.py`` and the port's tests replay these files.  Outside the
tests, this is the only file of the port's tooling that imports JAX: it
runs ``repro`` (and the JAX package's ``benchmarks``), and takes from
``repro_torch`` only ``obs.frames.frame_record`` and ``state_digests``,
the one definition of how a frame log and a state are fingerprinted,
which the replays use too.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/record_torch_fingerprint.py
    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/record_torch_fingerprint.py --paper-ci
    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/record_torch_fingerprint.py --skew
    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/record_torch_fingerprint.py --telemetry
    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/record_torch_fingerprint.py --faults
"""
import argparse
import concurrent.futures
import dataclasses
import json
import multiprocessing
import pathlib
import subprocess
import sys
import time

import numpy as np

from repro.core import EngineConfig, StreamingEngine
from repro.graph.streams import StreamSpec, make_stream

ROOT = pathlib.Path(__file__).resolve().parents[1]
DATA = ROOT / "src" / "repro_torch" / "data"
OUT = DATA / "fingerprint_32x32.json"
PAPER_OUT = DATA / "paper_ci_fingerprint.json"
SKEW_OUT = DATA / "skew_fingerprint.json"
TELEMETRY_OUT = DATA / "telemetry_fingerprint.json"
FAULTS_OUT = DATA / "fault_fingerprint.json"
COMMAND = "PYTHONPATH=src JAX_PLATFORMS=cpu python tools/record_torch_fingerprint.py"
MAX_CYCLES = 2_000_000
# (app, sampling, allocator, per-cycle traces) of the --paper-ci streams
PAPER_STREAMS = (("ingest_only", "edge", "vicinity", True),
                 ("bfs", "edge", "vicinity", True),
                 ("ingest_only", "snowball", "vicinity", False),
                 ("bfs", "snowball", "vicinity", False),
                 ("bfs", "edge", "random", False))
# (queue_cap, lanes, rhizome_cap) of the --skew configs, and the rows of
# bench_skew / bench_lanes each one is
SKEW_CONFIGS = (((48, 2, 1), ("skew R=1", "lanes L=2")),
                ((48, 2, 2), ("skew R=2",)),
                ((48, 2, 4), ("skew R=4",)),
                ((48, 1, 1), ("lanes L=1",)),
                ((48, 4, 1), ("lanes L=4",)),
                ((192, 1, 1), ("lanes oversize baseline",)))
SKEW_MAX_CYCLES = 4_000_000


def _commit() -> str:
    return subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT,
                          capture_output=True, text=True).stdout.strip()


def main_32x32() -> None:
    n = 2000
    spec = StreamSpec(n_vertices=n, n_edges=20_000, increments=10,
                      sampling="edge", seed=1, kind="sbm")
    # the config examples/streaming_bfs.py builds for its defaults
    cfg = EngineConfig(height=32, width=32, n_vertices=n, edge_cap=8,
                       ghost_slots=max(32, 3 * n // 1024),
                       io_stream_cap=2 ** 20, chunk=512)
    incs = make_stream(spec)
    eng = StreamingEngine(cfg, "bfs")
    eng.seed(0, 0.0)
    rows = []
    for i, e in enumerate(incs):
        r = eng.run_increment(e, max_cycles=MAX_CYCLES)
        rows.append(dict(edges=len(e), cycles=r.cycles, hops=r.hops,
                         execs=r.execs, stalls=r.stalls, allocs=r.allocs))
        print(f"increment {i}: {rows[-1]}", flush=True)
    out = dict(command=COMMAND, commit=_commit(),
               engine="repro (JAX, jnp backend)",
               spec=dataclasses.asdict(spec),
               cfg=dataclasses.asdict(cfg),
               max_cycles=MAX_CYCLES, source=0,
               increments=rows, total_cycles=eng.total_cycles,
               values=[float(v) for v in eng.values(n)])
    OUT.write_text(json.dumps(out, indent=1) + "\n")
    print(f"wrote {OUT}")


def paper_stream(app: str, sampling: str, allocator: str,
                 traced: bool) -> dict:
    """One stream of ``benchmarks/paper_experiments.py::run_stream`` at
    ci scale, with its traces when ``traced``."""
    sys.path.insert(0, str(ROOT))
    from benchmarks.paper_experiments import SCALES, _engine
    t0 = time.time()
    spec = StreamSpec(increments=10, sampling=sampling, seed=1,
                      **SCALES["ci"])
    incs = make_stream(spec)
    eng = _engine(spec.n_vertices, app, allocator, n_edges=spec.n_edges)
    rows, active, in_flight = [], [], []
    for e in incs:
        r = eng.run_increment(e, max_cycles=MAX_CYCLES,
                              collect_traces=traced)
        rows.append(dict(edges=len(e), cycles=r.cycles, hops=r.hops,
                         execs=r.execs, stalls=r.stalls, allocs=r.allocs))
        if traced:
            assert len(r.active_per_cycle) == r.cycles
            active += np.asarray(r.active_per_cycle).tolist()
            in_flight += np.asarray(r.in_flight_per_cycle).tolist()
    out = dict(app=app, sampling=sampling, allocator=allocator,
               traced=traced, cfg=dataclasses.asdict(eng.cfg),
               increments=rows, total_cycles=eng.total_cycles,
               values=[float(v) for v in eng.values(spec.n_vertices)],
               vertex_object_stats=eng.vertex_object_stats())
    if traced:
        out.update(active_per_cycle=active, in_flight_per_cycle=in_flight)
    print(f"{app} {sampling} {allocator} traced={traced}: "
          f"{eng.total_cycles} cycles in {time.time() - t0:.1f}s",
          flush=True)
    return out


def main_paper_ci() -> None:
    sys.path.insert(0, str(ROOT))
    from benchmarks.paper_experiments import SCALES
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(
            len(PAPER_STREAMS), mp_context=ctx) as pool:
        runs = list(pool.map(paper_stream, *zip(*PAPER_STREAMS)))
    # one line for each per-cycle trace and value list: the file stays
    # small and readable
    lines = {}
    for i, r in enumerate(runs):
        for key in ("values", "active_per_cycle", "in_flight_per_cycle"):
            if key in r:
                lines[f"@{i}{key}@"] = json.dumps(r[key])
                r[key] = f"@{i}{key}@"
    out = dict(command=COMMAND + " --paper-ci", commit=_commit(),
               engine="repro (JAX, jnp backend)",
               spec=dataclasses.asdict(StreamSpec(
                   increments=10, seed=1, **SCALES["ci"])),
               max_cycles=MAX_CYCLES, source=0, streams=runs)
    text = json.dumps(out, indent=1)
    for mark, line in lines.items():
        text = text.replace(f'"{mark}"', line)
    PAPER_OUT.write_text(text + "\n")
    print(f"wrote {PAPER_OUT}")


def skew_config(scale: str, queue_cap: int, lanes: int,
                rhizome_cap: int) -> dict:
    """One config of ``bench_skew`` / ``bench_lanes`` at ``scale``, run
    to its end or its livelock."""
    sys.path.insert(0, str(ROOT))
    from benchmarks.paper_experiments import SKEW_SCALES
    from repro.core.engine import LivelockError
    t0 = time.time()
    p = SKEW_SCALES[scale]
    spec = StreamSpec(n_vertices=p["n_vertices"], n_edges=p["n_edges"],
                      increments=4, kind="rmat", seed=2)
    incs = make_stream(spec)
    # the config both benchmarks build
    cfg = EngineConfig(
        height=p["height"], width=p["width"], n_vertices=p["n_vertices"],
        edge_cap=8, ghost_slots=max(64, 4 * p["n_edges"]
                                    // (8 * p["height"] * p["width"])),
        queue_cap=queue_cap, chan_cap=32, futq_cap=8,
        io_stream_cap=2 ** 20, chunk=512, rhizome_cap=rhizome_cap,
        lanes=lanes)
    eng = StreamingEngine(cfg, "bfs")
    eng.seed(0, 0.0)
    rows, livelock = [], None
    for i, e in enumerate(incs):
        try:
            r = eng.run_increment(e, max_cycles=SKEW_MAX_CYCLES)
        except LivelockError as ex:
            st = eng.state
            livelock = dict(increment=i, cycle=ex.cycle, chunk=ex.chunk,
                            hops=int(st.stat_hops), execs=int(st.stat_exec),
                            stalls=int(st.stat_stall),
                            allocs=int(st.stat_allocs))
            break
        rows.append(dict(edges=len(e), cycles=r.cycles, hops=r.hops,
                         execs=r.execs, stalls=r.stalls, allocs=r.allocs))
    out = dict(scale=scale, queue_cap=queue_cap, lanes=lanes,
               rhizome_cap=rhizome_cap,
               status="livelock" if livelock else "ok",
               cfg=dataclasses.asdict(cfg), increments=rows)
    if livelock:
        out["livelock"] = livelock
    else:
        out.update(values=[float(v) for v in eng.values(p["n_vertices"])],
                   vertex_object_stats=eng.vertex_object_stats())
    print(f"{scale} q={queue_cap} L={lanes} R={rhizome_cap}: "
          f"{out['status']} {[r['cycles'] for r in rows]} {livelock} in "
          f"{time.time() - t0:.1f}s", flush=True)
    return out


def main_skew() -> None:
    sys.path.insert(0, str(ROOT))
    from benchmarks.paper_experiments import SKEW_SCALES
    jobs = [("paper", 48, 2, R) for R in (4, 2, 1)] + [
        (scale, *c) for scale in ("mid", "ci") for c, _ in SKEW_CONFIGS]
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(
            min(len(jobs), 6), mp_context=ctx) as pool:
        runs = list(pool.map(skew_config, *zip(*jobs)))
    names = dict(SKEW_CONFIGS)
    lines = {}
    for i, r in enumerate(runs):
        r["rows"] = list(names[(r["queue_cap"], r["lanes"],
                                r["rhizome_cap"])])
        if "values" in r:
            lines[f"@{i}values@"] = json.dumps(r["values"])
            r["values"] = f"@{i}values@"
    out = dict(command=COMMAND + " --skew", commit=_commit(),
               engine="repro (JAX, jnp backend)",
               scales={s: SKEW_SCALES[s] for s in ("ci", "mid", "paper")},
               spec=dict(increments=4, kind="rmat", seed=2),
               max_cycles=SKEW_MAX_CYCLES, source=0, configs=runs)
    text = json.dumps(out, indent=1)
    for mark, line in lines.items():
        text = text.replace(f'"{mark}"', line)
    SKEW_OUT.write_text(text + "\n")
    print(f"wrote {SKEW_OUT}")


# the --telemetry streams: (name, kind, arguments)
TELEMETRY_STREAMS = (
    ("pinned 8x8", "pinned", ()),
    *((f"ci q=%d lanes=%d R=%d" % c, "skew", ("ci",) + c)
      for c, _ in SKEW_CONFIGS),
    ("engine_ci", "engine", ()),
    ("hub 8x8 lanes=1", "hub", ()),
    ("paper q=48 lanes=2 R=4", "skew", ("paper", 48, 2, 4)))


def telemetry_stream(name: str, kind: str, args: tuple) -> dict:
    """One --telemetry stream through the JAX engine with telemetry on."""
    sys.path.insert(0, str(ROOT))
    from repro.core.engine import LivelockError
    from repro.graph.streams import hub_edges
    from repro.obs import congestion_heatmap
    from repro_torch.obs.frames import frame_record
    t0 = time.time()
    if kind == "pinned":
        ref = json.loads((ROOT / "tests" / "data"
                          / "pre_lanes_reference.json").read_text())
        cfg = EngineConfig(**ref["cfg"], telemetry=True, frame_ring=16)
        incs = make_stream(StreamSpec(**ref["spec"]))
    elif kind == "skew":
        from benchmarks.paper_experiments import SKEW_SCALES
        scale, queue_cap, lanes, rhizome_cap = args
        p = SKEW_SCALES[scale]
        incs = make_stream(StreamSpec(
            n_vertices=p["n_vertices"], n_edges=p["n_edges"], increments=4,
            kind="rmat", seed=2))
        cfg = EngineConfig(
            height=p["height"], width=p["width"],
            n_vertices=p["n_vertices"], edge_cap=8,
            ghost_slots=max(64, 4 * p["n_edges"]
                            // (8 * p["height"] * p["width"])),
            queue_cap=queue_cap, chan_cap=32, futq_cap=8,
            io_stream_cap=2 ** 20, chunk=512, rhizome_cap=rhizome_cap,
            lanes=lanes, telemetry=True)
    elif kind == "engine":
        from benchmarks.engine_throughput import ENGINE_SCALES, _cfg
        p = ENGINE_SCALES["ci"]
        incs = make_stream(StreamSpec(
            n_vertices=p["n_vertices"], n_edges=p["n_edges"], increments=2,
            sampling="edge", seed=3))
        cfg = _cfg(p, "jnp", telemetry=True)
    else:   # the 8x8 hub stream of tests/test_obs.py
        cfg = EngineConfig(height=8, width=8, n_vertices=128, edge_cap=4,
                           ghost_slots=48, queue_cap=20, chan_cap=16,
                           futq_cap=4, io_stream_cap=2048, chunk=64,
                           lanes=1, telemetry=True, frame_ring=16)
        e = hub_edges(128, 0, 200, seed=3)
        one = np.float32(1.0).view(np.int32)
        incs = [np.concatenate([e, np.full((len(e), 1), one, np.int64)],
                               1).astype(np.int32)]
    eng = StreamingEngine(cfg, "bfs")
    eng.seed(0, 0.0)
    rows, out = [], dict(name=name, kind=kind, args=list(args),
                         cfg={k: v for k, v in dataclasses.asdict(cfg).items()
                              if k != "faults"})
    for i, e in enumerate(incs):
        try:
            r = eng.run_increment(e, max_cycles=SKEW_MAX_CYCLES)
        except LivelockError as ex:
            out["livelock"] = dict(increment=i, cycle=ex.cycle,
                                   chunk=ex.chunk, message=str(ex),
                                   **frame_record(ex.frames))
            break
        rows.append(dict(edges=len(e), cycles=r.cycles, hops=r.hops,
                         execs=r.execs, stalls=r.stalls, allocs=r.allocs,
                         **frame_record(r.frames)))
        if kind == "engine" and i == 1:
            out["heatmap"] = congestion_heatmap(cfg, r.frames)
    out["increments"] = rows
    print(f"{name}: {[r['cycles'] for r in rows]} "
          f"{out.get('livelock', {}).get('cycle')} in "
          f"{time.time() - t0:.1f}s", flush=True)
    return out


def main_telemetry() -> None:
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(
            6, mp_context=ctx) as pool:
        runs = list(pool.map(telemetry_stream, *zip(*TELEMETRY_STREAMS)))
    out = dict(command=COMMAND + " --telemetry", commit=_commit(),
               engine="repro (JAX, jnp backend, telemetry=True)",
               digest="first 16 hex digits of the sha256 of the plane's "
                      "int32 bytes, little-endian, C order",
               max_cycles=SKEW_MAX_CYCLES, source=0, streams=runs)
    TELEMETRY_OUT.write_text(json.dumps(out, indent=1) + "\n")
    print(f"wrote {TELEMETRY_OUT}")


# the --faults streams: (name, kind, scale or the hub's increments, plan)
FAULT_HUB_SPLITS = ((0, None),)
FAULT_STREAMS = (
    ("fault_smoke ci", "smoke", "ci", None),
    ("fault_smoke mid", "smoke", "mid", None),
    ("hub zero-rate", "hub", FAULT_HUB_SPLITS, dict(seed=7)),
    ("hub drop/dup/corrupt", "hub", FAULT_HUB_SPLITS,
     dict(seed=7, drop_rate=0.05, dup_rate=0.03, corrupt_rate=0.02)),
    ("hub blackouts", "hub", FAULT_HUB_SPLITS,
     dict(seed=7, blackouts=((0, 1, 2, 0, 64), (0, 2, 2, 0, 64)))),
    ("hub dups", "hub", FAULT_HUB_SPLITS, dict(seed=11, dup_rate=0.08)),
    ("hub drop/corrupt, three increments", "hub",
     ((0, 150), (150, 300), (300, None)),
     dict(seed=3, drop_rate=0.04, corrupt_rate=0.02)),
    ("pinned lanes=1 drop/corrupt", "pinned", None,
     dict(seed=5, drop_rate=0.05, corrupt_rate=0.03)),
    ("paper config 20K/400K", "paper", (20_000, 400_000),
     dict(seed=7, drop_rate=0.04, dup_rate=0.02, corrupt_rate=0.02,
          blackouts=((0, 1, 2, 0, 512),))))


def fault_stream(name: str, kind: str, arg, plan) -> dict:
    """One --faults stream through the JAX engine, with telemetry on but
    for the 32x32 row."""
    sys.path.insert(0, str(ROOT))
    from repro.core.engine import LivelockError
    from repro.graph.streams import hub_edges
    from repro.resilience import FaultPlan
    from repro_torch.obs.frames import state_digests
    t0 = time.time()
    out = dict(name=name, kind=kind)
    if kind == "smoke":
        from benchmarks.engine_throughput import ENGINE_SCALES, _cfg
        p = ENGINE_SCALES[arg]
        plan = dict(seed=7, drop_rate=0.04, dup_rate=0.02, corrupt_rate=0.02,
                    blackouts=((0, 1, 2, 0, p["chunk"]),))
        cfg = _cfg(p, "jnp", faults=FaultPlan(**plan), telemetry=True)
        incs = make_stream(StreamSpec(
            n_vertices=p["n_vertices"], n_edges=p["n_edges"], increments=3,
            sampling="edge", seed=3))
        out["scale"] = arg
    elif kind == "hub":   # tests/test_resilience.py::_hub_stream, _cfg
        cfg = EngineConfig(height=8, width=8, n_vertices=256, edge_cap=8,
                           ghost_slots=24, queue_cap=32, chan_cap=16,
                           chunk=64, lanes=2, max_cycles=200_000,
                           telemetry=True, faults=FaultPlan(**plan))
        e = hub_edges(256, 0, 120, seed=3)
        one = np.float32(1.0).view(np.int32)
        e = np.concatenate([e, np.full((len(e), 1), one, np.int64)],
                           1).astype(np.int32)
        incs = [e[lo:hi] for lo, hi in arg]
        out["splits"] = [list(x) for x in arg]
    elif kind == "paper":
        from benchmarks.paper_experiments import _engine
        n, m = arg
        cfg = dataclasses.replace(_engine(n, "bfs", n_edges=m).cfg,
                                  faults=FaultPlan(**plan))
        incs = make_stream(StreamSpec(increments=10, sampling="edge",
                                      seed=1, n_vertices=n, n_edges=m))
        out["size"] = [n, m]
    else:
        ref = json.loads((ROOT / "tests" / "data"
                          / "pre_lanes_reference.json").read_text())
        cfg = EngineConfig(**ref["cfg"], telemetry=True,
                           faults=FaultPlan(**plan))
        incs = make_stream(StreamSpec(**ref["spec"]))
    out.update(cfg={k: v for k, v in dataclasses.asdict(cfg).items()
                    if k != "faults"},
               plan=dataclasses.asdict(cfg.faults))
    eng = StreamingEngine(cfg, "bfs")
    eng.seed(0, 0.0)
    rows = []
    for i, e in enumerate(incs):
        try:
            r = eng.run_increment(e, max_cycles=MAX_CYCLES)
        except LivelockError as ex:
            out["livelock"] = dict(increment=i, cycle=ex.cycle,
                                   chunk=ex.chunk,
                                   flt=np.asarray(eng.state.flt).tolist())
            break
        rows.append(dict(
            cycles=r.cycles, hops=r.hops, execs=r.execs, stalls=r.stalls,
            allocs=r.allocs, flt=np.asarray(eng.state.flt).tolist(),
            frames=len(r.frames) if r.frames else 0,
            state=state_digests({k: np.asarray(v) for k, v in
                                 eng.state._asdict().items()})))
    out["increments"] = rows
    print(f"{name}: {[r['cycles'] for r in rows]} cycles, flt "
          f"{[r['flt'] for r in rows]}, livelock {out.get('livelock')} in "
          f"{time.time() - t0:.1f}s", flush=True)
    return out


def main_faults() -> None:
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(
            len(FAULT_STREAMS), mp_context=ctx) as pool:
        runs = list(pool.map(fault_stream, *zip(*FAULT_STREAMS)))
    out = dict(command=COMMAND + " --faults", commit=_commit(),
               engine="repro (JAX, jnp backend, telemetry=True)",
               digest="obs.frames.state_digests: first 16 hex digits of the "
                      "sha256 of each leaf's int32 bytes (float32 leaves "
                      "by their bits, bool leaves as 0/1), little-endian, "
                      "C order",
               max_cycles=MAX_CYCLES, source=0, streams=runs)
    FAULTS_OUT.write_text(json.dumps(out, indent=1) + "\n")
    print(f"wrote {FAULTS_OUT}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--paper-ci", action="store_true",
                    help="record paper_ci_fingerprint.json instead")
    ap.add_argument("--skew", action="store_true",
                    help="record skew_fingerprint.json instead")
    ap.add_argument("--telemetry", action="store_true",
                    help="record telemetry_fingerprint.json instead")
    ap.add_argument("--faults", action="store_true",
                    help="record fault_fingerprint.json instead")
    args = ap.parse_args()
    if args.faults:
        main_faults()
    elif args.telemetry:
        main_telemetry()
    elif args.skew:
        main_skew()
    elif args.paper_ci:
        main_paper_ci()
    else:
        main_32x32()
