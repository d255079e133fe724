"""bench_serve on the port: multi-tenant query serving over a live R-MAT
stream (``benchmarks/serve_bench.py`` of the JAX package).

One :class:`MQSession` carries a mixed BFS / SSSP / CC / widest batch of
Q = 8 queries through an evolving R-MAT graph (DESIGN §10), with
:class:`FrontDesk` admission and per-query time to quiescence.  The
baseline replays the same stream once per query on a single-query
engine.  Both sides count machine cycles, so

    speedup = sum(serial cycles over the Q queries) / batch cycles

is the throughput multiplier of sharing one diffusion wave.  Each tenant
must equal its serial run bit for bit.  The record is the JAX package's
(``results/bench_serve.json`` at ci scale) plus ``wall_s``: the batch's
and each serial run's wall time on the host clock, each ending in a read
of the values (so on the card, after the device finished).

Every chunk is one launch of the cycle kernel on the card (its
query-batched instance for the batch), the plain PyTorch version on the
CPU.  Nothing is written unless ``--out`` names a file.

    PYTHONPATH=src python -m repro_torch.launch.serve_bench --scale ci --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve_bench --scale paper
"""
from __future__ import annotations

import argparse
import json
import pathlib
import time

import numpy as np

from repro_torch.core.config import EngineConfig
from repro_torch.core.engine import StreamingEngine
from repro_torch.graph.streams import StreamSpec, make_stream
from repro_torch.mq.frontdesk import FrontDesk
from repro_torch.mq.session import DEFAULT_SEEDS, MQSession, label_seed
from repro_torch.core.state import state_to_numpy
from repro_torch.obs import metrics
from repro_torch.obs.frames import plane_digest, state_digests

# the serving mesh sits above the single-query sweet spot on purpose: a
# Q-way batch exists to soak up idle cells
SCALES = {
    "ci": dict(height=16, width=16, n_vertices=256, n_edges=700,
               increments=3, chunk=128),
    "mid": dict(height=24, width=24, n_vertices=1024, n_edges=4000,
                increments=5, chunk=256),
    "paper": dict(height=32, width=32, n_vertices=4096, n_edges=20000,
                  increments=10, chunk=256),
}

# the Q=8 mixed tenant batch (app, source); CC is the label-flood tenant,
# admitted before the stream starts
QUERY_MIX = (("bfs", 0), ("bfs", 17), ("bfs", 42), ("sssp", 5),
             ("sssp", 23), ("sssp", 77), ("cc", 0), ("widest", 11))

SOURCES_SEED = 39   # batch_sources' draw


def batch_sources(n: int, q: int = 8, seed: int = SOURCES_SEED) -> list:
    """Vertex 0 and ``q - 1`` distinct other vertices of ``n``, drawn with
    ``seed``: the sources of an all-BFS batch (the ``--mq`` fingerprint's
    paper-config row, ``chip_smoke.py`` phase 39)."""
    rng = np.random.default_rng(seed)
    others = rng.choice(np.arange(1, n), q - 1, replace=False)
    return [0] + sorted(int(v) for v in others)


def _serve_cfg(p: dict) -> EngineConfig:
    """The serving preset: every congestion defence of the single-query
    benches scaled for Q waves in one machine (deep virtual lanes, rhizome
    roots, 4x queue and channel depth, the tm_hiw ingest guard)."""
    return EngineConfig(
        height=p["height"], width=p["width"], n_vertices=p["n_vertices"],
        edge_cap=8,
        ghost_slots=max(64, 8 * p["n_edges"]
                        // (p["height"] * p["width"])),
        queue_cap=256, chan_cap=64, futq_cap=8, io_stream_cap=8192,
        lanes=8, rhizome_cap=4, telemetry=True, ingest_guard=True,
        chunk=p["chunk"], max_cycles=4_000_000)


def _stream(p: dict) -> list:
    """Symmetric R-MAT increments, each undirected pair hashed to one
    weight in (0.1, 1.0] so the SSSP and widest tenants diverge from
    BFS."""
    spec = StreamSpec(n_vertices=p["n_vertices"], n_edges=p["n_edges"],
                      increments=p["increments"], kind="rmat",
                      symmetric=True, seed=7)
    out = []
    for e in make_stream(spec):
        e = e.copy()
        lo = np.minimum(e[:, 0], e[:, 1]).astype(np.int64)
        hi = np.maximum(e[:, 0], e[:, 1]).astype(np.int64)
        key = (lo << 21) ^ hi
        w = (0.1 + 0.9 * ((key * 2654435761 % 1000003) / 1000003.0))
        e[:, 2] = w.astype(np.float32).view(np.int32)
        out.append(e)
    return out


def _serial_run(cfg, app, source, incs, device=None):
    """The single-query baseline: the same stream, one tenant.  Returns
    ``(engine, total cycles)``."""
    eng = StreamingEngine(cfg, app, device=device)
    if app == "cc":
        label_seed(eng)
    else:
        eng.seed(source, DEFAULT_SEEDS[app])
    cycles = 0
    for e in incs:
        cycles += eng.run_increment(e).cycles
    return eng, cycles


def serve_record(scale: str, receipts: list, serial_cycles: list,
                 exact: list, batch_cycles: int, deferrals: int) -> dict:
    """The JAX package's record from a run's receipts (the tenants in
    QUERY_MIX's order for ``serial_cycles`` and ``exact``)."""
    slot_of = {(r["app"], r["source"]): r["slot"] for r in receipts}
    lat = [r["latency_cycles"] for r in receipts
           if r["latency_cycles"] is not None]
    summary = metrics.summarize(lat, unit="cycles")
    speedup = float(sum(serial_cycles)) / max(1, batch_cycles)
    return dict(
        scale=scale, qbatch=len(QUERY_MIX),
        queries=[dict(slot=slot_of[(a, s)], app=a, source=s,
                      serial_cycles=serial_cycles[q], exact=exact[q])
                 for q, (a, s) in enumerate(QUERY_MIX)],
        receipts=[{k: v for k, v in r.items() if k != "values"}
                  for r in receipts],
        latency=summary,
        p50_cycles=summary.get("p50"), p99_cycles=summary.get("p99"),
        batch_cycles=int(batch_cycles),
        serial_cycles_total=int(sum(serial_cycles)),
        speedup=round(speedup, 3), all_exact=all(exact),
        deferrals=deferrals)


def serve_batch(scale: str, device=None, *, _place=None):
    """The batched half of ``bench_serve``: ``(session, front desk,
    batch cycles, the values of each slot, wall seconds)``.  ``_place``,
    where given, is called with the session once the label-flood tenant
    is admitted (e.g. to shard its state over a mesh)."""
    p = SCALES[scale]
    cfg = _serve_cfg(p)
    incs = _stream(p)
    t0 = time.time()
    ses = MQSession(cfg, qbatch=len(QUERY_MIX),
                    apps=[a for a, _ in QUERY_MIX], device=device)
    fd = FrontDesk(ses)
    for app, src in QUERY_MIX:
        if app == "cc":
            ses.admit(app, src)       # label flood: before the stream only
        else:
            fd.submit(app, src)
    if _place is not None:
        _place(ses)
    batch_cycles = 0
    for e in incs:
        batch_cycles += fd.step(e).cycles
    # one empty beat, so tenants that changed in the last increment see a
    # quiet boundary and settle (machine time the serving run spent)
    batch_cycles += fd.step(np.zeros((0, 3), np.int32)).cycles
    for q, s in enumerate(ses.slots):
        if s.state != "free":
            fd.receipts.append(ses.retire(q))
    # a retired slot's plane stays intact until it is recycled
    values = {q: ses.values(q) for q in range(len(QUERY_MIX))}
    return ses, fd, batch_cycles, values, time.time() - t0


def bench_serve(scale: str = "ci", device=None,
                out_values: dict | None = None) -> dict:
    """The batch, the serial baselines and the exactness of each tenant
    against its serial run; the JAX package's record plus ``wall_s``.
    ``out_values``, a dict, gets each tenant's batch values under its
    ``(app, source)``."""
    p = SCALES[scale]
    cfg, incs = _serve_cfg(p), _stream(p)
    ses, fd, batch_cycles, values, batch_wall = serve_batch(scale, device)
    slot_of = {(r["app"], r["source"]): r["slot"] for r in fd.receipts}
    serial_cycles, exact, serial_wall = [], [], []
    for app, src in QUERY_MIX:
        t0 = time.time()
        eng, cyc = _serial_run(cfg, app, src, incs, device)
        got = eng.values()
        serial_wall.append(time.time() - t0)
        serial_cycles.append(cyc)
        exact.append(bool(np.array_equal(got, values[slot_of[(app, src)]])))
    rec = serve_record(scale, fd.receipts, serial_cycles, exact,
                       batch_cycles, fd.deferrals)
    rec["wall_s"] = dict(batch=batch_wall, serial=serial_wall)
    if out_values is not None:
        out_values.update({k: values[q] for k, q in slot_of.items()})
    return rec


# ---------------- the --mq fingerprint's runs, on the port ----------------

def weighted_stream(n: int = 128, n_edges: int = 360, increments: int = 2,
                    seed: int = 11) -> list:
    """``tests/test_mq.py::_weighted_stream``: symmetric SBM increments,
    each undirected pair hashed to one weight in (0.1, 1.0]."""
    incs = make_stream(StreamSpec(n_vertices=n, n_edges=n_edges,
                                  increments=increments, symmetric=True,
                                  seed=seed))
    out = []
    for e in incs:
        e = e.copy()
        lo = np.minimum(e[:, 0], e[:, 1]).astype(np.int64)
        hi = np.maximum(e[:, 0], e[:, 1]).astype(np.int64)
        key = (lo << 21) ^ hi
        w = 0.1 + 0.9 * ((key * 2654435761 % 1000003) / 1000003.0)
        e[:, 2] = w.astype(np.float32).view(np.int32)
        out.append(e)
    return out


def _digests(eng) -> dict:
    return state_digests(state_to_numpy(eng._whole()))


def _values(ses, n=None) -> list:
    out = []
    for q in range(ses.qbatch):
        v = np.asarray(ses.values(q, n), np.float32)
        rec = dict(digest=plane_digest(v.view(np.int32)))
        if len(v) <= 256:
            rec["values"] = [float(x) for x in v]
        out.append(rec)
    return out


def _slots(ses) -> list:
    return [dict(app=s.app.name if s.app is not None else None,
                 source=s.source, generation=s.generation, state=s.state,
                 admit_cycle=s.admit_cycle, settle_cycle=s.settle_cycle,
                 increments=s.increments) for s in ses.slots]


def _step(ses, edges, **kw) -> dict:
    r = ses.run_increment(edges, **kw)
    st = ses.eng.state
    return dict(edges=len(edges), cycles=r.cycles, hops=r.hops,
                execs=r.execs, stalls=r.stalls, allocs=r.allocs,
                qchg=st.qchg.tolist(), qlast=st.qlast.tolist(),
                cycle=int(st.cycle), slots=_slots(ses),
                state=_digests(ses.eng))


def _final(ses, n=None) -> dict:
    return dict(state=_digests(ses.eng), values=_values(ses, n),
                slots=_slots(ses), total_cycles=ses.eng.total_cycles)


def _port_cfg(d: dict) -> EngineConfig:
    return EngineConfig(**{k: v for k, v in d.items() if k != "backend"})


def mq_replay(rec: dict, device=None, pinned: dict | None = None) -> dict:
    """One run of ``src/repro_torch/data/mq_fingerprint.json`` (recorded by
    ``tools/record_torch_fingerprint.py --mq`` from the JAX engine) on the
    port, recorded the same way: its keys equal ``rec``'s where the port
    agrees.  ``pinned`` is ``tests/data/pre_lanes_reference.json`` (the
    "q1" run's stream)."""
    from repro_torch.core.apps import APPS
    from repro_torch.core.engine import LivelockError
    from repro_torch.launch.paper_experiments import experiment_config
    from repro_torch.mq.session import QuerySlot
    kind = rec["kind"]
    out = dict(name=rec["name"], kind=kind)
    empty = np.zeros((0, 3), np.int32)
    cfg = _port_cfg(rec["cfg"])
    if kind == "q1":
        ses = MQSession(cfg, qbatch=1, device=device)
        ses.eng.seed(0, 0.0)
        ses.slots[0] = QuerySlot(app=APPS["bfs"], source=0, state="active")
        incs = make_stream(StreamSpec(**pinned["spec"]))
        rows = [_step(ses, e, max_cycles=500_000) for e in incs]
        rows.append(_step(ses, empty))
        out.update(cfg=rec["cfg"], spec=pinned["spec"], increments=rows,
                   final=_final(ses, 128))
    elif kind in ("mix8", "admit", "q3"):
        mix = [tuple(m) for m in rec["mix"]]
        incs = weighted_stream(**rec["stream"])
        ses = MQSession(cfg, qbatch=len(mix), apps=[a for a, _ in mix],
                        device=device)
        out.update(cfg=rec["cfg"], stream=rec["stream"], mix=rec["mix"])
        if kind == "admit":
            steps = []
            ses.admit("bfs", 0, slot=0)
            steps.append(dict(do="admit bfs 0 slot 0", slots=_slots(ses)))
            steps.append(dict(do="increment 0", **_step(ses, incs[0])))
            ses.admit("sssp", 3, slot=1)
            steps.append(dict(do="admit sssp 3 slot 1", slots=_slots(ses)))
            for i in (1, 2):
                steps.append(dict(do=f"increment {i}",
                                  **_step(ses, incs[i])))
            steps.append(dict(do="empty", **_step(ses, empty)))
            steps.append(dict(do="values", values=_values(ses)))
            steps.append(dict(do="retire 1", receipt=ses.retire(1)))
            ses.admit("widest", 5, slot=1)
            steps.append(dict(do="admit widest 5 slot 1", slots=_slots(ses)))
            steps.append(dict(do="empty", **_step(ses, empty)))
            steps.append(dict(do="values", values=_values(ses)))
            out.update(steps=steps, final=_final(ses))
        else:
            for q, (app, src) in enumerate(mix):
                ses.admit(app, src, slot=q)
            rows = [_step(ses, e) for e in incs]
            if kind == "mix8":
                rows.append(_step(ses, empty))
            out.update(increments=rows, final=_final(ses))
            if kind == "mix8":
                out["receipts"] = [ses.retire(q) for q in range(len(mix))]
    elif kind == "serve":
        scale = rec["scale"]
        p = SCALES[scale]
        incs = _stream(p)
        ses = MQSession(cfg, qbatch=len(QUERY_MIX),
                        apps=[a for a, _ in QUERY_MIX], device=device)
        fd = FrontDesk(ses)
        for app, src in QUERY_MIX:
            if app == "cc":
                ses.admit(app, src)
            else:
                fd.submit(app, src)
        beats = []
        for e in incs + [empty]:
            fd.pump()
            beats.append(_step(ses, e))
            fd.pos += 1
            for q in ses.settled_slots():
                fd.receipts.append(ses.retire(q))
            beats[-1]["receipts"] = len(fd.receipts)
        batch_cycles = sum(b["cycles"] for b in beats)
        for q, s in enumerate(ses.slots):
            if s.state != "free":
                fd.receipts.append(ses.retire(q))
        values = {q: ses.values(q) for q in range(len(QUERY_MIX))}
        slot_of = {(r["app"], r["source"]): r["slot"] for r in fd.receipts}
        final = _final(ses)
        serial = []
        for app, src in QUERY_MIX:
            eng, cyc = _serial_run(_serve_cfg(p), app, src, incs, device)
            serial.append(dict(app=app, source=src, cycles=cyc,
                               exact=bool(np.array_equal(
                                   eng.values(), values[slot_of[(app, src)]])),
                               state=_digests(eng)))
        record = serve_record(scale, fd.receipts,
                              [x["cycles"] for x in serial],
                              [x["exact"] for x in serial], batch_cycles,
                              fd.deferrals)
        out.update(scale=scale, cfg=rec["cfg"], beats=beats, final=final,
                   serial=serial, record=record)
    else:
        n, m = rec["size"]
        cfg = experiment_config(n, m)
        sources = rec["sources"]
        ses = MQSession(cfg, qbatch=len(sources),
                        apps=["bfs"] * len(sources), device=device)
        for q, src in enumerate(sources):
            ses.admit("bfs", src, slot=q)
        incs = make_stream(StreamSpec(increments=10, sampling="edge",
                                      seed=1, n_vertices=n, n_edges=m))
        out.update(size=[n, m], cfg=rec["cfg"], sources=sources,
                   sources_seed=rec["sources_seed"])
        rows = []
        try:
            for e in incs + [empty]:
                rows.append(_step(ses, e, max_cycles=2_000_000))
        except LivelockError as ex:
            out["livelock"] = dict(increment=len(rows), cycle=ex.cycle,
                                   chunk=ex.chunk, message=str(ex),
                                   state=_digests(ses.eng))
        out.update(increments=rows, final=_final(ses, n))
        out["outcome"] = "livelock" if "livelock" in out else "quiescent"
    return json.loads(json.dumps(out))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", default="ci", choices=sorted(SCALES))
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--out", default=None,
                    help="write the record as JSON to this file")
    args = ap.parse_args()
    rec = bench_serve(args.scale, args.device)
    print(json.dumps(rec))
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(rec, indent=2) + "\n")


if __name__ == "__main__":
    main()
