"""Time the cycle kernel of one checkout of this repository on the paper
stream, for an A/B of two checkouts on one card.

Runs the paper's 50K-vertex / 1M-edge stream (ten edge-sampled increments,
seed 1, `benchmarks/paper_experiments.py::_engine`'s 32x32 config) through
the engine of the checkout at TREE, the kernels built from its sources,
and prints one JSON line: the mean ms a launch over the stream's launches
(CUDA events around each launch), five K=512 chunks of its last
increment on the cluster kernel, and the ptxas registers and spill bytes
of the checkout's cycle kernels.  Compare two checkouts in one call, in
turns, each in its own process:

    for t in parent change change parent; do
        python3 tools/cca_cycle_ab.py <checkout of $t> $t; done

``--telemetry`` runs the stream and the chunks with ``telemetry=True`` (a
checkout whose port carries telemetry), for the cost of the kernels'
telemetry instances against the same checkout without it.  ``--faults``
runs them under a zero-rate fault plan (``FaultPlan(seed=7)``: the
kernels' fault instances, every message sealed and checked, nothing
injected; a checkout whose port carries faults), for the price of the
seals and the fault branch against the same checkout without it.

It also times 14 of the kernels' instances, those a checkout has since
the tile instance came (plain, telemetry, faults, both, a query batch
and a query batch with telemetry on each kernel, and the plain tile
instance on each), one chunk each from one input, in the line's
``instances`` (ms a launch, or for a tile a 4-tile cycle): the plain and
fault mixes one K=64 chunk of the stream's last increment (a zero-rate
plan for faults), the query batches one K=64 chunk of a Q=2 batch (bfs,
sssp) of the 2,000-vertex / 20K-edge stream's first increment on the same
config, the tile instance 32 cycles of the last increment's state over a
(4, 1) mesh of ``LocalTiles``; the median of three, each from a fresh
copy of the input, after an untimed one.  A newer checkout's new
instances are not timed here.

One card; ~40 s a run, the build included.
"""
import dataclasses
import json
import pathlib
import re
import sys

import torch


def instance_ms(cfg, eng, st) -> dict:
    """ms of one chunk on each of the 14 instances, by CUDA events."""
    from repro_torch.core import StreamingEngine
    from repro_torch.core.ingest import load_stream
    from repro_torch.core.state import init_state
    from repro_torch.dist import cca
    from repro_torch.graph.streams import StreamSpec, make_stream
    from repro_torch.kernels.cca_cycle import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.mq import batch_app
    from repro_torch.resilience import FaultPlan

    def ms(make, run, reps=3):
        """The median ms of ``run(make())`` over ``reps`` runs by CUDA
        events, each on a fresh ``make()``, after an untimed one (the
        instance's first launch sets its attributes)."""
        run(make())
        times = []
        for _ in range(reps):
            x = make()
            torch.cuda.synchronize()
            a, b = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
            a.record()
            run(x)
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        return sorted(times)[reps // 2]

    def with_layout(c, s):
        """A copy of ``s`` with ``c``'s (zero) telemetry planes and fault
        counters."""
        lay = init_state(c, device="meta")
        s = s._replace(**{k: v.clone() for k, v in s._asdict().items()})
        return s._replace(**{k: torch.zeros(
            getattr(lay, k).shape, dtype=torch.int32, device=s.aq.device)
            for k in ("tm_cell", "tm_lane", "tm_hiw", "flt")})

    out = {}
    base = dataclasses.replace(cfg, telemetry=False, faults=None)
    mixes = {"": base, "_telemetry": dataclasses.replace(base, telemetry=True),
             "_faults": dataclasses.replace(base, faults=FaultPlan(seed=7))}
    mixes["_telemetry_faults"] = dataclasses.replace(mixes["_faults"],
                                                     telemetry=True)
    for path in ("cluster", "block"):
        for name, c in mixes.items():
            out[path + name] = ms(lambda: with_layout(c, st),
                                  lambda s: ops.cca_cycle_chunk(
                                      c, eng.app, s, 64, path=path))
    qeng = StreamingEngine(base, batch_app(["bfs", "sssp"]))
    qeng.seed(0, 0.0, val_idx=0)
    qeng.seed(0, 0.0, val_idx=1)
    e = make_stream(StreamSpec(increments=10, sampling="edge", seed=1,
                               n_vertices=2_000, n_edges=20_000))[0]
    qst, _ = load_stream(qeng.cfg, qeng.state, e)
    for path in ("cluster", "block"):
        for name, tm in (("_query", False), ("_telemetry_query", True)):
            c = dataclasses.replace(qeng.cfg, telemetry=tm)
            out[path + name] = ms(lambda: with_layout(c, qst),
                                  lambda s: ops.cca_cycle_chunk(
                                      c, qeng.app, s, 64, path=path))
    for path in ("cluster", "block"):
        out[path + "_tile"] = ms(
            lambda: cca.shard_state(base, with_layout(base, st),
                                    make_host_mesh(4, 1)),
            lambda sst: cca.run_chunk(base, eng.app, sst, 32,
                                      path=path)) / 32
    return out


def main(tree: str, tag: str, telemetry: bool = False,
         faults: bool = False) -> None:
    sys.path.insert(0, str(pathlib.Path(tree).resolve() / "src"))
    from repro_torch.core import EngineConfig, StreamingEngine
    from repro_torch.core.ingest import load_stream
    from repro_torch.graph.streams import StreamSpec, make_stream
    from repro_torch.kernels import _build
    from repro_torch.kernels.cca_cycle import ops

    kw = {"telemetry": True} if telemetry else {}
    if faults:
        from repro_torch.resilience import FaultPlan
        kw["faults"] = FaultPlan(seed=7)
    n, m = 50_000, 1_000_000
    ghosts = max(64, 2 * m // (8 * 1024), 3 * n // 1024)
    cfg = EngineConfig(height=32, width=32, n_vertices=n, edge_cap=8,
                       ghost_slots=ghosts, queue_cap=64, chan_cap=16,
                       futq_cap=16, io_stream_cap=2 ** 21, chunk=512, **kw)
    ptxas, report = {}, ops.build()[1]
    if hasattr(ops, "build_tiles"):      # a checkout with two libraries
        report += ops.build_tiles()[1]
    for name, info in _build.ptxas_functions(report).items():
        hit = re.search(r"(cca_cycle_cluster_kernel|cca_cycle_kernel)"
                        r"ILb([01])ELb([01])ELb([01])ELb([01])E", name)
        if hit:
            ptxas[("cluster" if "cluster" in hit[1] else "block")
                  + "".join(f"+{k}" for k, b in zip(
                      ("tm", "flt", "q", "tl"), hit.groups()[1:])
                      if b == "1")
                  ] = (info.get("registers"), info.get("spill_stores"),
                       info.get("spill_loads"))
    incs = make_stream(StreamSpec(increments=10, sampling="edge", seed=1,
                                  n_vertices=n, n_edges=m))
    eng = StreamingEngine(cfg, "bfs")
    eng.seed(0, 0.0)
    launch, events = ops.cca_cycle_chunk, []

    def timed(*a, **kw):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = launch(*a, **kw)
        ev[1].record()
        events.append(ev)
        return out

    def clone(st):
        return st._replace(**{k: v.clone() for k, v in st._asdict().items()})

    ops.cca_cycle_chunk = timed
    for i, e in enumerate(incs):
        if i == len(incs) - 1:
            snapshot = clone(eng.state)
        eng.run_increment(e, max_cycles=2_000_000)
    torch.cuda.synchronize()
    ops.cca_cycle_chunk = launch
    stream_ms = sum(a.elapsed_time(b) for a, b in events) / len(events)
    st, _ = load_stream(cfg, snapshot, incs[-1])
    z = torch.zeros((), dtype=torch.int32, device=st.aq.device)
    st = st._replace(stat_hops=z.clone(), stat_exec=z.clone(),
                     stat_stall=z.clone(), stat_allocs=z.clone(),
                     tm_cell=st.tm_cell.zero_(), tm_lane=st.tm_lane.zero_(),
                     tm_hiw=st.tm_hiw.zero_(), flt=st.flt.zero_())
    chunk_ms = []
    for _ in range(5):
        s = clone(st)
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        a.record()
        launch(cfg, eng.app, s, 512, path="cluster")
        b.record()
        torch.cuda.synchronize()
        chunk_ms.append(a.elapsed_time(b))
    row = dict(tree=tag, card=torch.cuda.get_device_name(0),
               telemetry=telemetry, faults=faults, launches=len(events),
               stream_ms_per_launch=stream_ms, chunk_ms=chunk_ms,
               ptxas=ptxas, instances=instance_ms(cfg, eng, st))
    print(json.dumps(row), flush=True)


if __name__ == "__main__":
    flags = ("--telemetry", "--faults")
    args = [a for a in sys.argv[1:] if a not in flags]
    if len(args) != 2:
        raise SystemExit(__doc__)
    main(*args, telemetry="--telemetry" in sys.argv[1:],
         faults="--faults" in sys.argv[1:])
