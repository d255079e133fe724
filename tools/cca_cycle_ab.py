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

One card; ~15 s a run, the build included.
"""
import json
import pathlib
import sys

import torch


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
    ptxas = {name[-48:]: (info.get("registers"), info.get("spill_stores"),
                          info.get("spill_loads"))
             for name, info in _build.ptxas_functions(ops.build()[1]).items()
             if "cca_cycle" in name}
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
    print(json.dumps(dict(tree=tag, card=torch.cuda.get_device_name(0),
                          telemetry=telemetry, faults=faults,
                          launches=len(events),
                          stream_ms_per_launch=stream_ms,
                          chunk_ms=chunk_ms, ptxas=ptxas)), flush=True)


if __name__ == "__main__":
    flags = ("--telemetry", "--faults")
    args = [a for a in sys.argv[1:] if a not in flags]
    if len(args) != 2:
        raise SystemExit(__doc__)
    main(*args, telemetry="--telemetry" in sys.argv[1:],
         faults="--faults" in sys.argv[1:])
