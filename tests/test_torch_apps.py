"""SSSP and CC on the port's CPU engine equal the JAX engine (counters,
values, every state leaf) and the port's own oracles, on small streams.
The SSSP stream overflows ``io_stream_cap`` so both engines take the
spill reload passes.
"""
import numpy as np
import pytest
import torch

from repro.core import EngineConfig as JConfig
from repro.core import StreamingEngine as JEngine
from repro_torch.core import EngineConfig, StreamingEngine
from repro_torch.core.reference import cc_labels, sssp_dists
from repro_torch.core.state import state_to_numpy
from repro_torch.graph.streams import StreamSpec, make_stream

BASE = dict(height=8, width=8, n_vertices=96, edge_cap=4, ghost_slots=24,
            queue_cap=32, chan_cap=8, futq_cap=8, io_stream_cap=2048,
            chunk=64)
CASES = {
    "sssp": (dict(BASE, io_stream_cap=12),
             dict(n_vertices=96, n_edges=400, increments=2, seed=3)),
    "cc": (BASE, dict(n_vertices=96, n_edges=160, increments=2, seed=4,
                      symmetric=True)),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain version runs thousands of tiny ops per cycle: one
    intra-op thread is faster, and leaves the cores to the other test
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("app", sorted(CASES))
def test_app_matches_jax_engine_and_oracle(app):
    kw, spec = CASES[app]
    incs = make_stream(StreamSpec(**spec))
    if app == "sssp":
        # weights 0.25 .. 2.0 (exact in float32), bit-cast into word 2
        rng = np.random.default_rng(7)
        for e in incs:
            e[:, 2] = (rng.integers(1, 9, len(e)) / 4).astype(
                np.float32).view(np.int32)
    n = spec["n_vertices"]
    jeng = JEngine(JConfig(**kw), app)
    eng = StreamingEngine(EngineConfig(**kw), app, device="cpu")
    if app == "cc":
        for v in range(n):           # every vertex starts with its own id
            jeng.seed(v, float(v))
            eng.seed(v, float(v))
    else:
        jeng.seed(0, 0.0)
        eng.seed(0, 0.0)
    for e in incs:
        jr = jeng.run_increment(e, max_cycles=500_000)
        r = eng.run_increment(e, max_cycles=500_000)
        assert (r.cycles, r.hops, r.execs, r.stalls, r.allocs) == \
            (jr.cycles, jr.hops, jr.execs, jr.stalls, jr.allocs)
    got = state_to_numpy(eng.state)
    for k, v in jeng.state._asdict().items():
        a, b = got[k], np.asarray(v)
        if a.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        np.testing.assert_array_equal(a, b, err_msg=k)
    allv = np.concatenate(incs)
    want = (sssp_dists(n, allv, allv[:, 2].view(np.float32), 0)
            if app == "sssp" else cc_labels(n, allv))
    np.testing.assert_array_equal(eng.values(n), want)
