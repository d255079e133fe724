"""The hub stream of ``tests/test_lanes.py`` (8x8, 128 vertices, one hub of
degree 200, ``queue_cap`` 20) on the port's plain version, on the CPU, at
``lanes=4``: every state leaf equal to the JAX engine's after every chunk
of 64 cycles (the arbiter, the escape lane, transit parking and the park
stage all engaged), and the final values the oracle's.  Exact: integer
leaves equal, float leaves equal as bits.  ``lanes=2``:
``tests/test_torch_lanes_hub2.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import EngineConfig as JConfig
from repro.core import StreamingEngine as JEngine
from repro.core.engine import quiescent as j_quiescent
from repro.core.engine import run_to_quiescence_while
from repro.core.ingest import load_stream as j_load
from repro.graph.streams import hub_edges
from repro_torch.core import EngineConfig, StreamingEngine
from repro_torch.core.ingest import load_stream
from repro_torch.core.reference import bfs_levels
from repro_torch.core.state import state_to_numpy
from repro_torch.kernels.cca_cycle.ops import cca_cycle_chunk

ONE = np.float32(1.0).view(np.int32)
HUB = dict(height=8, width=8, n_vertices=128, edge_cap=4, ghost_slots=48,
           queue_cap=20, chan_cap=16, futq_cap=4, io_stream_cap=2048,
           chunk=64)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain version runs thousands of tiny ops per cycle: one
    intra-op thread is faster, and leaves the cores to the other test
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def hub_stream(n=128, degree=200, seed=3):
    e = hub_edges(n, 0, degree, seed=seed)
    return np.concatenate([e, np.full((len(e), 1), ONE, np.int64)],
                          1).astype(np.int32)


def assert_same_state(st, jst, where=""):
    got = state_to_numpy(st)
    for k, v in jst._asdict().items():
        a, b = got[k], np.asarray(v)
        if a.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        np.testing.assert_array_equal(a, b, err_msg=f"{k} {where}")


def run_chunk_by_chunk(kw, app, edges, seed):
    """One increment through both engines' chunk runners (the JAX jnp
    while-loop capped at ``chunk`` cycles; the port's ``cca_cycle_chunk``),
    every leaf compared after every chunk.  Returns the port's engine."""
    jeng = JEngine(JConfig(**kw), app)
    seed(jeng)
    jcfg = jeng.cfg
    jst, spill = j_load(jcfg, jeng.state, edges)
    assert len(spill) == 0
    z = jnp.int32(0)
    jst = jst._replace(stat_hops=z, stat_exec=z, stat_stall=z, stat_allocs=z)
    jchunk = jax.jit(lambda s: run_to_quiescence_while(
        jcfg, jeng.app, s, max_cycles=jcfg.chunk))
    eng = StreamingEngine(EngineConfig(**kw), app, device="cpu")
    seed(eng)
    st, _ = load_stream(eng.cfg, eng.state, edges)
    zt = torch.zeros((), dtype=torch.int32)
    st = st._replace(stat_hops=zt, stat_exec=zt.clone(),
                     stat_stall=zt.clone(), stat_allocs=zt.clone())
    for i in range(10_000):
        jst = jchunk(jst)
        st, qr = cca_cycle_chunk(eng.cfg, eng.app, st)
        assert_same_state(st, jst, f"chunk {i}")
        assert bool(qr[0]) == bool(j_quiescent(jst)), i
        if qr[0]:
            break
    eng.state = st
    return eng


def test_hub_lanes4_every_leaf_equal_to_jax_chunk_by_chunk():
    edges = hub_stream()
    eng = run_chunk_by_chunk(dict(lanes=4, **HUB), "bfs", edges,
                             lambda e: e.seed(0, 0.0))
    # transit parking did engage: a parked emission counts as a stall
    assert int(eng.state.stat_stall) > 0 and int(eng.state.cycle) > 4000
    np.testing.assert_array_equal(eng.values(128), bfs_levels(128, edges, 0))
