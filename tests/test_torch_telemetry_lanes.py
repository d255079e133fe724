"""Telemetry planes in the port on the CPU against the JAX engine, on the
lane, park, rhizome and max-app branches: with ``telemetry=True``, every
state leaf, the three planes included, equal to the JAX engine's after
every chunk, on the 8x8 hub stream of ``tests/test_lanes.py`` at
``lanes=4`` (its first ten chunks: the lane arbiter's grants and blocked
cycles, transit parking), the hub stream of ``tests/test_rhizome.py`` at
``rhizome_cap=4`` (the sibling broadcasts, ``TM_BCAST``), and ``widest``
and ``reliable`` at ``rhizome_cap=2``, ``lanes=2`` on a weighted stream.
Exact: integer leaves equal, float leaves equal as bits.
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
from repro_torch.core.state import (TM_BCAST, TM_L_GRANT, TM_PARK,
                                    TM_UNPARK, state_to_numpy)
from repro_torch.kernels.cca_cycle.ops import cca_cycle_chunk

ONE = np.float32(1.0).view(np.int32)
HUB_KW = dict(height=8, width=8, n_vertices=128, edge_cap=4, ghost_slots=48,
              queue_cap=20, chan_cap=16, futq_cap=4, io_stream_cap=2048,
              chunk=64)                   # tests/test_lanes.py::_hub_cfg
RHIZOME_KW = dict(height=8, width=8, n_vertices=64, edge_cap=4,
                  ghost_slots=32, queue_cap=96, chan_cap=16, futq_cap=8,
                  io_stream_cap=2048, chunk=128, rhizome_cap=4)
MAX_APP_KW = dict(height=8, width=8, n_vertices=64, edge_cap=4,
                  ghost_slots=32, queue_cap=48, chan_cap=16, futq_cap=4,
                  io_stream_cap=2048, chunk=64, rhizome_cap=2, lanes=2)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain version runs thousands of tiny ops per cycle: one
    intra-op thread is faster, and leaves the cores to the other test
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_same_state(st, jst, where=""):
    got = state_to_numpy(st)
    for k, v in jst._asdict().items():
        a, b = got[k], np.asarray(v)
        if a.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        np.testing.assert_array_equal(a, b, err_msg=f"{k} {where}")


def hub_stream(n=128, degree=200, seed=3):
    e = hub_edges(n, 0, degree, seed=seed)
    return np.concatenate([e, np.full((len(e), 1), ONE, np.int64)],
                          1).astype(np.int32)


RESET = ("stat_hops", "stat_exec", "stat_stall", "stat_allocs", "tm_cell",
         "tm_lane", "tm_hiw")


def fresh(st):
    """Zero the counters and the planes, as ``run_increment`` does."""
    return st._replace(**{k: torch.zeros_like(getattr(st, k))
                          for k in RESET})


def j_fresh(st):
    return st._replace(**{k: jnp.zeros_like(getattr(st, k)) for k in RESET})


def chunks_equal_jax(kw, app, seed, incs, max_chunks=200):
    """Both engines' chunk runners with ``telemetry=True`` from the same
    seeded state, increment by increment (counters and planes reset at
    each start), every leaf after every chunk; stops at quiescence or
    after ``max_chunks`` chunks in all.  Returns the port's last state
    and the number of chunks compared."""
    kw = dict(kw, telemetry=True)
    jeng = JEngine(JConfig(**kw), app)
    eng = StreamingEngine(EngineConfig(**kw), app, device="cpu")
    for e in (jeng, eng):
        e.seed(0, seed)
    jchunk = jax.jit(lambda s: run_to_quiescence_while(
        jeng.cfg, jeng.app, s, max_cycles=jeng.cfg.chunk))
    jst, st, n = jeng.state, eng.state, 0
    assert_same_state(st, jst, "seeded")
    for i, e in enumerate(incs):
        jst, _ = j_load(jeng.cfg, jst, e)
        st, _ = load_stream(eng.cfg, st, e)
        jst, st = j_fresh(jst), fresh(st)
        while n < max_chunks:
            jst = jchunk(jst)
            st, qr = cca_cycle_chunk(eng.cfg, eng.app, st)
            n += 1
            assert_same_state(st, jst, f"increment {i} chunk {n}")
            assert bool(qr[0]) == bool(j_quiescent(jst))
            if qr[0]:
                break
    return st, n


def weighted_increments(seed=1, n=64, m=320):
    """``tests/test_torch_max_apps.py``'s stream: two increments of random
    edges, each weight drawn from (0, 1]."""
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, m), rng.integers(0, n, m)
    w = (1.0 - rng.random(m)).astype(np.float32)
    e = np.stack([src, dst, w.view(np.int32)], 1).astype(np.int32)
    return [e[: m // 2], e[m // 2:]]


def test_hub_lanes4_every_leaf_equal_to_jax_chunk_by_chunk():
    st, n = chunks_equal_jax(dict(HUB_KW, lanes=4), "bfs", 0.0,
                             [hub_stream()], max_chunks=10)
    assert n == 10
    tm = st.tm_cell
    assert int(tm[..., TM_PARK].sum()) > 0
    assert int(tm[..., TM_UNPARK].sum()) > 0
    # grants land on several lanes (the escape lane and the data lanes)
    assert int((st.tm_lane[..., TM_L_GRANT].sum(dim=(0, 1, 2)) > 0).sum()) > 1


def test_hub_rhizomes_every_leaf_equal_to_jax_chunk_by_chunk():
    e = hub_edges(64, hub=0, degree=40, seed=3)
    edges = np.concatenate([e, np.full((len(e), 1), ONE, np.int64)],
                           1).astype(np.int32)
    st, _ = chunks_equal_jax(RHIZOME_KW, "bfs", 0.0, [edges])
    assert int(st.tm_cell[..., TM_BCAST].sum()) > 0


@pytest.mark.parametrize("app,seed", [("widest", 1e9), ("reliable", 1.0)])
def test_max_apps_every_leaf_equal_to_jax_chunk_by_chunk(app, seed):
    st, _ = chunks_equal_jax(MAX_APP_KW, app, seed, weighted_increments())
    assert int(st.tm_cell.sum()) > 0
