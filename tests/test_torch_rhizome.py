"""Rhizome vertex objects in the port, on the CPU, against the JAX engine:
the config rules of ``rhizome_cap``, the IO cells' choice of a rhizome
root (``io_stage``) on random states, ``seed`` writing every root, and the
hub streams of ``tests/test_rhizome.py::cfg_for`` for bfs, sssp and cc at
``rhizome_cap`` 1 and 4: values equal to the oracle, and at 4 every state
leaf equal to the JAX engine's after every chunk (the link protocol, the
secondary roots' activation and drain, the sibling broadcast) and
``vertex_object_stats`` equal to its.  Exact: integer leaves equal, float
leaves equal as bits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import EngineConfig as JConfig
from repro.core import StreamingEngine as JEngine
from repro.core.engine import _rc as j_rc
from repro.core.engine import quiescent as j_quiescent
from repro.core.engine import run_to_quiescence_while
from repro.core.ingest import io_stage as j_io_stage
from repro.core.ingest import load_stream as j_load
from repro.core.state import init_state as j_init_state
from repro_torch.core import EngineConfig, StreamingEngine
from repro_torch.core.alloc import rhizome_rcs
from repro_torch.core.engine import _rc
from repro_torch.core.ingest import io_stage, load_stream
from repro_torch.core.reference import bfs_levels, cc_labels, sssp_dists
from repro_torch.core.state import (init_state, state_from_numpy,
                                    state_to_numpy)
from repro_torch.graph.streams import hub_edges
from repro_torch.kernels.cca_cycle.ops import cca_cycle_chunk

ONE = np.float32(1.0).view(np.int32)


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


def cfg_kw(R, **kw):
    """``tests/test_rhizome.py::cfg_for``."""
    base = dict(height=8, width=8, n_vertices=64, edge_cap=4,
                ghost_slots=32, queue_cap=96, chan_cap=16, futq_cap=8,
                io_stream_cap=2048, chunk=128, rhizome_cap=R)
    base.update(kw)
    return base


@pytest.mark.parametrize("kw", [
    dict(height=4, width=4, n_vertices=16, rhizome_cap=2),
    dict(height=8, width=8, n_vertices=64, rhizome_cap=4, edge_cap=4),
    dict(height=4, width=4, n_vertices=16, rhizome_cap=16, queue_cap=64,
         futq_cap=4),
    dict(height=4, width=4, n_vertices=16, rhizome_cap=17),
    dict(height=4, width=4, n_vertices=16, rhizome_cap=0),
    dict(height=3, width=4, n_vertices=12, rhizome_cap=5, queue_cap=64),
    dict(height=4, width=4, n_vertices=16, rhizome_cap=2, edge_cap=2,
         futq_cap=8),
    dict(height=4, width=4, n_vertices=16, rhizome_cap=4, queue_cap=16),
    dict(height=4, width=4, n_vertices=16, lanes=2, park_cap=-1),
], ids=["R2", "R4", "R16", "R17", "R0", "collide", "futq", "queue", "park"])
def test_config_rules_match_jax(kw):
    """A config the JAX engine accepts validates in the port; one it
    refuses raises ``ValueError``."""
    try:
        JConfig(**kw).validate()
        jax_ok = True
    except (AssertionError, ZeroDivisionError):
        jax_ok = False
    if jax_ok:
        EngineConfig(**kw).validate()
    else:
        with pytest.raises(ValueError):
            EngineConfig(**kw).validate()


@pytest.mark.parametrize("R", [1, 2, 3, 4])
def test_io_root_choice_matches_jax(R):
    """Random streams, cursors and row-0 queue counts: the insert goes to
    the same root (the least distance plus rotation preference, the lowest
    k on a tie) through the same lane, or stalls the same way."""
    kw = cfg_kw(R, lanes=2, queue_cap=24, chan_cap=8, futq_cap=4)
    cfg, jcfg = EngineConfig(**kw), JConfig(**kw)
    rng = np.random.default_rng(R)
    a = state_to_numpy(init_state(cfg, device="cpu"))
    for t in range(2):
        IO, n = cfg.io_cells, 40
        a["io_edges"][:, :n, 0] = rng.integers(0, cfg.n_vertices, (IO, n))
        a["io_edges"][:, :n, 1] = rng.integers(0, cfg.n_vertices, (IO, n))
        a["io_edges"][:, :n, 2] = ONE
        a["io_n"] = rng.integers(0, n, IO).astype(np.int32)
        a["io_pos"] = (a["io_n"] * rng.random(IO)).astype(np.int32)
        a["aq_n"][0] = rng.integers(0, cfg.queue_cap - 1, cfg.width)
        a["ch_n"][0] = rng.integers(0, cfg.lane_capacity + 1,
                                    (cfg.width, 4, cfg.lanes))
        st = io_stage(cfg, state_from_numpy(cfg, a, device="cpu"),
                      *_rc(cfg, "cpu"))
        jst = j_init_state(jcfg)._replace(
            **{k: jnp.asarray(v) for k, v in a.items()})
        jst = j_io_stage(jcfg, jst, *j_rc(jcfg))
        assert_same_state(st, jst, f"round {t}")
        assert int((st.io_pos != torch.from_numpy(a["io_pos"])).sum()) > 0


def test_seed_writes_every_root():
    cfg = EngineConfig(**cfg_kw(4))
    eng = StreamingEngine(cfg, "bfs", device="cpu")
    eng.seed(5, 0.0)
    r, c, s = rhizome_rcs(cfg, 5, np.arange(4))
    assert len({(int(a), int(b)) for a, b in zip(r, c)}) == 4
    assert (eng.state.vals[r, c, s, 0] == 0).all()
    assert int((eng.state.vals[..., 0] == 0).sum()) == 4
    assert eng.values()[5] == 0 and (np.delete(eng.values(), 5) == 1e9).all()


def hub_case(app):
    """The hub stream and seeds of ``tests/test_rhizome.py`` for ``app``:
    ``(edges, seed function, oracle values)``."""
    n, deg = 64, 40
    if app == "bfs":
        e2 = hub_edges(n, hub=0, degree=deg, seed=3)
        w = np.ones(len(e2), np.float32)
    elif app == "sssp":
        rng = np.random.default_rng(5)
        e2 = hub_edges(n, hub=0, degree=deg, seed=5)
        w = rng.integers(1, 9, len(e2)).astype(np.float32)
    else:
        e2 = hub_edges(n, hub=0, degree=deg, seed=7)
        e2 = np.concatenate([e2, e2[:, ::-1]], axis=0)
        w = np.ones(len(e2), np.float32)
    edges = np.concatenate([e2.astype(np.int32),
                            w.view(np.int32).reshape(-1, 1)], axis=1)
    if app == "cc":
        def seed(eng):
            for v in range(n):
                eng.seed(v, float(v))
        want = cc_labels(n, e2)
    else:
        def seed(eng):
            eng.seed(0, 0.0)
        want = (bfs_levels(n, edges, 0) if app == "bfs"
                else sssp_dists(n, e2, w, 0))
    return edges, seed, want


@pytest.mark.parametrize("app", ["bfs", "sssp", "cc"])
def test_hub_chain_values_equal_the_oracle(app):
    """``rhizome_cap=1``, the serial ghost chain."""
    edges, seed, want = hub_case(app)
    eng = StreamingEngine(EngineConfig(**cfg_kw(1)), app, device="cpu")
    seed(eng)
    eng.run_increment(edges, max_cycles=500_000)
    np.testing.assert_array_equal(eng.values(64), want)
    assert eng.vertex_object_stats()["rhizomes"] == 0


@pytest.mark.parametrize("app", ["bfs", "sssp", "cc"])
def test_hub_rhizomes_every_leaf_equal_to_jax_chunk_by_chunk(app):
    """``rhizome_cap=4``: both engines' chunk runners (the JAX jnp
    while-loop capped at ``chunk`` cycles, the port's ``cca_cycle_chunk``)
    from the same seeded state, every leaf after every chunk; then values
    equal to the oracle and ``vertex_object_stats`` to JAX's."""
    edges, seed, want = hub_case(app)
    kw = cfg_kw(4)
    jeng = JEngine(JConfig(**kw), app)
    seed(jeng)
    jst, _ = j_load(jeng.cfg, jeng.state, edges)
    z = jnp.int32(0)
    jst = jst._replace(stat_hops=z, stat_exec=z, stat_stall=z, stat_allocs=z)
    jchunk = jax.jit(lambda s: run_to_quiescence_while(
        jeng.cfg, jeng.app, s, max_cycles=jeng.cfg.chunk))
    eng = StreamingEngine(EngineConfig(**kw), app, device="cpu")
    seed(eng)
    assert_same_state(eng.state, jeng.state, "seeded")
    st, _ = load_stream(eng.cfg, eng.state, edges)
    zt = torch.zeros((), dtype=torch.int32)
    st = st._replace(stat_hops=zt, stat_exec=zt.clone(),
                     stat_stall=zt.clone(), stat_allocs=zt.clone())
    for i in range(100):
        jst = jchunk(jst)
        st, qr = cca_cycle_chunk(eng.cfg, eng.app, st)
        assert_same_state(st, jst, f"chunk {i}")
        assert bool(qr[0]) == bool(j_quiescent(jst))
        if qr[0]:
            break
    eng.state, jeng.state = st, jst
    np.testing.assert_array_equal(eng.values(64), want)
    np.testing.assert_array_equal(eng.values(64), jeng.values(64))
    stats = eng.vertex_object_stats()
    assert stats == jeng.vertex_object_stats()
    assert stats["multi_root_vertices"] >= 1 and stats["max_fanout"] > 1
