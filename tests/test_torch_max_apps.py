"""The max-monotone apps ``widest`` (maximin bottleneck) and ``reliable``
(max-product) in the port, on the CPU, against the JAX engine: an 8x8
weighted stream with weights in (0, 1] drawn by numpy, two increments, at
``rhizome_cap`` 1 (one lane) and 2 (two lanes): every state leaf equal to
the JAX engine's after every chunk, and ``values()`` (the max over a
vertex's roots) equal to its.  Exact: integer leaves equal, float leaves
equal as bits (``reliable`` multiplies once per edge in IEEE f32).
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
from repro_torch.core import EngineConfig, StreamingEngine
from repro_torch.core.apps import APPS
from repro_torch.core.ingest import load_stream
from repro_torch.core.state import state_to_numpy
from repro_torch.kernels.cca_cycle.ops import cca_cycle_chunk

SEEDS = {"widest": 1e9, "reliable": 1.0}


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


def weighted_increments(seed=1, n=64, m=320):
    """Two increments of random directed edges over ``n`` vertices, each
    with a weight drawn uniformly from (0, 1]."""
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, m), rng.integers(0, n, m)
    w = (1.0 - rng.random(m)).astype(np.float32)           # (0, 1]
    e = np.stack([src, dst, w.view(np.int32)], 1).astype(np.int32)
    return [e[: m // 2], e[m // 2:]]


def test_max_apps_flip_the_min_knobs():
    for name in ("widest", "reliable"):
        app = APPS[name]
        assert app.init_val == app.fwd_neutral == 0.0
        assert app.combine is np.maximum and app.fwd_merge is torch.maximum
    v, w = torch.tensor([0.5, 0.25]), torch.tensor([0.75, 0.125])
    assert APPS["widest"].edge_value(v, w).tolist() == [0.5, 0.125]
    assert APPS["reliable"].edge_value(v, w).tolist() == [0.375, 0.03125]


@pytest.mark.parametrize("R,lanes", [(1, 1), (2, 2)])
@pytest.mark.parametrize("app", ["widest", "reliable"])
def test_max_app_every_leaf_equal_to_jax_chunk_by_chunk(app, R, lanes):
    kw = dict(height=8, width=8, n_vertices=64, edge_cap=4, ghost_slots=32,
              queue_cap=48, chan_cap=16, futq_cap=4, io_stream_cap=2048,
              chunk=64, rhizome_cap=R, lanes=lanes)
    jeng = JEngine(JConfig(**kw), app)
    jeng.seed(0, SEEDS[app])
    jchunk = jax.jit(lambda s: run_to_quiescence_while(
        jeng.cfg, jeng.app, s, max_cycles=jeng.cfg.chunk))
    eng = StreamingEngine(EngineConfig(**kw), app, device="cpu")
    eng.seed(0, SEEDS[app])
    jst, st = jeng.state, eng.state
    assert_same_state(st, jst, "seeded")
    z, zt = jnp.int32(0), torch.zeros((), dtype=torch.int32)
    for k, e in enumerate(weighted_increments()):
        jst, _ = j_load(jeng.cfg, jst, e)
        jst = jst._replace(stat_hops=z, stat_exec=z, stat_stall=z,
                           stat_allocs=z)
        st, _ = load_stream(eng.cfg, st, e)
        st = st._replace(stat_hops=zt.clone(), stat_exec=zt.clone(),
                         stat_stall=zt.clone(), stat_allocs=zt.clone())
        for i in range(200):
            jst = jchunk(jst)
            st, qr = cca_cycle_chunk(eng.cfg, eng.app, st)
            assert_same_state(st, jst, f"increment {k} chunk {i}")
            assert bool(qr[0]) == bool(j_quiescent(jst))
            if qr[0]:
                break
    eng.state, jeng.state = st, jst
    got = eng.values()
    np.testing.assert_array_equal(got.view(np.int32),
                                  jeng.values().view(np.int32))
    # the diffusion reached vertices beyond the source, below its value
    assert ((got > 0) & (got < SEEDS[app])).sum() > 10
    if R > 1:
        assert eng.vertex_object_stats() == jeng.vertex_object_stats()
