"""Telemetry planes in the port, on the CPU, against the JAX engine: the
config rule (``telemetry`` accepted; ``tests/test_torch_state.py``
holds the knobs still refused), the planes' shapes, and with ``telemetry=True`` every state leaf, the three
planes included, equal to the JAX engine's after every chunk, on the
pinned 8x8 stream (``tests/data/pre_lanes_reference.json``) and on the
8x8 hub stream of ``tests/test_obs.py`` at ``lanes=1`` up to its
livelock; and a JAX state taken mid-increment, carried over with
``state_from_numpy``, running one chunk to the JAX engine's next state.
Exact: integer leaves equal, float leaves equal as bits.
``tests/test_torch_telemetry_lanes.py`` runs lanes, parking, rhizomes
and the max apps the same way.
"""
import json
import pathlib

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
from repro.core.state import init_state as j_init_state
from repro.graph.streams import hub_edges
from repro_torch.core import EngineConfig, StreamingEngine
from repro_torch.core.ingest import load_stream
from repro_torch.core.state import (TM_BCAST, TM_HOP, TM_L_BLOCK, TM_PARK,
                                    TM_UNPARK, init_state, state_from_numpy,
                                    state_to_numpy)
from repro_torch.graph.streams import StreamSpec, make_stream
from repro_torch.kernels.cca_cycle.ops import cca_cycle_chunk

ONE = np.float32(1.0).view(np.int32)
REF = json.loads((pathlib.Path(__file__).parent / "data"
                  / "pre_lanes_reference.json").read_text())
HUB_KW = dict(height=8, width=8, n_vertices=128, edge_cap=4, ghost_slots=48,
              queue_cap=20, chan_cap=16, futq_cap=4, io_stream_cap=2048,
              chunk=64, lanes=1)          # tests/test_obs.py::_hub_cfg


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


@pytest.mark.parametrize("lanes", [1, 3])
def test_planes_have_the_jax_shapes(lanes):
    """Full planes with telemetry on, the 1x1 dummies with it off, and
    ``state_from_numpy`` takes the JAX engine's state either way."""
    for on in (False, True):
        kw = dict(height=4, width=6, n_vertices=24, lanes=lanes,
                  telemetry=on)
        cfg = EngineConfig(**kw)
        st = init_state(cfg, device="cpu")
        jst = j_init_state(JConfig(**kw))
        for k in ("tm_cell", "tm_lane", "tm_hiw"):
            assert tuple(getattr(st, k).shape) == getattr(jst, k).shape, k
        arrays = {k: np.asarray(v) for k, v in jst._asdict().items()}
        assert_same_state(state_from_numpy(cfg, arrays, device="cpu"), jst)
    EngineConfig(telemetry=True).validate()


def test_pinned_stream_every_leaf_equal_to_jax_chunk_by_chunk():
    st, n = chunks_equal_jax(REF["cfg"], "bfs", 0.0,
                             make_stream(StreamSpec(**REF["spec"])))
    assert n == 5        # 48, 112 and 116 cycles in chunks of 64
    assert int(st.tm_cell[..., TM_HOP].sum()) == int(st.stat_hops)
    assert int(st.tm_lane[..., TM_L_BLOCK].sum()) > 0


def test_hub_lanes1_every_leaf_equal_to_jax_up_to_its_livelock():
    """The hub stream at ``lanes=1`` makes no progress from cycle 192 on
    and livelocks at cycle 704 (chunk 11): twelve chunks compared."""
    st, n = chunks_equal_jax(HUB_KW, "bfs", 0.0, [hub_stream()],
                             max_chunks=12)
    assert n == 12 and int(st.cycle) == 768
    assert int(st.tm_hiw[0, 0, 0]) >= int(st.aq_n[0, 0]) > 0   # the hub
    # nothing parks or broadcasts at lanes=1, rhizome_cap=1
    assert not st.tm_cell[..., [TM_PARK, TM_UNPARK, TM_BCAST]].any()


@pytest.mark.parametrize("lanes", [1, 2])
def test_mid_increment_jax_state_runs_on_to_the_jax_chunk(lanes):
    """A JAX state taken mid-increment with telemetry on (planes full),
    converted and run one chunk on the port's CPU path, equals the JAX
    engine's next chunk."""
    kw = dict(HUB_KW, lanes=lanes, telemetry=True)
    jeng = JEngine(JConfig(**kw), "bfs")
    jeng.seed(0, 0.0)
    jst, _ = j_load(jeng.cfg, jeng.state, hub_stream())
    jst = j_fresh(jst)
    jchunk = jax.jit(lambda s: run_to_quiescence_while(
        jeng.cfg, jeng.app, s, max_cycles=jeng.cfg.chunk))
    for _ in range(3):
        jst = jchunk(jst)
    assert int(np.asarray(jst.tm_cell).sum()) > 0
    cfg = EngineConfig(**kw)
    st = state_from_numpy(cfg, {k: np.asarray(v)
                                for k, v in jst._asdict().items()},
                          device="cpu")
    assert_same_state(st, jst, "converted")
    st, _ = cca_cycle_chunk(cfg, StreamingEngine(cfg, device="cpu").app, st)
    assert_same_state(st, jchunk(jst), "one chunk on")
