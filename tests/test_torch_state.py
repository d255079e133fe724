"""The PyTorch port against the JAX package: state layout, helpers, host
copies (config, streams, oracles), isolation and device defaults.

Inputs come from numpy seeds; states cross between the packages as numpy
(``state_to_numpy`` / ``state_from_numpy``).  Tolerance is exact: integer
leaves equal, float32 leaves equal as bits.
"""
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import reference as jref
from repro.core import rings as jrings
from repro.core.alloc import choose_alloc_cell as j_choose
from repro.core.config import EngineConfig as JConfig
from repro.core.ingest import load_stream as j_load
from repro.core.routing import yx_target_buffer as j_yx
from repro.core.state import init_state as j_init
from repro.graph.streams import StreamSpec as JSpec
from repro.graph.streams import make_stream as j_stream
from repro_torch.core import rings
from repro_torch.core import reference as tref
from repro_torch.core.alloc import choose_alloc_cell
from repro_torch.core.config import EngineConfig
from repro_torch.core.engine import StreamingEngine
from repro_torch.core.ingest import load_stream
from repro_torch.core.msg import f2i, i2f, make_msg
from repro_torch.core.routing import yx_target_buffer
from repro_torch.core.state import (init_state, state_from_numpy,
                                    state_to_numpy)
from repro_torch.graph.streams import StreamSpec, make_stream
from repro_torch.resilience import FaultPlan

DATA = pathlib.Path(__file__).parent / "data"
PINNED = json.loads((DATA / "pre_lanes_reference.json").read_text())
PKG = pathlib.Path(__file__).parents[1] / "src" / "repro_torch"
FINGERPRINT = json.loads((PKG / "data" / "fingerprint_32x32.json").read_text())
PAPER = dict(height=32, width=32, n_vertices=50_000, edge_cap=8,
             ghost_slots=244, queue_cap=64, chan_cap=16, futq_cap=16,
             io_stream_cap=2 ** 21, chunk=512)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain version runs thousands of tiny ops per cycle: one
    intra-op thread is faster, and leaves the cores to the other test
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_same(a: dict, b: dict):
    """Leaf-for-leaf equality of two ``{name: numpy array}`` states:
    dtype, shape, and bits."""
    assert a.keys() == b.keys()
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, (k, x.dtype,
                                                          y.dtype)
        if x.dtype == np.float32:
            x, y = x.view(np.int32), y.view(np.int32)
        np.testing.assert_array_equal(x, y, err_msg=f"leaf {k!r}")


def test_init_state_matches_jax_pinned():
    cfg = PINNED["cfg"]
    want = {k: np.asarray(v) for k, v in j_init(JConfig(**cfg))._asdict()
            .items()}
    got = state_to_numpy(init_state(EngineConfig(**cfg), device="cpu"))
    assert_same(got, want)
    # and back: the numpy exchange format round-trips into the port
    back = state_to_numpy(state_from_numpy(EngineConfig(**cfg), want,
                                           device="cpu"))
    assert_same(back, want)


def test_init_state_shapes_paper_config():
    """The paper config's layout (85.6 MiB of mutable state plus the
    768 MiB stream buffer), compared without allocating either side."""
    want = jax.eval_shape(lambda: j_init(JConfig(**PAPER)))._asdict()
    got = init_state(EngineConfig(**PAPER), device="meta")._asdict()
    assert want.keys() == got.keys()
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert torch.empty((), dtype=got[k].dtype).numpy().dtype \
            == want[k].dtype, k
    assert got["fq"].shape == (32, 32, 293, 16, 3)


def test_state_from_numpy_checks_layout():
    cfg = EngineConfig(**PINNED["cfg"])
    arrays = state_to_numpy(init_state(cfg, device="cpu"))
    arrays["aq_n"] = arrays["aq_n"].astype(np.int64)
    with pytest.raises(ValueError, match="aq_n"):
        state_from_numpy(cfg, arrays, device="cpu")


def test_message_and_ring_helpers_match_jax():
    rng = np.random.default_rng(0)
    f = rng.standard_normal(64).astype(np.float32)
    f[:3] = [0.0, -0.0, 1e9]
    bits = f2i(torch.from_numpy(f))
    np.testing.assert_array_equal(bits.numpy(), f.view(np.int32))
    np.testing.assert_array_equal(i2f(bits).numpy().view(np.int32),
                                  f.view(np.int32))
    m = make_msg(3, torch.arange(4, dtype=torch.int32), 7)
    assert m.dtype == torch.int32 and m.tolist()[2] == [3, 2, 7, 0, 0]
    # rings: push / peek / pop over a random batch of rings
    cap = 6
    buf = rng.integers(-50, 50, (5, 4, cap, 5)).astype(np.int32)
    cnt = rng.integers(0, cap, (5, 4)).astype(np.int32)
    head = rng.integers(0, cap, (5, 4)).astype(np.int32)
    msg = rng.integers(-50, 50, (5, 4, 5)).astype(np.int32)
    mask = rng.random((5, 4)) < 0.5
    jb, jc = jrings.ring_push(jnp.asarray(buf), jnp.asarray(cnt),
                              jnp.asarray(head), jnp.asarray(msg),
                              jnp.asarray(mask))
    tb, tc = rings.ring_push(*map(torch.from_numpy, (buf, cnt, head, msg,
                                                     mask)))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(
        rings.ring_peek(torch.from_numpy(buf), torch.from_numpy(head)).numpy(),
        np.asarray(jrings.ring_peek(jnp.asarray(buf), jnp.asarray(head))))
    jn, jh = jrings.ring_pop(jnp.asarray(cnt), jnp.asarray(head), cap,
                             jnp.asarray(mask))
    tn, th = rings.ring_pop(torch.from_numpy(cnt), torch.from_numpy(head),
                            cap, torch.from_numpy(mask))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))


def test_routing_and_alloc_helpers_match_jax():
    """Floor division on negative addresses, the YX next buffer and the
    vicinity allocator, on random (also negative) inputs."""
    rng = np.random.default_rng(1)
    jcfg, cfg = JConfig(height=5, width=7), EngineConfig(height=5, width=7)
    dst = rng.integers(-40, 40, (5, 7)).astype(np.int32)
    rows = np.repeat(np.arange(5, dtype=np.int32)[:, None], 7, axis=1)
    cols = np.repeat(np.arange(7, dtype=np.int32)[None, :], 5, axis=0)
    np.testing.assert_array_equal(
        yx_target_buffer(cfg, torch.from_numpy(dst), torch.from_numpy(rows),
                         torch.from_numpy(cols)).numpy(),
        np.asarray(j_yx(jcfg, jnp.asarray(dst), jnp.asarray(rows),
                        jnp.asarray(cols))))
    arot = rng.integers(0, 100, (5, 7)).astype(np.int32)
    np.testing.assert_array_equal(
        choose_alloc_cell(cfg, torch.from_numpy(rows),
                          torch.from_numpy(cols),
                          torch.from_numpy(arot)).numpy(),
        np.asarray(j_choose(jcfg, jnp.asarray(rows), jnp.asarray(cols),
                            jnp.asarray(arot))))


@pytest.mark.parametrize("limit", [None, 11])
def test_load_stream_matches_jax(limit):
    """Round-robin placement, residue compaction, capacity spill and the
    admission limit: the same io leaves and the same spill."""
    kw = dict(height=4, width=4, n_vertices=32, ghost_slots=8,
              io_stream_cap=9)
    rng = np.random.default_rng(2)
    edges = rng.integers(0, 32, (50, 3)).astype(np.int32)
    jst, _ = j_load(JConfig(**kw), j_init(JConfig(**kw)), edges[:30])
    arrays = {k: np.asarray(v) for k, v in jst._asdict().items()}
    arrays["io_pos"] = np.minimum(arrays["io_n"], [0, 1, 2, 3]).astype(
        np.int32)
    jst = jst._replace(io_pos=jnp.asarray(arrays["io_pos"]))
    jst, jspill = j_load(JConfig(**kw), jst, edges[30:], limit=limit)
    st = state_from_numpy(EngineConfig(**kw), arrays, device="cpu")
    st, spill = load_stream(EngineConfig(**kw), st, edges[30:], limit=limit)
    np.testing.assert_array_equal(spill, jspill)
    for k in ("io_edges", "io_n", "io_pos"):
        np.testing.assert_array_equal(getattr(st, k).numpy(),
                                      np.asarray(getattr(jst, k)), err_msg=k)


@pytest.mark.parametrize("knob", [
    dict(telemetry=True, ingest_guard=True),
    dict(faults=FaultPlan(), qbatch=2), dict(ingest_guard=True),
    dict(qbatch=2),
    dict(n_vals=2), dict(n_io_cells=3)])
def test_validate_rejects_unported_knobs(knob):
    with pytest.raises(NotImplementedError):
        EngineConfig(height=4, width=4, n_vertices=16, **knob).validate()


def test_engine_rejects_unported_apps_and_options():
    cfg = EngineConfig(height=4, width=4, n_vertices=16, ghost_slots=8)
    with pytest.raises(NotImplementedError):
        StreamingEngine(cfg, "pagerank", device="cpu")
    eng = StreamingEngine(cfg, "bfs", device="cpu")
    edges = np.zeros((0, 3), np.int32)
    for kw in (dict(recover=object()), dict(ckpt=object())):
        with pytest.raises(NotImplementedError):
            eng.run_increment(edges, **kw)


def test_device_defaults_to_cuda(monkeypatch):
    """No device argument means the card: without one the engine raises
    instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = EngineConfig(height=4, width=4, n_vertices=16, ghost_slots=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamingEngine(cfg, "bfs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_state(cfg)


def test_port_imports_nothing_of_jax_or_repro():
    code = ("import sys, repro_torch, repro_torch.core, "
            "repro_torch.core.reference, repro_torch.graph.streams, "
            "repro_torch.kernels.cca_cycle.ops, repro_torch.kernels._build, "
            "repro_torch.kernels.spmm.ops, "
            "repro_torch.kernels.embedding_bag.ops, "
            "repro_torch.graph.segment_ops, repro_torch.models.common, "
            "repro_torch.models.gnn, repro_torch.models.dlrm, "
            "repro_torch.data.graphs, repro_torch.data.pipeline, "
            "repro_torch.configs.base, repro_torch.configs.gnn_archs, "
            "repro_torch.configs.recsys_archs, "
            "repro_torch.kernels.flash_attention.ops, "
            "repro_torch.models.transformer, repro_torch.configs.lm_archs, "
            "repro_torch.obs, repro_torch.obs.metrics, "
            "repro_torch.launch.serve, repro_torch.launch.paper_experiments; "
            "bad = [m for m in sys.modules if m == 'jax' or m == 'repro' "
            "or m.startswith(('jax.', 'repro.'))]; print(bad)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         env=dict(os.environ,
                                  PYTHONPATH=str(PKG.parent))).stdout
    assert out.strip() == "[]"
    for f in PKG.rglob("*.py"):
        text = f.read_text()
        for bad in ("import jax", "from jax", "from repro.", "import repro.",
                    "from repro import"):
            assert bad not in text, (f, bad)


@pytest.mark.parametrize("spec", [
    dict(n_vertices=300, n_edges=2000, increments=4, seed=3),
    dict(n_vertices=300, n_edges=1500, increments=5, sampling="snowball",
         seed=5),
    dict(n_vertices=256, n_edges=1200, increments=3, kind="rmat",
         symmetric=True, seed=8)])
def test_make_stream_matches_jax(spec):
    got, want = make_stream(StreamSpec(**spec)), j_stream(JSpec(**spec))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_oracles_match_jax_reference():
    rng = np.random.default_rng(4)
    n = 120
    edges = rng.integers(0, n, (500, 2)).astype(np.int32)
    w = rng.integers(1, 9, 500).astype(np.float32) / 4
    for sym in (False, True):
        np.testing.assert_array_equal(
            tref.bfs_levels(n, edges, 3, symmetric=sym),
            jref.bfs_levels(n, edges, 3, symmetric=sym))
    np.testing.assert_array_equal(tref.sssp_dists(n, edges, w, 3),
                                  jref.sssp_dists(n, edges, w, 3))
    np.testing.assert_array_equal(tref.cc_labels(n, edges[:90]),
                                  jref.cc_labels(n, edges[:90]))


def test_fingerprint_fixture_stream_sizes():
    """The 32x32 fixture names a stream the port's generator rebuilds
    increment for increment."""
    incs = make_stream(StreamSpec(**FINGERPRINT["spec"]))
    assert [len(e) for e in incs] == \
        [r["edges"] for r in FINGERPRINT["increments"]]
    cfg = EngineConfig(**{k: v for k, v in FINGERPRINT["cfg"].items()
                          if k in EngineConfig.__dataclass_fields__})
    assert (cfg.height, cfg.width, cfg.n_vertices) == (32, 32, 2000)
    assert len(FINGERPRINT["values"]) == cfg.n_vertices
