"""The paper experiments' app, allocator and host models on the CPU: the
ingestion-only app and the random allocator equal the JAX engine
(per-increment counters, values, ``vertex_object_stats`` and every state
leaf), the port's random-allocator hash equals JAX's uint32 one
elementwise, the port's copies of ``core/energy.py`` and
``configs/cca_paper.py`` equal their originals, and the ``engine_ci``
stream's counters through ``launch/paper_experiments.bench_engine`` equal
``results/bench_engine.json``.
"""
import dataclasses
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import cca_paper as j_cca_paper
from repro.core import EngineConfig as JConfig
from repro.core import StreamingEngine as JEngine
from repro.core import energy as j_energy
from repro.core.alloc import choose_alloc_cell as j_choose
from repro_torch.configs import cca_paper
from repro_torch.core import EngineConfig, StreamingEngine, energy
from repro_torch.core.alloc import choose_alloc_cell
from repro_torch.core.state import state_to_numpy
from repro_torch.graph.streams import StreamSpec, make_stream
from repro_torch.launch import paper_experiments as pe

ROOT = pathlib.Path(__file__).resolve().parents[1]
SMALL = dict(height=8, width=8, n_vertices=128, edge_cap=4, ghost_slots=32,
             queue_cap=32, chan_cap=8, futq_cap=8, io_stream_cap=2048,
             chunk=64)
SPEC = dict(n_vertices=128, n_edges=768, increments=3, seed=11)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain version runs thousands of tiny ops per cycle: one
    intra-op thread is faster, and leaves the cores to the other test
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("app,allocator", [("ingest_only", "vicinity"),
                                           ("bfs", "random"),
                                           ("ingest_only", "random")])
def test_app_and_allocator_match_jax(app, allocator):
    kw = dict(SMALL, allocator=allocator)
    incs = make_stream(StreamSpec(**SPEC))
    jeng = JEngine(JConfig(**kw), app)
    eng = StreamingEngine(EngineConfig(**kw), app, device="cpu")
    if app == "bfs":
        jeng.seed(0, 0.0)
        eng.seed(0, 0.0)
    for i, e in enumerate(incs):
        jr = jeng.run_increment(e, max_cycles=500_000)
        r = eng.run_increment(e, max_cycles=500_000)
        assert (r.cycles, r.hops, r.execs, r.stalls, r.allocs) == \
            (jr.cycles, jr.hops, jr.execs, jr.stalls, jr.allocs), i
    assert r.allocs > 0 or allocator == "vicinity"
    np.testing.assert_array_equal(eng.values(), jeng.values())
    if app == "ingest_only":
        assert (eng.values() == np.float32(1e9)).all()
    assert eng.vertex_object_stats() == jeng.vertex_object_stats()
    got = state_to_numpy(eng.state)
    for k, v in jeng.state._asdict().items():
        a, b = got[k], np.asarray(v)
        if a.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("hw", [(5, 7), (8, 8), (32, 32)])
def test_random_alloc_cell_matches_jax(hw):
    """Elementwise over every cell, with allocation counters small, near
    2**31 and near 2**32 (int32 bit patterns, negative past 2**31)."""
    H, W = hw
    jcfg = JConfig(height=H, width=W, allocator="random")
    cfg = EngineConfig(height=H, width=W, allocator="random")
    rows = np.repeat(np.arange(H, dtype=np.int32)[:, None], W, axis=1)
    cols = np.repeat(np.arange(W, dtype=np.int32)[None, :], H, axis=0)
    rng = np.random.default_rng(H * W)
    for base in (0, 2 ** 31 - 40, 2 ** 32 - 40, None):
        if base is None:
            arot = rng.integers(-2 ** 31, 2 ** 31, (H, W))
        else:
            arot = base + rng.integers(0, 80, (H, W))
        arot = arot.astype(np.int64).astype(np.uint32).view(np.int32)
        got = choose_alloc_cell(cfg, torch.from_numpy(rows),
                                torch.from_numpy(cols),
                                torch.from_numpy(arot))
        want = np.asarray(j_choose(jcfg, jnp.asarray(rows),
                                   jnp.asarray(cols), jnp.asarray(arot)))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(base))
        assert (want >= 0).all() and (want < H * W).all()


def test_energy_copy_equals_original():
    assert energy.CLOCK_HZ == j_energy.CLOCK_HZ
    assert dataclasses.asdict(energy.DEFAULT) == \
        dataclasses.asdict(j_energy.DEFAULT)
    assert [f.name for f in dataclasses.fields(energy.EnergyModel)] == \
        [f.name for f in dataclasses.fields(j_energy.EnergyModel)]
    rng = np.random.default_rng(5)
    for _ in range(20):
        hops, execs, allocs, injects, cycles = (
            int(x) for x in rng.integers(0, 10 ** 7, 5))
        kw = dict(hops=hops, execs=execs, allocs=allocs, injects=injects)
        assert energy.DEFAULT.estimate_uj(**kw) == \
            j_energy.DEFAULT.estimate_uj(**kw)
        assert energy.EnergyModel.cycles_to_us(cycles) == \
            j_energy.EnergyModel.cycles_to_us(cycles)


def _cfg_dict(cfg):
    d = dataclasses.asdict(cfg)
    d.pop("backend", None)      # the port's config has no backend field
    return d


def test_cca_paper_copy_equals_original():
    assert _cfg_dict(cca_paper.CCA_32) == _cfg_dict(j_cca_paper.CCA_32)
    assert _cfg_dict(cca_paper._smoke()) == _cfg_dict(j_cca_paper._smoke())
    shapes, jshapes = cca_paper.cca_shapes(), j_cca_paper.cca_shapes()
    assert [(s.name, s.kind, s.dims) for s in shapes] == \
        [(s.name, s.kind, s.dims) for s in jshapes]
    for s, js in zip(shapes, jshapes):
        assert _cfg_dict(cca_paper.engine_config_for(s)) == \
            _cfg_dict(j_cca_paper.engine_config_for(js))
    (b,), (jb,) = cca_paper.bundles(), j_cca_paper.bundles()
    assert (b.arch_id, b.family) == (jb.arch_id, jb.family)
    assert _cfg_dict(b.config) == _cfg_dict(jb.config)
    assert [s.name for s in b.shapes] == [s.name for s in jb.shapes]
    assert _cfg_dict(b.smoke()) == _cfg_dict(jb.smoke())
    cca_paper.CCA_32.validate()


def test_engine_ci_counters_equal_bench_engine_json():
    """``benchmarks/engine_throughput.py``'s ci stream: the cycle counts
    the JAX package committed in ``results/bench_engine.json``."""
    want = json.loads((ROOT / "results" / "bench_engine.json").read_text())
    want = want["engine_ci"]["backends"]["jnp"]
    got = pe.bench_engine("ci", device="cpu")
    assert {k: got[k] for k in ("cycles", "execs", "hops", "total_cycles")} \
        == {k: want[k] for k in ("cycles", "execs", "hops", "total_cycles")}
    assert "wall_s" not in got           # no wall time off the card
