"""``repro_torch.launch.paper_experiments`` on the CPU: at a tiny scale its
``run_stream`` gives the rows of the JAX package's
``benchmarks/paper_experiments.py::run_stream`` on the same stream and
config, and serves them again from its cache.  The skew and lanes
benchmarks: ``tests/test_torch_skew_runner.py``.
"""
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.launch import paper_experiments as pe

ROOT = pathlib.Path(__file__).resolve().parents[1]
TINY = dict(n_vertices=16, n_edges=40)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain version runs thousands of tiny ops per cycle: one
    intra-op thread is faster, and leaves the cores to the other test
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jax_experiments(monkeypatch):
    """The JAX package's experiment module, with the tiny scale added and
    a cache of its own."""
    monkeypatch.syspath_prepend(str(ROOT))
    import benchmarks.paper_experiments as jpe
    monkeypatch.setitem(jpe.SCALES, "tiny", TINY)
    monkeypatch.setattr(jpe, "_CACHE", {})
    return jpe


def test_run_stream_rows_equal_jax(jax_experiments, monkeypatch):
    monkeypatch.setattr(pe, "_CACHE", {})
    want, jeng = jax_experiments.run_stream("bfs", "edge", "tiny")
    got, eng = pe.run_stream("bfs", "edge", TINY, verify=True, device="cpu")
    assert len(got) == len(want) == 10
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            if k == "active":
                np.testing.assert_array_equal(g[k], np.asarray(w[k]))
            else:
                assert g[k] == w[k], k
    assert eng.cfg.allocator == jeng.cfg.allocator == "vicinity"
    np.testing.assert_array_equal(eng.values(), jeng.values())
    assert eng.vertex_object_stats() == jeng.vertex_object_stats()
    # the cache serves the same run again
    assert pe.run_stream("bfs", "edge", TINY, device="cpu")[1] is eng


def test_runner_refuses_the_cpu_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pe.main(["--scale", "ci", "--only", "energy"])
