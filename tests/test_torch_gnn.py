"""The port's GNN zoo against the JAX package, on the CPU.

Graphs come from both packages' ``build_graph`` with one numpy seed (and
must be equal); parameters come from the JAX package's
``init_gnn_params`` and are carried across as numpy.  The forwards sum in
another order than XLA's and compound that over their layers, so outputs
are held to 1e-4 relative to max(1, max |ref|).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gnn_archs as jarchs
from repro.configs.base import shape as jshape
from repro.data import graphs as jgraphs
from repro.models import gnn as jgnn
from repro_torch.configs import gnn_archs
from repro_torch.configs.base import shape
from repro_torch.data import graphs
from repro_torch.graph.segment_ops import scatter_sum
from repro_torch.kernels.spmm import ops
from repro_torch.models import gnn

TOL = 1e-4
CPU = torch.device("cpu")
KINDS = ["gcn", "gatedgcn", "meshgraphnet", "graphcast"]
ARCH = {"gcn": "GCN_CORA", "gatedgcn": "GATEDGCN",
        "meshgraphnet": "MESHGRAPHNET", "graphcast": "GRAPHCAST"}
TINY = dict(n_nodes=60, n_edges=300, d_feat=8)


def close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(
        got, want, rtol=tol, atol=tol * max(1.0, np.abs(want).max()))


def configs(kind):
    """(JAX smoke config, port smoke config) of one architecture."""
    j = jarchs._smoke(getattr(jarchs, ARCH[kind]))
    t = gnn_archs._smoke(getattr(gnn_archs, ARCH[kind]))
    assert dataclasses.asdict(t) == {**dataclasses.asdict(j),
                                     "compute_dtype": torch.float32}
    return j, t


def jax_params(cfg, seed=0):
    return jax.tree.map(np.asarray, jgnn.init_gnn_params(
        cfg, jax.random.PRNGKey(seed)))


def graphs_of(j_cfg, t_cfg, spec_kw, kind="gnn_full", seed=0):
    jg = jgraphs.build_graph(j_cfg, jshape("t", kind, **spec_kw),
                             np.random.default_rng(seed))
    tg = graphs.build_graph(t_cfg, shape("t", kind, **spec_kw),
                            np.random.default_rng(seed), device=CPU)
    return jg, tg


@pytest.mark.parametrize("kind,spec_kw", [
    ("gnn_full", TINY),
    ("gnn_batched", dict(n_nodes=7, n_edges=12, batch=5, d_feat=3)),
    ("gnn_minibatch", dict(n_nodes=500, n_edges=4000, batch_nodes=8,
                           fanout=(3, 2), d_feat=4)),
])
@pytest.mark.parametrize("model", ["gcn", "graphcast"])
def test_build_graph_equals_jax(kind, spec_kw, model):
    j_cfg, t_cfg = configs(model)
    jg, tg = graphs_of(j_cfg, t_cfg, spec_kw, kind, seed=3)
    for name in jgnn.Graph._fields:
        a, b = getattr(jg, name), getattr(tg, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert b.numpy().dtype == np.asarray(a).dtype, name
            np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                          err_msg=name)
    assert graphs.sampled_subgraph_sizes(dict(batch_nodes=1024,
                                              fanout=(15, 10))) == \
        jgraphs.sampled_subgraph_sizes(dict(batch_nodes=1024,
                                            fanout=(15, 10)))
    assert graphs.graphcast_sizes(t_cfg, 99) == \
        jgraphs.graphcast_sizes(j_cfg, 99)


@pytest.mark.parametrize("kind", KINDS)
def test_forward_matches_jax(kind):
    j_cfg, t_cfg = configs(kind)
    jg, tg = graphs_of(j_cfg, t_cfg, TINY)
    p = jax_params(j_cfg)
    want = jgnn.gnn_forward(j_cfg, p, jg)
    got = gnn.gnn_forward(t_cfg, gnn.gnn_params_from_numpy(t_cfg, p, CPU),
                          tg)
    close(got, want)
    # the nn.Module form computes the same function
    model = gnn.GNN.from_numpy(t_cfg, p, device=CPU)
    torch.testing.assert_close(model(tg), got, rtol=0, atol=0)
    assert sum(q.numel() for q in model.parameters()) == t_cfg.n_params() \
        == j_cfg.n_params()


@pytest.mark.parametrize("kind", ["gcn", "gatedgcn", "meshgraphnet"])
def test_unsorted_edges_and_edge_features(kind):
    """An edge set in any order, with edge features, gives JAX's output:
    the forward sorts it (and permutes the features) once."""
    j_cfg, t_cfg = configs(kind)
    j_cfg = dataclasses.replace(j_cfg, d_edge_in=3)
    t_cfg = dataclasses.replace(t_cfg, d_edge_in=3)
    rng = np.random.default_rng(9)
    n, e = 50, 400
    ei = rng.integers(0, n, (2, e)).astype(np.int32)
    x = rng.standard_normal((n, 8)).astype(np.float32)
    ef = rng.standard_normal((e, 3)).astype(np.float32)
    assert (np.diff(ei[1]) < 0).any()
    p = jax_params(j_cfg, seed=1)
    want = jgnn.gnn_forward(j_cfg, p, jgnn.Graph(
        jnp.asarray(x), jnp.asarray(ei), jnp.asarray(ef)))
    tg = gnn.Graph(torch.from_numpy(x), torch.from_numpy(ei).long(),
                   torch.from_numpy(ef))
    got = gnn.gnn_forward(t_cfg, gnn.gnn_params_from_numpy(t_cfg, p, CPU),
                          tg)
    close(got, want)
    s = gnn.sort_edges(t_cfg, tg)
    assert s.edge_index.dtype == torch.int32
    assert bool((s.edge_index[1][1:] >= s.edge_index[1][:-1]).all())
    o = np.argsort(ei[1], kind="stable")
    np.testing.assert_array_equal(s.e.numpy(), ef[o])
    np.testing.assert_array_equal(
        s.rowptr["edge_index"].numpy(),
        np.searchsorted(ei[1][o], np.arange(n + 1)))


@pytest.mark.parametrize("kind", KINDS)
def test_prepared_graph_is_not_sorted_or_searched_again(kind, monkeypatch):
    """build_graph prepares each edge set and its row pointers once; a
    forward over the prepared graph neither sorts, checks nor searches
    the destinations, and gives what it gives over the bare graph."""
    _, t_cfg = configs(kind)
    tg = graphs.build_graph(t_cfg, shape("t", "gnn_full", **TINY),
                            np.random.default_rng(0), device=CPU)
    assert set(tg.rowptr) == {k for k in gnn.Graph._fields
                              if k.endswith("edge_index")
                              and getattr(tg, k) is not None}
    p = gnn.init_gnn_params(t_cfg, torch.Generator().manual_seed(0))
    want = gnn.gnn_forward(t_cfg, p, tg._replace(rowptr=None))

    def refuse(*a, **k):
        raise AssertionError("sorted or searched again")
    monkeypatch.setattr(gnn, "sort_edges", refuse)
    monkeypatch.setattr(ops, "row_pointers", refuse)
    torch.testing.assert_close(gnn.gnn_forward(t_cfg, p, tg), want,
                               rtol=0, atol=0)


def test_loss_matches_jax():
    j_cfg, t_cfg = configs("gcn")
    jg, tg = graphs_of(j_cfg, t_cfg, TINY)
    p = jax_params(j_cfg)
    tp = gnn.gnn_params_from_numpy(t_cfg, p, CPU)
    labels = np.random.default_rng(2).integers(0, 4, 60).astype(np.int32)
    mask = (np.arange(60) % 3 == 0).astype(np.float32)
    for lab in (labels, np.random.default_rng(4).standard_normal(
            (60, 4)).astype(np.float32)):
        want = jgnn.gnn_loss(j_cfg, p, dict(graph=jg, labels=jnp.asarray(lab),
                                            mask=jnp.asarray(mask)))
        got = gnn.gnn_loss(t_cfg, tp, dict(graph=tg,
                                           labels=torch.from_numpy(lab),
                                           mask=torch.from_numpy(mask)))
        close(got, want, 1e-5)


def test_kernel_wrappers_raise_on_unsorted_dst():
    x = torch.zeros(5, 4)
    ei = torch.tensor([[0, 1, 2], [3, 1, 2]], dtype=torch.int32)
    with pytest.raises(ValueError, match="sorted ascending"):
        ops.spmm_sorted_coo(x, ei[0], ei[1], 5)
    with pytest.raises(ValueError, match="sorted ascending"):
        scatter_sum(torch.zeros(3, 4), ei, 5)


def test_published_configs_and_device_default(monkeypatch):
    for name in ARCH.values():
        j, t = getattr(jarchs, name), getattr(gnn_archs, name)
        assert dataclasses.asdict(t) == {**dataclasses.asdict(j),
                                         "compute_dtype": torch.float32}
    assert gnn.icosphere_sizes(6) == jgnn.icosphere_sizes(6) \
        == (40962, 327660)
    assert gnn_archs.GCN_CORA.n_params() == jarchs.GCN_CORA.n_params()
    assert [b.arch_id for b in gnn_archs.bundles()] == \
        [b.arch_id for b in jarchs.bundles()]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graphs.build_graph(gnn_archs.GCN_CORA, shape("t", "gnn_full", **TINY))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gnn.gnn_params_from_numpy(gnn_archs.GCN_CORA, {})
