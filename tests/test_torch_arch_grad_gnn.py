"""Every GNN arch and DLRM-RM2 of the registry: the port's grad step against
JAX's, on the CPU, at the smoke size ``tests/test_arch_smoke.py`` runs
(a 64-node, 256-edge graph; a 16-row recsys batch): the loss and the
gradient of every parameter leaf, each within 1e-4 x the leaf's max |ref|
(f32 both sides; the sums run in another order than XLA's).  The GNN
losses take integer labels (classification) and, for the regression
models, float labels too; the mask is random.  Also the port's
``NeighborSampler`` against JAX's: the same subgraphs from the same seed.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import shape as jshape
from repro.configs.registry import ARCHS as J_ARCHS
from repro.data import graphs as jgraphs
from repro.data import pipeline as jpipe
from repro.models import dlrm as jdlrm
from repro.models import gnn as jgnn
from repro_torch.configs.base import shape
from repro_torch.configs.registry import ARCHS
from repro_torch.data import graphs, pipeline
from repro_torch.models import dlrm, gnn
from repro_torch.train.checkpoint import _flatten_with_names

CPU = torch.device("cpu")
GNN_ARCHS = [a for a, b in ARCHS.items() if b.family == "gnn"]
# every arch with int labels; the regression models with float labels too
GNN_CASES = [(a, False) for a in GNN_ARCHS] + [
    (a, True) for a in GNN_ARCHS
    if ARCHS[a].config.kind in ("graphcast", "meshgraphnet")]


def close(got, want, tol=1e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(
        np.abs(want).max(initial=0.0), 1e-30))


def grads_close(t_grads, j_grads, names):
    for name, a, b in zip(names, t_grads, jax.tree.leaves(j_grads)):
        assert a.shape == b.shape, name
        close(a.numpy(), b)


def port_value_and_grad(loss_fn, tree):
    leaves = [t.requires_grad_() for t in jax.tree.leaves(tree)]
    loss = loss_fn(tree)
    # a leaf the loss does not reach (the last layer's edge norm) gets
    # zeros, as from jax.grad
    return loss.detach(), torch.autograd.grad(loss, leaves,
                                              materialize_grads=True)


@pytest.mark.parametrize("arch,regression", GNN_CASES)
def test_gnn_grad_step_matches_jax(arch, regression):
    jcfg, tcfg = J_ARCHS[arch].smoke(), ARCHS[arch].smoke()
    kw = dict(n_nodes=64, n_edges=256, d_feat=tcfg.d_in)
    jg = jgraphs.build_graph(jcfg, jshape("smoke", "gnn_full", **kw),
                             np.random.default_rng(0))
    tg = graphs.build_graph(tcfg, shape("smoke", "gnn_full", **kw),
                            np.random.default_rng(0), device=CPU)
    rng = np.random.default_rng(1)
    labels = (rng.standard_normal((64, tcfg.d_out)).astype(np.float32)
              if regression else
              rng.integers(0, tcfg.d_out, 64).astype(np.int32))
    mask = (rng.random(64) < 0.7).astype(np.float32)
    jp = jgnn.init_gnn_params(jcfg, jax.random.PRNGKey(0))
    tp = gnn.gnn_params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), CPU)
    jb = dict(graph=jg, labels=jnp.asarray(labels), mask=jnp.asarray(mask))
    tb = dict(graph=tg, labels=torch.from_numpy(labels),
              mask=torch.from_numpy(mask))
    j_loss, j_grads = jax.value_and_grad(
        lambda p: jgnn.gnn_loss(jcfg, p, jb))(jp)
    t_loss, t_grads = port_value_and_grad(
        lambda p: gnn.gnn_loss(tcfg, p, tb), tp)
    close(t_loss, j_loss)
    names = [n for n, _ in _flatten_with_names(jax.tree.map(np.asarray, jp))]
    grads_close(t_grads, j_grads, names)


def test_dlrm_grad_step_matches_jax():
    jcfg, tcfg = J_ARCHS["dlrm-rm2"].smoke(), ARCHS["dlrm-rm2"].smoke()
    spec = dict(batch=16, n_dense=tcfg.n_dense, n_sparse=tcfg.n_sparse,
                lookups=tcfg.lookups_per_field,
                vocab_sizes=tcfg.resolved_vocabs())
    jb = {k: jnp.asarray(v) for k, v in jpipe.recsys_batch(
        jpipe.RecSysBatchSpec(**spec), 0).items()}
    tb = {k: torch.from_numpy(v) for k, v in pipeline.recsys_batch(
        pipeline.RecSysBatchSpec(**spec), 0).items()}
    jp = jdlrm.init_dlrm_params(jcfg, jax.random.PRNGKey(0))
    tp = dlrm.dlrm_params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), CPU)
    j_loss, j_grads = jax.value_and_grad(
        lambda p: jdlrm.dlrm_loss(jcfg, p, jb))(jp)
    t_loss, t_grads = port_value_and_grad(
        lambda p: dlrm.dlrm_loss(tcfg, p, tb), tp)
    close(t_loss, j_loss)
    names = [n for n, _ in _flatten_with_names(jax.tree.map(np.asarray, jp))]
    grads_close(t_grads, j_grads, names)
    # the touched rows of the tables have a gradient, the rest are 0
    for f in range(tcfg.n_sparse):
        g = t_grads[names.index(f"tables/{f}")]
        hit = np.zeros(g.shape[0], bool)
        hit[tb["sparse"][:, f].numpy().reshape(-1)] = True
        assert (g.numpy()[~hit] == 0).all()


def test_dlrm_grad_through_a_prepared_handle():
    """``prepare_dlrm_params``' handle of the tables gives the same loss
    and table gradients as the list (its tables are the same tensors)."""
    _, tcfg = J_ARCHS["dlrm-rm2"].smoke(), ARCHS["dlrm-rm2"].smoke()
    tp = dlrm.init_dlrm_params(tcfg, torch.Generator().manual_seed(0))
    spec = pipeline.RecSysBatchSpec(
        batch=8, n_dense=tcfg.n_dense, n_sparse=tcfg.n_sparse,
        lookups=tcfg.lookups_per_field, vocab_sizes=tcfg.resolved_vocabs())
    tb = {k: torch.from_numpy(v)
          for k, v in pipeline.recsys_batch(spec, 1).items()}
    for t in tp["tables"]:
        t.requires_grad_()
    g1 = torch.autograd.grad(dlrm.dlrm_loss(tcfg, tp, tb), tp["tables"])
    prepared = dlrm.prepare_dlrm_params(tp)
    g2 = torch.autograd.grad(dlrm.dlrm_loss(tcfg, prepared, tb),
                             tp["tables"])
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))


@pytest.mark.parametrize("fanout", [(5, 3), (2, 2, 2)])
def test_neighbor_sampler_matches_jax(fanout):
    rng = np.random.default_rng(0)
    n = 500
    ei = np.stack([rng.integers(0, n, 4000), rng.integers(0, n, 4000)]
                  ).astype(np.int32)
    ei[1, :50] = 7                              # a hub
    js = jgraphs.NeighborSampler(n, ei, seed=3)
    ts = graphs.NeighborSampler(n, ei, seed=3)
    for draw in range(3):
        seeds = rng.integers(0, n, 32).astype(np.int64)
        seeds[0] = 499 if draw else 7
        a, b = js.sample(seeds, fanout), ts.sample(seeds, fanout)
        assert a.keys() == b.keys() and a["n_seeds"] == b["n_seeds"]
        for k in ("node_ids", "edge_index"):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    n_nodes, n_edges = graphs.sampled_subgraph_sizes(
        dict(batch_nodes=32, fanout=fanout))
    assert b["node_ids"].shape == (n_nodes,)
    assert b["edge_index"].shape == (2, n_edges)
    assert (b["edge_index"][0] > b["edge_index"][1]).all()


def test_gnn_loss_keeps_the_graph_differentiable_and_serving_frozen():
    tcfg = dataclasses.replace(ARCHS["gcn-cora"].smoke(), d_in=4)
    g = graphs.build_graph(tcfg, shape("s", "gnn_full", n_nodes=20,
                                       n_edges=60, d_feat=4),
                           np.random.default_rng(0), device=CPU)
    tp = gnn.init_gnn_params(tcfg, torch.Generator().manual_seed(0))
    for t in jax.tree.leaves(tp):
        t.requires_grad_()
    batch = dict(graph=g, labels=torch.zeros(20, dtype=torch.int32))
    assert gnn.gnn_loss(tcfg, tp, batch).grad_fn is not None
    assert gnn.GNN(tcfg, tp)(g).grad_fn is None
