"""The port's DLRM and plain EmbeddingBag against the JAX package, on the
CPU.

Parameters come from the JAX package's ``init_dlrm_params`` and batches
from both packages' ``recsys_batch`` (which must be equal), carried
across as numpy.  The bag sums run in another order than XLA's: the bag
is held to 1e-5 relative to max(1, max |ref|) (the tolerance of
``tests/test_kernels`` for the EmbeddingBag), the forward's logits and
scores, through two MLPs and the interaction, to 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import recsys_archs as jarchs
from repro.data import pipeline as jpipe
from repro.kernels.embedding_bag.ops import embedding_bag as j_bag_kernel
from repro.models import dlrm as jdlrm
from repro_torch.configs import recsys_archs
from repro_torch.data import pipeline
from repro_torch.kernels.embedding_bag import ops
from repro_torch.models import dlrm

CPU = torch.device("cpu")


def close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(
        got, want, rtol=tol, atol=tol * max(1.0, np.nanmax(np.abs(want))),
        equal_nan=True)


def smoke():
    j = jarchs._smoke(jarchs.DLRM_RM2)
    t = recsys_archs._smoke(recsys_archs.DLRM_RM2)
    assert dataclasses.asdict(t) == {**dataclasses.asdict(j),
                                     "compute_dtype": torch.float32}
    return j, t


def batch_of(cfg, b, step=0):
    spec = dict(batch=b, n_dense=cfg.n_dense, n_sparse=cfg.n_sparse,
                lookups=cfg.lookups_per_field,
                vocab_sizes=cfg.resolved_vocabs(), seed=5)
    jb = jpipe.recsys_batch(jpipe.RecSysBatchSpec(**spec), step)
    tb = pipeline.recsys_batch(pipeline.RecSysBatchSpec(**spec), step)
    return jb, tb


@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("V,D,B,L", [(50, 8, 6, 3), (300, 64, 17, 4),
                                     (33, 70, 5, 1)])
def test_plain_bag_vs_pallas_interpret(combiner, V, D, B, L):
    rng = np.random.default_rng(V + D)
    table = rng.standard_normal((V, D)).astype(np.float32)
    idx = rng.integers(0, V, (B, L)).astype(np.int32)
    got = ops.embedding_bag_fwd(torch.from_numpy(table),
                                torch.from_numpy(idx), combiner=combiner)
    want = j_bag_kernel(jnp.asarray(table), jnp.asarray(idx),
                        combiner=combiner, interpret=True)
    close(got, want, 1e-5)


@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
def test_bag_index_range_and_weights_vs_take(combiner, weighted):
    """Negative indices count from the end; indices outside [-V, V) give
    NaN rows, as ``jnp.take`` in ``dlrm.embedding_bag``."""
    rng = np.random.default_rng(1)
    V, D = 10, 6
    table = rng.standard_normal((V, D)).astype(np.float32)
    idx = np.array([[0, -1, 3], [-10, 9, 2], [10, 1, 1], [-11, 0, 0]],
                   np.int32)
    w = rng.standard_normal(idx.shape).astype(np.float32) if weighted \
        else None
    got = dlrm.embedding_bag(torch.from_numpy(table), torch.from_numpy(idx),
                             None if w is None else torch.from_numpy(w),
                             combiner)
    want = np.asarray(jdlrm.embedding_bag(
        jnp.asarray(table), jnp.asarray(idx),
        None if w is None else jnp.asarray(w), combiner))
    assert np.isnan(want[2:]).all() and np.isfinite(want[:2]).all()
    close(got, want, 1e-5)


def test_multi_field_bag_equals_fields_one_by_one():
    rng = np.random.default_rng(2)
    vocabs, D, B, L = (40, 7, 300), 16, 9, 3
    tables = [torch.from_numpy(rng.standard_normal((v, D)).astype(np.float32))
              for v in vocabs]
    idx = np.stack([rng.integers(-v, v, (B, L)) for v in vocabs],
                   1).astype(np.int32)
    w = torch.from_numpy(rng.standard_normal(idx.shape).astype(np.float32))
    got = ops.embedding_bags(tables, torch.from_numpy(idx), w, "mean")
    assert got.shape == (B, 3, D)
    for f, t in enumerate(tables):
        want = jdlrm.embedding_bag(jnp.asarray(t.numpy()),
                                   jnp.asarray(idx[:, f]),
                                   jnp.asarray(w[:, f].numpy()), "mean")
        close(got[:, f], want, 1e-5)


def test_recsys_batch_equals_jax():
    cfg = recsys_archs.DLRM_RM2
    for step in (0, 7):
        jb, tb = batch_of(cfg, 64, step)
        assert jb.keys() == tb.keys()
        for k in jb:
            assert tb[k].dtype == jb[k].dtype
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
    lj = jpipe.lm_batch(jpipe.LMBatchSpec(4, 16, 1000, seed=2), 3)
    lt = pipeline.lm_batch(pipeline.LMBatchSpec(4, 16, 1000, seed=2), 3)
    for k in lj:
        np.testing.assert_array_equal(lt[k], lj[k], err_msg=k)


def test_forward_loss_and_retrieval_match_jax():
    j_cfg, t_cfg = smoke()
    p = jax.tree.map(np.asarray,
                     jdlrm.init_dlrm_params(j_cfg, jax.random.PRNGKey(0)))
    tp = dlrm.dlrm_params_from_numpy(t_cfg, p, CPU)
    jb, tb = batch_of(j_cfg, 32)
    tb = {k: torch.from_numpy(v) for k, v in tb.items()}
    jb = {k: jnp.asarray(v) for k, v in jb.items()}
    close(dlrm.dlrm_forward(t_cfg, tp, tb),
          jdlrm.dlrm_forward(j_cfg, p, jb), 1e-4)
    close(dlrm.dlrm_loss(t_cfg, tp, tb), jdlrm.dlrm_loss(j_cfg, p, jb), 1e-4)
    cand = np.random.default_rng(3).standard_normal(
        (500, t_cfg.embed_dim)).astype(np.float32)
    q = dict(dense=tb["dense"][:2], sparse=tb["sparse"][:2],
             candidates=torch.from_numpy(cand))
    scores, ids = dlrm.retrieval_score(t_cfg, tp, q)
    j_scores, j_ids = jdlrm.retrieval_score(
        j_cfg, p, dict(dense=jb["dense"][:2], sparse=jb["sparse"][:2],
                       candidates=jnp.asarray(cand)))
    assert scores.shape == ids.shape == (2, 100)
    close(scores, j_scores, 1e-4)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(j_ids))


def test_param_counts_and_conversion_checks():
    j, t = jarchs.DLRM_RM2, recsys_archs.DLRM_RM2
    assert dataclasses.asdict(t) == {**dataclasses.asdict(j),
                                     "compute_dtype": torch.float32}
    assert t.n_params() == j.n_params()
    assert t.resolved_vocabs() == j.resolved_vocabs()
    assert sum(t.resolved_vocabs()) == 143_697_920
    j_cfg, t_cfg = smoke()
    tp = dlrm.init_dlrm_params(t_cfg, torch.Generator().manual_seed(0))
    p = jax.tree.map(np.asarray,
                     jdlrm.init_dlrm_params(j_cfg, jax.random.PRNGKey(0)))
    assert jax.tree.structure(jax.tree.map(lambda a: 0, p)) == \
        jax.tree.structure(jax.tree.map(lambda a: 0, jax.tree.map(
            lambda x: x.numpy(), tp)))
    for a, b in zip(jax.tree.leaves(p), jax.tree.leaves(
            jax.tree.map(lambda x: x.numpy(), tp))):
        assert a.shape == b.shape and a.dtype == b.dtype
    bad = dict(p, tables=p["tables"][:-1])
    with pytest.raises(ValueError, match="tables"):
        dlrm.dlrm_params_from_numpy(t_cfg, bad, CPU)


def test_wrapper_checks_on_cpu():
    t = torch.zeros(5, 4)
    idx = torch.zeros(3, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="indices"):
        ops.embedding_bag_fwd(t, idx.long())
    with pytest.raises(ValueError, match="table 0"):
        ops.embedding_bag_fwd(t.double(), idx)
    with pytest.raises(ValueError, match="combiner"):
        ops.embedding_bag_fwd(t, idx, combiner="max")
    with pytest.raises(ValueError, match="weights"):
        ops.embedding_bag_fwd(t, idx, torch.ones(3, 3))
    with pytest.raises(ValueError, match="tables"):
        ops.embedding_bags([t], idx[:, None].expand(3, 2, 2).contiguous())
    with pytest.raises(ValueError, match="table 1"):
        ops.embedding_bags([t, torch.zeros(5, 3)],
                           torch.zeros(3, 2, 2, dtype=torch.int32))
