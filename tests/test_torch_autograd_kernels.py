"""The port's differentiable kernel wrappers against ``jax.grad`` of the JAX
package's same functions, on the CPU.

Each wrapper on a CPU tensor runs its autograd Function with the plain
backward (``ref.py``), the formula its backward kernel is held to on the
card.  JAX's side is ``jax.vjp`` of the package's plain versions
(``kernels/*/ref.py``, ``graph.segment_ops``), which its Pallas kernels
compute (``tests/test_kernels.py``) and whose autodiff XLA takes in
training.  Inputs come from numpy seeds.  Tolerances, relative to
max(1, max |ref|):

* attention (f32): 2e-5, ``tests/test_kernels.py``'s f32 attention limit
  (the backward's sums run in another order, over T = 40 keys);
* SpMM and the segment sum: 1e-4, the SpMM's limit;
* EmbeddingBag: 1e-5, the bag's limit (the gradient of a row is a sum of
  at most B L bag gradients).
"""
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.embedding_bag.ref import embedding_bag_ref as j_bag
from repro.kernels.flash_attention.ref import attention_ref
from repro.kernels.spmm.ref import scatter_spmm_ref as j_scatter
from repro.models.dlrm import embedding_bag as j_bag_weighted
from repro_torch.graph import segment_ops as tseg
from repro_torch.kernels.embedding_bag import ops as bag_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                     flash_attention_fwd_ref)
from repro_torch.kernels.spmm import ops as spmm_ops
from repro_torch.models import gnn


def close(got, want, tol):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(
        1.0, float(np.abs(want).max(initial=0.0))))


def randn(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def leaf(a):
    return torch.tensor(a, requires_grad=True)


# ----------------------------- attention -------------------------------

@pytest.mark.parametrize("B,T,H,Kh,dh", [(2, 40, 4, 2, 16), (1, 33, 6, 3, 32),
                                         (1, 17, 2, 2, 64)])
def test_flash_backward_matches_jax_grad(B, T, H, Kh, dh):
    q, k, v = (randn(s, (B, T, n, dh)) for s, n in ((1, H), (2, Kh), (3, Kh)))
    g = randn(4, (B, T, H, dh))
    _, vjp = jax.vjp(lambda *a: attention_ref(*a, causal=True), q, k, v)
    want = vjp(jnp.asarray(g))
    tq, tk, tv = leaf(q), leaf(k), leaf(v)
    out = fa_ops.flash_attention(tq, tk, tv)
    assert out.grad_fn is not None and \
        type(out.grad_fn).__name__ == "FlashAttentionBackward"
    close(out, attention_ref(q, k, v, causal=True), 2e-5)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    for a, b in zip(got, want):
        close(a, b, 2e-5)


def test_flash_lse_and_plain_backward_pieces():
    """The lse the forward stores is logsumexp of the scaled, masked
    scores; the plain backward's tiles (chunk) change only the order of
    the dK and dV sums (1e-5)."""
    B, T, H, Kh, dh = 1, 70, 4, 1, 16
    q, k, v = (torch.from_numpy(randn(s, (B, T, n, dh)))
               for s, n in ((5, H), (6, Kh), (7, Kh)))
    o, lse = flash_attention_fwd_ref(q, k, v)
    s = torch.einsum("bthd,bshd->bhts", q / dh ** 0.5,
                     k.repeat_interleave(H // Kh, 2))
    s = s.masked_fill(torch.ones(T, T, dtype=torch.bool).triu(1), -torch.inf)
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), rtol=0,
                               atol=1e-5)
    do = torch.from_numpy(randn(8, (B, T, H, dh)))
    whole = flash_attention_bwd_ref(q, k, v, o, lse, do, chunk=T)
    tiled = flash_attention_bwd_ref(q, k, v, o, lse, do, chunk=16)
    for a, b in zip(whole, tiled):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


def test_flash_bf16_grad_dtypes_and_no_grad_path():
    q, k, v = (leaf(randn(s, (1, 24, 2, 16))).to(torch.bfloat16)
               for s in (1, 2, 3))
    out = fa_ops.flash_attention(q, k, v)
    dq, dk, dv = torch.autograd.grad(out.float().sum(), (q, k, v))
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
    with torch.no_grad():
        assert fa_ops.flash_attention(q, k, v).grad_fn is None


# ------------------------------- SpMM ----------------------------------

def coo(seed, n, e, lo=0, hi=None):
    rng = np.random.default_rng(seed)
    src = rng.integers(-2, n + 2, e)          # JAX's gather clamps these
    dst = np.sort(rng.integers(lo, n if hi is None else hi, e))
    return src.astype(np.int32), dst.astype(np.int32)


@pytest.mark.parametrize("n,e,lo,hi", [(40, 300, 0, None), (40, 300, -4, 45),
                                       (200, 60, 0, None)])
def test_spmm_sorted_coo_grads_match_jax(n, e, lo, hi):
    src, dst = coo(1, n, e, lo, hi)
    x, coeff, g = randn(2, (n, 6)), randn(3, (e,)), randn(4, (n, 6))

    def j_fn(x, c):
        return j_scatter(x[src] * c[:, None], dst, n)
    out, vjp = jax.vjp(j_fn, x, coeff)
    want = vjp(jnp.asarray(g))
    tx, tc = leaf(x), leaf(coeff)
    got = spmm_ops.spmm_sorted_coo(tx, torch.from_numpy(src),
                                   torch.from_numpy(dst), n, tc)
    assert type(got.grad_fn).__name__ == "SpmmSortedCooBackward"
    close(got, out, 1e-4)
    for a, b in zip(torch.autograd.grad(got, (tx, tc), torch.from_numpy(g)),
                    want):
        close(a, b, 1e-4)


@pytest.mark.parametrize("n,e,lo,hi", [(40, 300, 0, None), (40, 300, -4, 45)])
def test_scatter_spmm_grad_is_the_gather(n, e, lo, hi):
    _, dst = coo(5, n, e, lo, hi)
    msgs, g = randn(6, (e, 3)), randn(7, (n, 3))
    _, vjp = jax.vjp(lambda m: j_scatter(m, dst, n), msgs)
    tm = leaf(msgs)
    out = spmm_ops.scatter_spmm(tm, torch.from_numpy(dst), n)
    (got,) = torch.autograd.grad(out, tm, torch.from_numpy(g))
    close(got, vjp(jnp.asarray(g))[0], 1e-4)


def test_segment_ops_pass_gradients_and_transposed_cache():
    from repro.graph import segment_ops as jseg
    n, e = 30, 120
    src, dst = coo(8, n, e)
    src = np.clip(src, 0, n - 1).astype(np.int32)
    ei = np.stack([src, dst])
    x, g, msgs = randn(9, (n, 4)), randn(10, (n, 4)), randn(11, (e, 4))
    coeff = np.array(jseg.sym_norm_coeff(jnp.asarray(ei), n))

    def j_fn(x, m):
        return (jseg.spmm(x, jnp.asarray(ei), n, jnp.asarray(coeff)),
                jseg.scatter_sum(m, jnp.asarray(ei), n))
    _, vjp = jax.vjp(j_fn, x, msgs)
    want = vjp((jnp.asarray(g), jnp.asarray(g)))
    t_ei = torch.from_numpy(ei)
    tx, tm = leaf(x), leaf(msgs)
    a = tseg.spmm(tx, t_ei, n, torch.from_numpy(coeff))
    b = tseg.scatter_sum(tm, t_ei, n)
    got = torch.autograd.grad((a, b), (tx, tm),
                              (torch.from_numpy(g), torch.from_numpy(g)))
    for a_, b_ in zip(got, want):
        close(a_, b_, 1e-4)
    # the transposed edges: built once a graph beside its row pointers,
    # and what a gcn's forward with grad adds when missing
    cfg = gnn.GNNConfig(kind="gcn", d_in=4)
    tg = gnn.add_transposed(cfg, gnn.sort_edges(
        cfg, gnn.Graph(x=tx.detach(), edge_index=t_ei)))
    t1 = tg.transposed["edge_index"]
    assert (np.diff(src[t1.perm.numpy()]) >= 0).all()
    assert t1.rowptr[-1] == e
    np.testing.assert_array_equal(t1.src.numpy(), dst[t1.perm.numpy()])
    assert gnn.sort_edges(cfg, tg).transposed is None
    seen = []
    real = gnn.add_transposed
    with mock.patch.object(gnn, "add_transposed",
                           lambda c, g: seen.append(1) or real(c, g)):
        p = gnn.init_gnn_params(cfg, torch.Generator().manual_seed(0))
        gnn.gnn_forward(cfg, p, tg._replace(transposed=None))
        assert seen == []                  # no gradient wanted
        p = {k: [t.requires_grad_() for t in v] for k, v in p.items()}
        gnn.gnn_forward(cfg, p, tg._replace(transposed=None))
        gnn.gnn_forward(cfg, p, tg)
        assert seen == [1]


# ---------------------------- EmbeddingBag -----------------------------

def bag_inputs(seed, B=9, L=4, vocabs=(7, 3, 11)):
    rng = np.random.default_rng(seed)
    tables = [rng.standard_normal((v, 5)).astype(np.float32) for v in vocabs]
    idx = np.stack([rng.integers(-v, v, (B, L)) for v in vocabs],
                   axis=1).astype(np.int32)
    idx[0, 0, 0], idx[1, 2, 3] = 50, -40     # out of range: NaN bags
    return tables, idx, rng.random((B, len(vocabs), L)).astype(np.float32)


@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
def test_embedding_bags_grads_match_jax(combiner, weighted):
    tables, idx, w = bag_inputs(1)
    g = randn(2, (idx.shape[0], idx.shape[1], 5))
    want = []
    for f, t in enumerate(tables):
        if weighted:
            fn = lambda t: j_bag_weighted(t, idx[:, f], w[:, f],  # noqa
                                          combiner)
        else:
            fn = lambda t: j_bag(t, idx[:, f], combiner)  # noqa: E731
        _, vjp = jax.vjp(fn, t)
        want.append(vjp(jnp.asarray(g[:, f]))[0])
    tt = [leaf(t) for t in tables]
    out = bag_ops.embedding_bags(tt, torch.from_numpy(idx),
                                 torch.from_numpy(w) if weighted else None,
                                 combiner)
    assert type(out.grad_fn).__name__ == "EmbeddingBagsBackward"
    got = torch.autograd.grad(out, tt, torch.from_numpy(g))
    for a, b in zip(got, want):
        assert np.isfinite(np.asarray(b)).all()
        close(a, b, 1e-5)


def test_embedding_bags_prepared_handle_and_refusals():
    tables, idx, w = bag_inputs(3)
    tt = [leaf(t) for t in tables]
    handle = bag_ops.prepare_tables(tt)
    out = bag_ops.embedding_bags(handle, torch.from_numpy(idx))
    grads = torch.autograd.grad(out.nan_to_num().sum(), tt)
    assert [tuple(a.shape) for a in grads] == [t.shape for t in tables]
    tw = torch.from_numpy(w).requires_grad_(True)
    with pytest.raises(NotImplementedError, match="weights"):
        bag_ops.embedding_bags(tt, torch.from_numpy(idx), tw)
