"""The port's segment ops and plain scatter-SpMM against the JAX package.

Inputs come from numpy seeds and reach both packages as numpy.  The
sums run in another order than XLA's, so float results are held to
1e-4 (relative to max(1, |ref|), the tolerance of ``tests/test_kernels``
for the SpMM); counts, maxima and the empty-segment fill are exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graph import segment_ops as jseg
from repro.kernels.spmm.ops import spmm_reference, spmm_sorted_coo as j_coo
from repro_torch.graph import segment_ops as tseg
from repro_torch.kernels.spmm import ops
from repro_torch.kernels.spmm.ref import scatter_spmm_ref

TOL = 1e-4


def close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(1.0, np.abs(want).max(
                                   initial=0.0)))


def edges(seed, n, e, lo=0, hi=None, sort=True):
    """[2, E] int32 with dst drawn from [lo, hi) (out of [0, n) when lo < 0
    or hi > n) and sorted unless ``sort`` is False."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e)
    dst = rng.integers(lo, n if hi is None else hi, e)
    if sort:
        o = np.argsort(dst, kind="stable")
        src, dst = src[o], dst[o]
    return np.stack([src, dst]).astype(np.int32)


def feats(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# (n nodes, edges, dst range): in range; dst out of range on both sides;
# more nodes than edges (empty segments)
CASES = [(40, 300, 0, None), (40, 300, -5, 47), (200, 60, 0, None)]


@pytest.mark.parametrize("n,e,lo,hi", CASES)
def test_sums_degrees_and_norm(n, e, lo, hi):
    ei = edges(1, n, e, lo, hi)
    msgs = feats(2, (e, 5))
    t_ei = torch.from_numpy(ei)
    close(tseg.scatter_sum(torch.from_numpy(msgs), t_ei, n),
          jseg.scatter_sum(jnp.asarray(msgs), jnp.asarray(ei), n))
    close(tseg.scatter_mean(torch.from_numpy(msgs), t_ei, n),
          jseg.scatter_mean(jnp.asarray(msgs), jnp.asarray(ei), n))
    for direction in ("in", "out"):
        np.testing.assert_array_equal(
            tseg.degrees(t_ei, n, direction),
            jseg.degrees(jnp.asarray(ei), n, direction))
    if lo >= 0 and (hi or n) <= n:
        close(tseg.sym_norm_coeff(t_ei, n),
              jseg.sym_norm_coeff(jnp.asarray(ei), n), 1e-6)


@pytest.mark.parametrize("n,e,lo,hi", CASES)
def test_max_and_softmax_take_any_order(n, e, lo, hi):
    ei = edges(3, n, e, lo, hi, sort=False)
    msgs = feats(4, (e, 3))
    got = tseg.scatter_max(torch.from_numpy(msgs), torch.from_numpy(ei), n)
    want = np.asarray(jseg.scatter_max(jnp.asarray(msgs), jnp.asarray(ei), n))
    np.testing.assert_array_equal(got.numpy(), want)   # -inf where empty
    if n > e:
        assert np.isneginf(want).any()
    scores = feats(5, (e,))
    close(tseg.segment_softmax(torch.from_numpy(scores),
                               torch.from_numpy(ei[1]), n),
          jseg.segment_softmax(jnp.asarray(scores), jnp.asarray(ei[1]), n),
          1e-5)


@pytest.mark.parametrize("agg", ["sum", "mean", "max"])
@pytest.mark.parametrize("with_coeff", [False, True])
def test_spmm_aggregators(agg, with_coeff):
    n, e = 50, 400
    ei = edges(6, n, e)
    x = feats(7, (n, 9))
    coeff = feats(8, (e,)) if with_coeff else None
    got = tseg.spmm(torch.from_numpy(x), torch.from_numpy(ei), n,
                    None if coeff is None else torch.from_numpy(coeff), agg)
    want = jseg.spmm(jnp.asarray(x), jnp.asarray(ei), n,
                     None if coeff is None else jnp.asarray(coeff), agg)
    close(got, want)


@pytest.mark.parametrize("D", [7, 16, 70])
@pytest.mark.parametrize("with_coeff", [False, True])
def test_plain_spmm_vs_pallas_interpret(D, with_coeff):
    n, e = 64, 500
    ei = edges(10 + D, n, e)
    x = feats(11, (n, D))
    coeff = feats(12, (e,)) if with_coeff else None
    src, dst = ei
    got = ops.spmm_sorted_coo(
        torch.from_numpy(x), torch.from_numpy(src), torch.from_numpy(dst), n,
        None if coeff is None else torch.from_numpy(coeff))
    want = j_coo(jnp.asarray(x), jnp.asarray(src), jnp.asarray(dst), n,
                 None if coeff is None else jnp.asarray(coeff),
                 bn=16, be=64, interpret=True)
    close(got, want)
    msgs = x[src] * (1.0 if coeff is None else coeff[:, None])
    close(got, spmm_reference(jnp.asarray(msgs), jnp.asarray(dst), n))
    close(ops.scatter_spmm(torch.from_numpy(msgs), torch.from_numpy(dst), n),
          spmm_reference(jnp.asarray(msgs), jnp.asarray(dst), n))


def test_plain_scatter_drops_out_of_range_and_zeroes_empty_rows():
    dst = np.array([-3, -1, 0, 0, 2, 5, 9], np.int32)
    msgs = feats(13, (7, 4))
    got = scatter_spmm_ref(torch.from_numpy(msgs), torch.from_numpy(dst), 4)
    want = jax.ops.segment_sum(jnp.asarray(msgs), jnp.asarray(dst),
                               num_segments=4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not got[1].any() and not got[3].any()


def test_gather_reads_indices_as_jax():
    x = feats(14, (6, 2))
    ei = np.array([[-1, -9, 5, 8], [0, 1, 2, 3]], np.int32)
    np.testing.assert_array_equal(
        tseg.gather_src(torch.from_numpy(x), torch.from_numpy(ei)).numpy(),
        np.asarray(jseg.gather_src(jnp.asarray(x), jnp.asarray(ei))))


def test_wrapper_checks_on_cpu():
    x = torch.zeros(4, 3)
    src = torch.tensor([0, 1, 2], dtype=torch.int32)
    dst = torch.tensor([2, 0, 1], dtype=torch.int32)
    with pytest.raises(ValueError, match="sorted"):
        ops.spmm_sorted_coo(x, src, dst, 4)
    with pytest.raises(ValueError, match="sorted"):
        tseg.scatter_sum(torch.zeros(3, 2), torch.stack([src, dst]), 4)
    good = torch.tensor([0, 1, 1], dtype=torch.int32)
    with pytest.raises(ValueError, match="dst"):
        ops.spmm_sorted_coo(x, src, good.long(), 4)
    with pytest.raises(ValueError, match="x"):
        ops.spmm_sorted_coo(x.double(), src, good, 4)
    with pytest.raises(ValueError, match="msgs"):
        ops.scatter_spmm(torch.zeros(3, 4).t(), good, 4)
    with pytest.raises(ValueError, match="coeff"):
        ops.spmm_sorted_coo(x, src, good, 4, torch.ones(2))
    with pytest.raises(ValueError, match="src"):
        ops.spmm_sorted_coo(x, src[:2], good, 4)


def test_wrapper_takes_row_pointers():
    n, e = 30, 200
    src, dst = (torch.from_numpy(a) for a in edges(15, n, e, -3, n + 3))
    x = torch.from_numpy(feats(16, (n, 5)))
    rp = ops.row_pointers(dst, n)
    np.testing.assert_array_equal(
        rp.numpy(), np.searchsorted(dst.numpy(), np.arange(n + 1)))
    assert rp.dtype == torch.int32
    torch.testing.assert_close(ops.spmm_sorted_coo(x, src, dst, n, rowptr=rp),
                               ops.spmm_sorted_coo(x, src, dst, n),
                               rtol=0, atol=0)
    msgs = torch.from_numpy(feats(17, (e, 3)))
    torch.testing.assert_close(
        tseg.scatter_sum(msgs, torch.stack([src, dst]), n, rp),
        ops.scatter_spmm(msgs, dst, n), rtol=0, atol=0)
    with pytest.raises(ValueError, match="rowptr has"):
        ops.scatter_spmm(msgs, dst, n, rp[:-1])
    with pytest.raises(ValueError, match="rowptr"):
        ops.scatter_spmm(msgs, dst, n, rp.long())
