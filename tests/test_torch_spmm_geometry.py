"""The scatter-SpMM kernel's warp shape and summation order, on the CPU.

``ops.geometry(D)`` picks the kernel's warp (lanes an edge, floats a
lane load) in Python, so these tests reach the choice at every width
``chip_smoke.py``'s phase 8 runs and at the edges of each shape.
``ref.spmm_ordered`` is the plain emulation of the order in which that
warp sums (strided edge groups, then a fixed xor tree): it is held
within 1e-4 (relative to max(1, max |ref|), the SpMM tolerance of
``tests/test_kernels.py``) of the JAX package's Pallas SpMM in interpret
mode and of its plain reference, on inputs made with numpy from a seed,
with empty rows, destinations out of range and source indices that wrap
and clamp.  On the card, ``chip_smoke.py`` and ``tests/test_torch_kernel.py``
hold the kernel equal to it bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.spmm.ops import spmm_reference, spmm_sorted_coo as j_coo
from repro_torch.kernels.spmm import ops
from repro_torch.kernels.spmm.ref import (scatter_spmm_ref, spmm_ordered,
                                          spmm_sorted_coo_ref)

TOL = 1e-4

# D -> (lanes, vec): phase 8's widths, then the edges of each shape
SHAPES = {1: (1, 1), 7: (8, 1), 16: (4, 4), 33: (32, 1), 70: (32, 1),
          128: (32, 1), 512: (32, 1),
          4: (1, 4), 8: (2, 4), 12: (4, 4), 20: (8, 4), 28: (8, 4),
          2: (2, 1), 9: (16, 1), 17: (32, 1), 31: (32, 1), 32: (32, 1)}


def close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(1.0, np.abs(want).max(
                                   initial=0.0)))


@pytest.mark.parametrize("D", sorted(SHAPES))
def test_geometry_by_width(D):
    lanes, vec = ops.geometry(D)
    assert (lanes, vec) == SHAPES[D]
    assert lanes & (lanes - 1) == 0 and vec in (1, 4)
    if (lanes, vec) != ops.WIDE:
        assert lanes < 32 and lanes * vec >= D and D < 32
        assert vec == 1 or D % 4 == 0
        assert lanes * vec // 2 < D     # the fewest lanes that cover D
    else:
        assert D >= 32 or -(-D // vec) > 16


@pytest.mark.parametrize("D", [4, 8, 12, 16, 20, 28])
def test_geometry_drops_float4_on_a_misaligned_start(D):
    lanes, vec = ops.geometry(D, aligned=False)
    assert vec == 1 and (lanes == 32 or lanes >= D)


def inputs(seed, n, e, D, lo=-4, hi=None):
    """x [n, D], src in [-n, 2n) (wraps, then clamps), dst sorted in [lo,
    hi) with rows left empty, coeff [e]; numpy, from a seed."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, D)).astype(np.float32)
    src = rng.integers(-n, 2 * n, e).astype(np.int32)
    rows = rng.integers(lo, n + 4 if hi is None else hi, e)
    rows = np.where(rows % 5 == 3, rows - 1, rows)    # every 5th row empty
    dst = np.sort(rows).astype(np.int32)
    coeff = rng.standard_normal(e).astype(np.float32)
    return x, src, dst, coeff


@pytest.mark.parametrize("D", [1, 7, 16, 33, 4, 12, 20])
@pytest.mark.parametrize("with_coeff", [False, True])
def test_ordered_sum_vs_jax(D, with_coeff):
    n, e = 64, 900
    x, src, dst, coeff = inputs(D, n, e, D)
    groups = 32 // ops.geometry(D)[0]
    c = coeff if with_coeff else None
    got = spmm_ordered(torch.from_numpy(x), torch.from_numpy(src),
                       torch.from_numpy(dst), n,
                       None if c is None else torch.from_numpy(c), groups)
    assert not got[3::5].any()                        # empty rows are 0
    want = j_coo(jnp.asarray(x), jnp.asarray(src), jnp.asarray(dst), n,
                 None if c is None else jnp.asarray(c), bn=16, be=64,
                 interpret=True)
    close(got, want)
    msgs = x[np.where(src < 0, src + n, src).clip(0, n - 1)]
    if c is not None:
        msgs = msgs * c[:, None]
    close(got, spmm_reference(jnp.asarray(msgs), jnp.asarray(dst), n))
    close(got, spmm_sorted_coo_ref(
        torch.from_numpy(x), torch.from_numpy(src), torch.from_numpy(dst), n,
        None if c is None else torch.from_numpy(c)))


@pytest.mark.parametrize("groups", [1, 2, 4, 8, 16, 32])
def test_ordered_messages_vs_jax(groups):
    """Without src (the edge-message sums): any group count, also a row of
    10,000 edges."""
    n, e, D = 40, 12_000, 3
    rng = np.random.default_rng(groups)
    msgs = rng.standard_normal((e, D)).astype(np.float32)
    dst = np.sort(np.concatenate([np.full(10_000, 7),
                                  rng.integers(-2, n + 2, e - 10_000)])
                  ).astype(np.int32)
    got = spmm_ordered(torch.from_numpy(msgs), None, torch.from_numpy(dst), n,
                       groups=groups)
    close(got, spmm_reference(jnp.asarray(msgs), jnp.asarray(dst), n))
    close(got, scatter_spmm_ref(torch.from_numpy(msgs), torch.from_numpy(dst),
                                n))


def test_ordered_sum_is_the_edge_order_at_one_group():
    """One group sums each row's edges in order, as ``index_add_`` does on
    the CPU: equal bits."""
    x, src, dst, coeff = inputs(3, 50, 700, 9)
    args = [torch.from_numpy(a) for a in (x, src, dst)]
    got = spmm_ordered(*args, 50, torch.from_numpy(coeff), 1)
    assert torch.equal(got, spmm_sorted_coo_ref(*args, 50,
                                                torch.from_numpy(coeff)))


def test_ordered_sum_groups_and_tree():
    """Edge k of a row goes to group k % G; the groups fold neighbours
    first: with 4 groups, ((m0 + m4) + (m1 + m5)) + ((m2 + m6) + m3)."""
    m = torch.tensor([[1e8], [1.0], [-1e8], [3.0], [5.0], [7.0], [11.0]])
    dst = torch.zeros(7, dtype=torch.int32)
    got = spmm_ordered(m, None, dst, 1, groups=4)
    f = np.float32
    want = (f(f(1e8) + f(5.0)) + f(f(1.0) + f(7.0))) + (
        f(f(-1e8) + f(11.0)) + f(3.0))
    assert got.item() == want
