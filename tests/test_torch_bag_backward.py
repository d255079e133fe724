"""The bag backward's plain versions on the CPU: the order the backward
kernels sum in (``ref.embedding_bags_bwd_ordered``) against ``jax.vjp`` of
the JAX package's bag, against ``index_add_`` where one segment holds the
batch, and against a lookup-by-lookup walk of the kernels' segments and
rows; the key pass and sort (``ref.bwd_keys_ref``) against the int64
``torch.sort`` of the keys; the wrapper's int32 limit and group shapes.

Inputs come from numpy seeds.  Each case has negative indices, an index
outside ``[-V, V)`` (dropped: it adds nothing) and a hot row whose run
spans several segments of ``SEGMENT_SMALL`` lookups.  Tolerance against
JAX: 1e-5 x max(1, max |ref|), the bag's limit (a row's gradient is a sum
of at most B L bag gradients, here in another order).  The kernels
themselves run on the card (``tests/test_torch_backward_kernels.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.embedding_bag.ref import embedding_bag_ref as j_bag
from repro.models.dlrm import embedding_bag as j_bag_weighted
from repro_torch.kernels.embedding_bag import ops
from repro_torch.kernels.embedding_bag.ref import (SEGMENT, bwd_keys_ref,
                                                   embedding_bags_bwd_ordered,
                                                   embedding_bags_bwd_ref)

VOCABS = (7, 3, 11)
SEGMENT_SMALL = 8


def bag_case(seed, D, B=24, L=4, vocabs=VOCABS):
    """(indices [B, F, L] int32, gout [B, F, D], weights [B, F, L]) with
    negative indices, two dropped lookups and a hot row: field 2's row 4
    at every lookup of half the batch (48 lookups, six segments)."""
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.integers(-v, v, (B, L)) for v in vocabs],
                   axis=1).astype(np.int32)
    idx[0, 0, 0], idx[1, len(vocabs) - 1, L - 1] = 50, -40
    idx[::2, len(vocabs) - 1, :] = 4
    gout = rng.standard_normal((B, len(vocabs), D)).astype(np.float32)
    w = rng.random((B, len(vocabs), L)).astype(np.float32)
    return idx, gout, w


def bits(a: torch.Tensor) -> torch.Tensor:
    return a.contiguous().view(torch.int32)


def same_bits(got, want) -> bool:
    return len(got) == len(want) and all(
        a.shape == b.shape and torch.equal(bits(a), bits(b))
        for a, b in zip(got, want))


@pytest.mark.parametrize("D", [5, 64, 200])
@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
def test_ordered_backward_matches_jax_vjp(D, combiner, weighted):
    idx, gout, w = bag_case(D, D)
    rng = np.random.default_rng(100 + D)
    tables = [rng.standard_normal((v, D)).astype(np.float32) for v in VOCABS]
    want = []
    for f, t in enumerate(tables):
        if weighted:
            fn = lambda t: j_bag_weighted(t, idx[:, f], w[:, f],  # noqa
                                          combiner)
        else:
            fn = lambda t: j_bag(t, idx[:, f], combiner)  # noqa: E731
        _, vjp = jax.vjp(fn, t)
        want.append(np.asarray(vjp(jnp.asarray(gout[:, f]))[0]))
    got = embedding_bags_bwd_ordered(
        VOCABS, torch.from_numpy(idx), torch.from_numpy(gout),
        torch.from_numpy(w) if weighted else None, combiner,
        segment=SEGMENT_SMALL)
    hot = got[2][4].abs().max()
    assert hot > 0
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape
        assert np.isfinite(b).all()
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-5 * max(
            1.0, float(np.abs(b).max())))


@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("D", [5, 64])
def test_one_segment_is_index_add_bit_for_bit(combiner, weighted, D):
    idx, gout, w = bag_case(7, D)
    args = (VOCABS, torch.from_numpy(idx), torch.from_numpy(gout),
            torch.from_numpy(w) if weighted else None, combiner)
    assert same_bits(embedding_bags_bwd_ordered(*args, segment=idx.size),
                     embedding_bags_bwd_ref(*args))


@pytest.mark.parametrize("shape,vocabs,fill", [
    ((0, 3, 4), VOCABS, None),          # an empty batch
    ((5, 3, 4), VOCABS, 99),            # every lookup dropped
    ((6, 1, 1), (9,), None),            # F = 1, L = 1
    ((6, 1, 3), (0,), None)])           # an empty table: all dropped
def test_edge_batches(shape, vocabs, fill):
    rng = np.random.default_rng(3)
    idx = rng.integers(-9, 9, shape).astype(np.int32)
    if fill is not None:
        idx[:] = fill
    gout = rng.standard_normal((*shape[:2], 6)).astype(np.float32)
    args = (vocabs, torch.from_numpy(idx), torch.from_numpy(gout))
    got = embedding_bags_bwd_ordered(*args, segment=2)
    assert same_bits(got, embedding_bags_bwd_ref(*args))
    assert [tuple(g.shape) for g in got] == [(v, 6) for v in vocabs]


def kernels_walk(vocabs, idx, gout, w, combiner, S):
    """The backward kernels lookup by lookup in numpy f32: the segments
    kernel's walk (fragments from 0, a run inside its segment written,
    the others' fragments kept as partials: slot 0 opening a segment,
    slot 1 closing it) and the rows kernel's (zeros; a spanning run's
    partials summed from 0 in segment order)."""
    B, F, L = idx.shape
    D = gout.shape[-1]
    total = sum(vocabs)
    keys, _, order = bwd_keys_ref(vocabs, torch.from_numpy(idx))
    k = keys.numpy()[order.numpy()]
    p = order.numpy()
    n = k.size
    grad = np.full((total, D), np.nan, np.float32)
    partial = {}
    for seg in range(-(-n // S)):
        base, ln = seg * S, min(S, n - seg * S)
        before = k[base - 1] if base else -1
        after = k[base + ln] if base + ln < n else -1
        acc, first = np.zeros(D, np.float32), 0
        for e in range(ln):
            if k[base + e] >= total:
                break
            x = gout.reshape(B * F, D)[p[base + e] // L].copy()
            if combiner == "mean":
                x = x / np.float32(L)
            if w is not None:
                x = x * w.reshape(-1)[p[base + e]]
            acc = acc + x
            end = e == ln - 1
            nxt = after if end else k[base + e + 1]
            if end or nxt != k[base + e]:
                head = first == 0 and before == k[base + e]
                tail = end and after == k[base + e]
                if head or tail:
                    partial[seg, 0 if head else 1] = acc
                else:
                    grad[k[base + e]] = acc
                acc, first = np.zeros(D, np.float32), e + 1
    for r in range(total):
        a, b = np.searchsorted(k, r), np.searchsorted(k, r + 1)
        if a < b and a // S == (b - 1) // S:
            continue
        acc = np.zeros(D, np.float32)
        for s in range(a // S, (b - 1) // S + 1 if a < b else 0):
            acc = acc + partial[s, 1 if s == a // S else 0]
        grad[r] = acc
    return [torch.from_numpy(g)
            for g in np.split(grad, np.cumsum(vocabs)[:-1])]


@pytest.mark.parametrize("S", [1, 3, SEGMENT_SMALL, SEGMENT])
@pytest.mark.parametrize("combiner,weighted", [("sum", False), ("mean", True)])
def test_ordered_backward_is_the_kernels_walk(S, combiner, weighted):
    idx, gout, w = bag_case(11, 6)
    got = embedding_bags_bwd_ordered(
        VOCABS, torch.from_numpy(idx), torch.from_numpy(gout),
        torch.from_numpy(w) if weighted else None, combiner, segment=S)
    want = kernels_walk(VOCABS, idx, gout, w if weighted else None,
                        combiner, S)
    assert same_bits(got, want)


def test_key_pass_and_sort_are_the_int64_sort():
    idx, _, _ = bag_case(5, 4)
    indices = torch.from_numpy(idx)
    keys, pos, order = bwd_keys_ref(VOCABS, indices)
    # the keys as int64 and their stable torch.sort, written out here
    V = torch.tensor(VOCABS)
    first = torch.cumsum(V, 0) - V
    i = indices.long()
    i = torch.where(i < 0, i + V[:, None], i)
    keep = (i >= 0) & (i < V[:, None])
    want_keys, want_pos = torch.sort(
        torch.where(keep, i + first[:, None], sum(VOCABS)).reshape(-1),
        stable=True)
    assert keys.dtype == pos.dtype == torch.int32
    assert torch.equal(pos, torch.arange(idx.size, dtype=torch.int32))
    assert torch.equal(keys[order].long(), want_keys)
    assert torch.equal(order, want_pos)
    assert int((keys == sum(VOCABS)).sum()) == 2          # the dropped two


def test_key_bits_and_the_int32_limit():
    assert ops.bwd_bits(6_815_744, 14_723_072) == 24     # RM2 train_batch
    assert ops.bwd_bits(26 * 4 * 65_536, 143_697_920) == 28   # RM2 whole
    assert ops.bwd_bits(0, 0) == 1
    assert ops.bwd_bits(10, 2 ** 31 - 1) == 31
    for n, total in ((2 ** 31, 5), (5, 2 ** 31)):
        with pytest.raises(ValueError, match="2\\^31"):
            ops.bwd_bits(n, total)


@pytest.mark.parametrize("D,align,want", [
    (64, 16, (16, 4)), (5, 16, (8, 1)), (200, 16, (32, 4)), (2, 16, (1, 2)),
    (64, 8, (32, 2)), (64, 4, (32, 1)), (1, 16, (1, 1)), (12, 16, (4, 4)),
    (16, 16, (4, 4)), (520, 16, (32, 4))])
def test_backward_group_shape(D, align, want):
    assert ops.bwd_shape(D, align) == want


def test_launch_bwd_runs_on_the_card_only():
    idx, gout, _ = bag_case(2, 4)
    tables = [torch.zeros((v, 4)) for v in VOCABS]
    with pytest.raises(ValueError, match="cuda"):
        ops.launch_bwd(tables, torch.from_numpy(idx),
                       torch.from_numpy(gout))
