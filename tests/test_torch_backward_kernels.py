"""The backward kernels and the flash forward's lse store on the card,
against their plain versions (``gpu``: each test skips, from a fixture,
without a card; this file imports no JAX).

* flash backward (bf16): dq, dk and dv against
  ``ref.flash_attention_bwd_ref`` on the same q, k, v, o, lse and dout,
  entry by entry within 2e-2 x (|ref| + median |ref|), the forward's bf16
  limit (``chip_smoke.py`` phase 13), at G = 1-7, at T exactly one tile
  and one past it, at Tq != Tk and unmasked; two launches give the same
  bits, also at T = 1024;
* the lse store: both forward kernels' lse against the plain forward's,
  within 1e-3 absolute (the kernels' exp2 / log2 in f32 against the plain
  exp and log), and the output unchanged by the store, bit for bit;
* the SpMM's transposed launch: dx against ``spmm_sorted_coo_bwd_ref``
  within 1e-4 x max(1, max |ref|);
* the bag backward: every table's gradient against
  ``embedding_bags_bwd_ref`` within 1e-5 x max(1, max |ref|), and the
  same bits on a second launch; equal bit for bit to
  ``ref.embedding_bags_bwd_ordered`` (the kernels' order of the sums) at D
  5, 64 and 200 with hot rows over several segments, at F = 1, L = 1 and
  3, an empty batch and one with every lookup dropped; the key pass and
  CUB's sort the pairs of ``ref.bwd_keys_ref`` in its stable order; rows
  no lookup reads exactly +0.0 where the allocator hands the output a
  freed buffer of NaN.
"""
import pytest
import torch

from repro_torch.kernels.embedding_bag import ops as bag_ops
from repro_torch.kernels.embedding_bag.ref import (SEGMENT, bwd_keys_ref,
                                                   embedding_bags_bwd_ordered,
                                                   embedding_bags_bwd_ref)
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                     flash_attention_fwd_ref)
from repro_torch.kernels.spmm import ops as spmm_ops
from repro_torch.kernels.spmm.ref import spmm_sorted_coo_bwd_ref


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU "
                    "mode (chip_smoke.py runs the main-path shapes there)")
    return torch.device("cuda")


def excess(got, want):
    """The largest |got - want| over 2e-2 (|want| + median |want|)."""
    d = (got.double() - want.double()).abs()
    w = want.double().abs()
    return float((d / (2e-2 * (w + w.median()))).max())


def scaled(got, want):
    return float((got.double() - want.double()).abs().max()
                 / max(1.0, float(want.double().abs().max())))


def flash_bwd_inputs(card, B, T, H, Kh, dh, seed):
    g = torch.Generator(device=card).manual_seed(seed)
    q = torch.randn((B, T, H, dh), generator=g, device=card).bfloat16()
    k, v = (torch.randn((B, T, Kh, dh), generator=g, device=card).bfloat16()
            for _ in range(2))
    do = torch.randn((B, T, H, dh), generator=g, device=card).bfloat16()
    return (q, k, v, *flash_attention_fwd_ref(q, k, v), do)


# (B, T, H, Kh): G = 2 and 6; arctic's G = 7 (56/8 cut to 14/2); T one
# query step (64) and one block tile (128) exactly, and one past each
@pytest.mark.gpu
@pytest.mark.parametrize("dh", [16, 32, 64, 128])
@pytest.mark.parametrize("B,T,H,Kh", [(2, 200, 4, 2), (1, 129, 6, 1),
                                      (1, 200, 14, 2), (2, 64, 4, 2),
                                      (2, 128, 4, 2), (1, 65, 4, 1)])
def test_flash_backward_kernel_against_plain(card, B, T, H, Kh, dh):
    q, k, v, o, lse, do = flash_bwd_inputs(card, B, T, H, Kh, dh, dh + T)
    before = fa_ops.bwd_launches
    got = fa_ops.flash_attention_bwd(q, k, v, o, lse, do)
    again = fa_ops.flash_attention_bwd(q, k, v, o, lse, do)
    assert fa_ops.bwd_launches == before + 2
    want = flash_attention_bwd_ref(q, k, v, o, lse, do)
    for name, a, b, c in zip("qkv", got, again, want):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b), name
        assert excess(a, c) <= 1, (name, excess(a, c))


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Tq,Tk", [(200, 200), (100, 300), (300, 100)])
def test_flash_backward_kernel_unequal_lengths_and_unmasked(card, Tq, Tk,
                                                            causal):
    """Tq != Tk (the mask is col > row, both from 0) and the unmasked
    backward, against the plain one; the keys that no query sees (at and
    after Tq, causal) get exact zeros, and the limit holds on the rest
    (over all keys, their zeros would be the median)."""
    g = torch.Generator(device=card).manual_seed(Tq + Tk)
    q, do = (torch.randn((2, Tq, 4, 64), generator=g, device=card)
             .bfloat16() for _ in range(2))
    k, v = (torch.randn((2, Tk, 2, 64), generator=g, device=card).bfloat16()
            for _ in range(2))
    o, lse = flash_attention_fwd_ref(q, k, v, causal)
    got = fa_ops.flash_attention_bwd(q, k, v, o, lse, do, causal)
    want = flash_attention_bwd_ref(q, k, v, o, lse, do, causal)
    seen = min(Tq, Tk) if causal else Tk
    for name, a, c in zip("qkv", got, want):
        if name != "q":
            assert not a[:, seen:].any(), name
            a, c = a[:, :seen], c[:, :seen]
        assert excess(a, c) <= 1, (name, excess(a, c))


@pytest.mark.gpu
@pytest.mark.parametrize("dh", [64, 128])
def test_flash_backward_same_bits_on_a_second_launch(card, dh):
    """Many blocks in flight (T = 1024, 16/4 heads, B = 2): a second
    launch, after other work on the card, gives the same bits."""
    q, k, v, o, lse, do = flash_bwd_inputs(card, 2, 1024, 16, 4, dh, dh)
    got = fa_ops.flash_attention_bwd(q, k, v, o, lse, do)
    torch.randn((1 << 20,), device=card).sum()
    again = fa_ops.flash_attention_bwd(q, k, v, o, lse, do)
    for name, a, b in zip("qkv", got, again):
        assert torch.equal(a, b), name


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dh", [16, 64, 128])
def test_flash_forward_lse_store(card, dtype, dh):
    g = torch.Generator(device=card).manual_seed(dh)
    B, T, H, Kh = 2, 300, 4, 2
    q = torch.randn((B, T, H, dh), generator=g, device=card).to(dtype)
    k, v = (torch.randn((B, T, Kh, dh), generator=g, device=card).to(dtype)
            for _ in range(2))
    out, lse = fa_ops._forward(q, k, v, True, with_lse=True)
    plain_out, plain_lse = flash_attention_fwd_ref(q, k, v)
    assert torch.equal(out, fa_ops._forward(q, k, v, True, False)[0])
    assert float((lse - plain_lse).abs().max()) < 1e-3


@pytest.mark.gpu
def test_flash_autograd_on_the_card(card):
    q, k, v = (torch.randn((1, 96, 4, 64), device=card).bfloat16()
               .requires_grad_() for _ in range(3))
    out = fa_ops.flash_attention(q, k, v)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    before = fa_ops.bwd_launches
    out.float().square().sum().backward()
    assert fa_ops.bwd_launches == before + 1
    assert all(t.grad is not None and t.grad.abs().sum() > 0
               for t in (q, k, v))
    with pytest.raises(NotImplementedError, match="f32"):
        fa_ops.flash_attention(*(t.detach().float().requires_grad_()
                                 for t in (q, k, v)))


@pytest.mark.gpu
@pytest.mark.parametrize("D", [7, 16, 64])
def test_spmm_transposed_launch_against_plain(card, D):
    g = torch.Generator(device=card).manual_seed(D)
    n, e = 500, 4000
    src = torch.randint(-5, n + 5, (e,), generator=g, device=card,
                        dtype=torch.int32)
    dst = torch.sort(torch.randint(-3, n + 3, (e,), generator=g,
                                   device=card, dtype=torch.int32))[0]
    x = torch.randn((n, D), generator=g, device=card).requires_grad_()
    coeff = torch.randn((e,), generator=g, device=card).requires_grad_()
    gout = torch.randn((n, D), generator=g, device=card)
    before = spmm_ops.bwd_launches
    with pytest.raises(ValueError, match="transposed="):
        spmm_ops.spmm_sorted_coo(x, src, dst, n, coeff)
    tr = spmm_ops.transpose_edges(src, dst, n, n)
    out = spmm_ops.spmm_sorted_coo(x, src, dst, n, coeff, transposed=tr)
    dx, dc = torch.autograd.grad(out, (x, coeff), gout)
    assert spmm_ops.bwd_launches == before + 1
    want_dx, want_dc = spmm_sorted_coo_bwd_ref(gout, x.detach(), src, dst,
                                               n, coeff.detach())
    assert scaled(dx, want_dx) <= 1e-4
    assert scaled(dc, want_dc) <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
def test_bag_backward_kernel_against_plain(card, combiner, weighted):
    g = torch.Generator(device=card).manual_seed(7)
    vocabs, B, L, D = (1000, 37, 5000), 257, 4, 64
    tables = [torch.randn((v, D), generator=g, device=card) for v in vocabs]
    idx = torch.stack([torch.randint(-v, v, (B, L), generator=g, device=card)
                       for v in vocabs], 1).to(torch.int32)
    idx[0, 0, 0] = 10 ** 6                     # a dropped lookup
    w = torch.rand((B, len(vocabs), L), generator=g, device=card) \
        if weighted else None
    gout = torch.randn((B, len(vocabs), D), generator=g, device=card)
    before = bag_ops.bwd_launches
    got = bag_ops.launch_bwd(tables, idx, gout, w, combiner)
    again = bag_ops.launch_bwd(tables, idx, gout, w, combiner)
    assert bag_ops.bwd_launches == before + 2
    want = embedding_bags_bwd_ref(vocabs, idx, gout, w, combiner)
    for a, b, c in zip(got, again, want):
        assert torch.equal(a, b)
        assert scaled(a, c) <= 1e-5


def same_bits(got, want) -> bool:
    return len(got) == len(want) and all(
        a.shape == b.shape and torch.equal(a.contiguous().view(torch.int32),
                                           b.contiguous().view(torch.int32))
        for a, b in zip(got, want))


def bag_bwd_case(card, vocabs, B, L, D, seed, weighted=False):
    """(tables, indices, gout, weights) with negative indices, a dropped
    lookup and two hot rows: field 0's last row at the first two lookups
    of every bag, and, with two fields or more, field 1's row 3 at every
    lookup of every other bag (both over several segments at B = 257)."""
    g = torch.Generator(device=card).manual_seed(seed)
    tables = [torch.randn((v, D), generator=g, device=card) for v in vocabs]
    idx = torch.stack([torch.randint(-v, v, (B, L), generator=g,
                                     device=card) for v in vocabs],
                      1).to(torch.int32)
    if B and L:
        idx[0, 0, 0] = 10 ** 6
        idx[:, 0, :2] = -1
        if len(vocabs) > 1:
            idx[::2, 1, :] = 3
    w = torch.rand((B, len(vocabs), L), generator=g, device=card) \
        if weighted else None
    gout = torch.randn((B, len(vocabs), D), generator=g, device=card)
    return tables, idx, gout, w


@pytest.mark.gpu
@pytest.mark.parametrize("D", [5, 64, 200, 520])
@pytest.mark.parametrize("combiner,weighted", [("sum", False),
                                               ("mean", True),
                                               ("sum", True)])
def test_bag_backward_is_the_ordered_sum(card, D, combiner, weighted):
    vocabs = (1000, 37, 5000)
    tables, idx, gout, w = bag_bwd_case(card, vocabs, 257, 4, D, D,
                                        weighted)
    before = bag_ops.bwd_launches, bag_ops.bwd_key_launches
    got = bag_ops.launch_bwd(tables, idx, gout, w, combiner)
    again = bag_ops.launch_bwd(tables, idx, gout, w, combiner)
    assert (bag_ops.bwd_launches, bag_ops.bwd_key_launches) == (
        before[0] + 2, before[1] + 2)
    want = embedding_bags_bwd_ordered(vocabs, idx, gout, w, combiner,
                                      segment=SEGMENT)
    assert same_bits(got, want)
    assert same_bits(again, got)
    plain = embedding_bags_bwd_ref(vocabs, idx, gout, w, combiner)
    for a, c in zip(got, plain):
        assert scaled(a, c) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("vocabs,B,L,combiner", [
    ((300,), 257, 4, "sum"),            # F = 1
    ((50, 9000), 300, 1, "mean"),       # L = 1
    ((70, 20, 6000), 200, 3, "mean"),   # L = 3: no shift for the division
    ((1000, 37, 5000), 0, 4, "sum"),    # an empty batch
    ((8, 3), 129, 2, "sum")])           # tables far smaller than the batch
def test_bag_backward_edge_batches(card, vocabs, B, L, combiner):
    tables, idx, gout, _ = bag_bwd_case(card, vocabs, B, L, 64, 3)
    got = bag_ops.launch_bwd(tables, idx, gout, None, combiner)
    assert same_bits(got, embedding_bags_bwd_ordered(vocabs, idx, gout, None,
                                                     combiner))
    assert [tuple(a.shape) for a in got] == [(v, 64) for v in vocabs]


@pytest.mark.gpu
def test_bag_backward_with_every_lookup_dropped(card):
    vocabs = (100, 30)
    tables, idx, gout, _ = bag_bwd_case(card, vocabs, 65, 4, 8, 5)
    idx[:] = -10 ** 6
    got = bag_ops.launch_bwd(tables, idx, gout, None, "mean")
    assert same_bits(got, [torch.zeros((v, 8), device=card)
                           for v in vocabs])


@pytest.mark.gpu
def test_bag_backward_keys_are_the_plain_sort(card):
    vocabs = (1000, 37, 5000)
    tables, idx, _, _ = bag_bwd_case(card, vocabs, 257, 4, 64, 9)
    keys, pos, total = bag_ops.bwd_keys(bag_ops.prepare_tables(tables), idx)
    want_keys, want_pos, order = bwd_keys_ref(vocabs, idx)
    assert total == sum(vocabs)
    assert keys.dtype == pos.dtype == torch.int32
    assert torch.equal(keys, want_keys[order])
    assert torch.equal(pos, want_pos[order])


@pytest.mark.gpu
def test_bag_backward_writes_zeros_over_a_poisoned_allocator(card):
    vocabs = (4096, 37, 20000)
    tables, idx, gout, _ = bag_bwd_case(card, vocabs, 257, 4, 64, 11)
    torch.cuda.synchronize()
    poison = torch.full((sum(vocabs), 64), float("nan"), device=card)
    ptr = poison.data_ptr()
    del poison
    got = bag_ops.launch_bwd(tables, idx, gout)
    assert got[0].data_ptr() == ptr        # the freed NaN buffer, reused
    want = embedding_bags_bwd_ordered(vocabs, idx, gout)
    assert same_bits(got, want)
    untouched = [(b == 0).all(1) for b in want]
    assert sum(int(u.sum()) for u in untouched) > 0
    for a, u in zip(got, untouched):
        assert (a[u].view(torch.int32) == 0).all()
