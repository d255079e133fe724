"""The arithmetic of the 3xTF32 flash-attention kernel, on the CPU.

``csrc/flash_attention_tf32.cuh`` computes the f32 forward on the tensor
cores as three TF32 products of split operands (hi = tf32(x), lo =
tf32(x - hi)) for each of Q K^T and P V.  A CUDA kernel has no CPU mode,
so ``ref.flash_attention_tf32x3`` carries that arithmetic in plain
PyTorch (tf32 rounding by bit operations on f32), and these tests hold
it against the JAX package's Pallas kernel in interpret mode, as
``tests/test_kernels.py`` runs it, on inputs made with numpy from a seed:
entry by entry within 2e-5 x (|ref| + 1), the limit f32 is held to on the
card, at the three head layouts of ``chip_smoke.py``'s phase 13 (llama3.2-1b,
qwen3-1.7b, starcoder2-3b) at T = 256, causal and not.  One TF32 product
(hi x hi alone) misses that limit at the same inputs, so the limit tells
the two apart.  The kernel reads the keys of each group of 8 in the
order 0 2 4 6 1 3 5 7 (P's A fragment is then the accumulator as it
lies): the same order applied to P and V gives the same output, to P
alone a wrong one.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as j_flash
from repro_torch.kernels.flash_attention.ref import (flash_attention_ref,
                                                     flash_attention_tf32x3,
                                                     key_order, tf32,
                                                     tf32_split)

TOL = 2e-5
HEADS = [(32, 8, 64),       # llama3.2-1b
         (16, 8, 128),      # qwen3-1.7b
         (24, 2, 128)]      # starcoder2-3b


def inputs(T, H, Kh, dh, seed):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s).astype(np.float32) for s in
              ((1, T, H, dh), (1, T, Kh, dh), (1, T, Kh, dh))]
    return [torch.from_numpy(a) for a in arrays], [jnp.asarray(a)
                                                   for a in arrays]


def excess(got, want) -> float:
    """The largest |got - want| / (2e-5 (|want| + 1)) over the entries."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float((np.abs(got - want) / (TOL * (np.abs(want) + 1))).max())


@pytest.fixture(scope="module")
def pallas():
    """{(head layout, causal): (torch inputs, the Pallas output)}, T =
    256, each computed once."""
    out = {}
    for i, (H, Kh, dh) in enumerate(HEADS):
        for causal in (True, False):
            (q, k, v), (jq, jk, jv) = inputs(256, H, Kh, dh, seed=40 + i)
            out[(H, Kh, dh), causal] = (q, k, v), np.asarray(
                j_flash(jq, jk, jv, causal=causal, interpret=True))
    return out


@pytest.mark.parametrize("heads", HEADS)
@pytest.mark.parametrize("causal", [True, False])
def test_tf32x3_within_the_f32_limit_of_pallas(pallas, heads, causal):
    (q, k, v), want = pallas[heads, causal]
    got = flash_attention_tf32x3(q, k, v, causal)
    assert excess(got, want) <= 1
    # and of the plain version the card holds the kernel to
    assert excess(got, flash_attention_ref(q, k, v, causal)) <= 1


@pytest.mark.parametrize("heads", HEADS)
@pytest.mark.parametrize("causal", [True, False])
def test_one_tf32_product_misses_the_limit(pallas, heads, causal):
    (q, k, v), want = pallas[heads, causal]
    assert excess(flash_attention_tf32x3(q, k, v, causal, terms=1),
                  want) > 1


@pytest.mark.parametrize("heads", HEADS)
def test_key_order_inside_groups_of_8(pallas, heads):
    """P and V^T with their keys in the kernel's order inside each group
    of 8: the same output, up to the order of the f32 sums; P alone in
    that order: over the limit."""
    (q, k, v), want = pallas[heads, True]
    order = key_order(256)
    assert sorted(order.tolist()) == list(range(256))
    assert order[:8].tolist() == [0, 2, 4, 6, 1, 3, 5, 7]
    plain = flash_attention_tf32x3(q, k, v)
    got = flash_attention_tf32x3(q, k, v, order=order)
    assert float((got - plain).abs().max()) <= 1e-6
    assert excess(got, want) <= 1
    wrong = flash_attention_tf32x3(q, k, v, order=order,
                                   v_order=torch.arange(256))
    assert excess(wrong, want) > 1


def test_tf32_split_by_bits():
    """hi and lo have their low 13 bits 0; hi is x rounded to 11
    significant bits (ties away from 0); hi + lo is within 2^-21 |x|."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(np.concatenate([
        rng.standard_normal(4096), rng.standard_normal(4096) * 1e-6,
        rng.standard_normal(4096) * 1e6]).astype(np.float32))
    hi, lo = tf32_split(x)
    for t in (hi, lo):
        assert not (t.view(torch.int32) & 0x1FFF).any()
    # to nearest at 11 significant bits, computed in float64
    xd = x.double().numpy()
    m, e = np.frexp(xd)
    want = np.ldexp(np.sign(m) * np.floor(np.abs(m) * 2 ** 11 + 0.5),
                    e - 11)
    np.testing.assert_array_equal(hi.double().numpy(), want)
    assert float(((hi.double() + lo.double() - x.double()).abs()
                  / x.double().abs()).max()) <= 2 ** -21
    # ties go away from 0
    tie = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 3 * 2 ** -11])
    assert tf32(tie).tolist() == [1 + 2 ** -10, -(1 + 2 ** -10),
                                  1 + 2 ** -9]
