"""The port's flash-attention wrapper (its plain version, on the CPU)
against the JAX package: the Pallas kernel in interpret mode, the oracle
``attention_ref`` and the model's ``flash_attention_xla``.

Inputs are made with numpy from a seed.  Tolerances, entry by entry:
2e-5 x (|ref| + 1) in f32, as ``tests/test_kernels.py`` holds the Pallas
kernel (the sums run in another order); 2e-2 x (|ref| + median |ref|) in
bf16 (the output is rounded to bf16 once; held to the typical output, as
a row t averages some t / e keys and the first rows are many times
larger); ``flash_attention_xla`` also rounds ``q * scale``, k, v and the
probabilities to bf16, so it is held to 2e-2 x (|ref| + 1) from f32
inputs.  ``attention_ref`` aligns the causal
diagonal at the end of the keys, the Pallas kernel and the port at the
start: they agree only when Tq == Tk, so the Tq != Tk cases are held to
the Pallas kernel alone.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import (attention_reference,
                                               flash_attention as j_flash)
from repro.models.transformer import flash_attention_xla
from repro_torch.kernels.flash_attention import ops

SWEEP = [(1, 128, 4, 4, 64),      # the sweep of tests/test_kernels.py
         (2, 256, 8, 2, 64),
         (1, 256, 4, 1, 128),
         (2, 128, 8, 4, 32),
         (1, 128, 32, 8, 64),     # llama3.2-1b heads
         (1, 128, 32, 8, 128),
         (1, 128, 16, 8, 64),     # qwen3-1.7b heads
         (1, 128, 16, 8, 128),
         (1, 128, 24, 2, 64),     # starcoder2-3b heads
         (1, 128, 24, 2, 128)]
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def inputs(B, Tq, H, Kh, dh, dtype, Tk=None, seed=0):
    rng = np.random.default_rng(seed)
    Tk = Tq if Tk is None else Tk
    arrays = [rng.standard_normal(s).astype(np.float32) for s in
              ((B, Tq, H, dh), (B, Tk, Kh, dh), (B, Tk, Kh, dh))]
    torch_in = [torch.from_numpy(a).to(dtype) for a in arrays]
    jax_in = [jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
        for t in torch_in]
    return torch_in, jax_in


def close(got, want, tol, bf16_out=False):
    """|got - want| <= tol x (|want| + a) entry by entry: a = median
    |want| for a bf16 output, else 1."""
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    a = float(np.median(np.abs(want))) if bf16_out else 1.0
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * a)


@pytest.mark.parametrize("B,T,H,Kh,dh", SWEEP)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_vs_pallas_and_oracle(B, T, H, Kh, dh, dtype):
    (q, k, v), (jq, jk, jv) = inputs(B, T, H, Kh, dh, dtype, seed=T + dh)
    before = ops.launches
    got = ops.flash_attention(q, k, v, causal=True)
    assert got.dtype == dtype and ops.launches == before   # no kernel here
    bf16 = dtype == torch.bfloat16
    close(got, j_flash(jq, jk, jv, causal=True, interpret=True),
          TOL[dtype], bf16)
    close(got, attention_reference(jq, jk, jv, causal=True), TOL[dtype],
          bf16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_limit_rejects_planted_faults(dtype):
    """The limit above fails an output that reads the next KV head, and
    one whose rows past T/2 see only the nearer half of the keys."""
    (q, k, v), _ = inputs(1, 1024, 8, 2, 64, dtype, seed=5)
    want = ops.flash_attention(q, k, v)
    faults = [ops.flash_attention(q, k.roll(1, dims=2).contiguous(),
                                  v.roll(1, dims=2).contiguous()),
              torch.cat([want[:, :512], ops.flash_attention(
                  *(t[:, 512:].contiguous() for t in (q, k, v)))], dim=1)]
    for bad in faults:
        with pytest.raises(AssertionError):
            close(bad, want.float(), TOL[dtype], dtype == torch.bfloat16)


@pytest.mark.parametrize("Tq,Tk", [(128, 256), (256, 128)])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_vs_pallas_unequal_lengths(Tq, Tk, causal):
    (q, k, v), (jq, jk, jv) = inputs(1, Tq, 8, 2, 64, torch.float32, Tk=Tk,
                                     seed=Tq)
    close(ops.flash_attention(q, k, v, causal=causal),
          j_flash(jq, jk, jv, causal=causal, interpret=True), 2e-5)


@pytest.mark.parametrize("B,T,H,Kh,dh", [(2, 128, 4, 2, 32),
                                         (1, 100, 8, 2, 64),    # ragged
                                         (1, 77, 16, 8, 128)])
def test_plain_vs_model_xla_path(B, T, H, Kh, dh):
    """``flash_attention_xla`` pads a ragged T to its chunk; the port's
    kernel masks the edge instead (the Pallas wrapper asserts T % tile
    == 0)."""
    (q, k, v), (jq, jk, jv) = inputs(B, T, H, Kh, dh, torch.float32,
                                     seed=T)
    close(ops.flash_attention(q, k, v, causal=True),
          flash_attention_xla(jq, jk, jv, causal=True, chunk=32), 2e-2)


def test_wrapper_checks_on_the_cpu():
    q = torch.zeros(1, 8, 4, 64)
    k = torch.zeros(1, 8, 2, 64)
    with pytest.raises(ValueError, match="one dtype"):
        ops.flash_attention(q, k.bfloat16(), k.bfloat16())
    with pytest.raises(ValueError, match="one dtype"):
        ops.flash_attention(q.half(), k.half(), k.half())
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(q.transpose(1, 2), k, k)
    with pytest.raises(ValueError, match="head width"):
        ops.flash_attention(q[..., :48].contiguous(),
                            k[..., :48].contiguous(),
                            k[..., :48].contiguous())
    k3 = torch.zeros(1, 8, 3, 64)
    with pytest.raises(ValueError, match="group"):
        ops.flash_attention(q, k3, k3)
    with pytest.raises(ValueError, match="fit q"):
        ops.flash_attention(q, k, k[:, :4].contiguous())
    with pytest.raises(ValueError, match="empty"):
        ops.flash_attention(q[:, :0], k, k)
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.flash_attention(q.to("meta"), k.to("meta"), k.to("meta"))
