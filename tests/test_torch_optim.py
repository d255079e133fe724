"""The port's optimizer and gradient compression (``repro_torch.optim``)
against the JAX package's (``repro.optim``), on the CPU.

Inputs are numpy draws from a seed, handed to both.  Tolerances:

* ``adamw_update`` over three steps (parameters, both moments, the step
  and the global norm) and ``schedule``: 1e-6 relative (both run the
  same f32 operations in the same order; the CPU kernels may still
  round a product differently);
* compression: ``q``, ``scale`` and ``pad`` equal, and the residuals
  equal bit for bit (``torch.round`` and ``jnp.round`` both round half
  to even, and every other step is one IEEE operation).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro.optim import compression as jcomp
from repro_torch.optim import adamw, compression


def rel_close(got, want, rtol=1e-6):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(
        1e-30, float(np.abs(want).max(initial=0.0))))


def tree(seed):
    rng = np.random.default_rng(seed)
    return dict(a=rng.standard_normal((4, 5)).astype(np.float32),
                b=[rng.standard_normal((7,)).astype(np.float32),
                   rng.standard_normal((2, 3, 2)).astype(np.float32)])


def to_torch(t):
    if isinstance(t, dict):
        return {k: to_torch(v) for k, v in t.items()}
    if isinstance(t, list):
        return [to_torch(v) for v in t]
    return torch.tensor(t)


@pytest.mark.parametrize("clip", [1.0, 100.0])
def test_adamw_three_steps_match_jax(clip):
    cfg_kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=clip)
    jcfg, tcfg = jadamw.AdamWConfig(**cfg_kw), adamw.AdamWConfig(**cfg_kw)
    p = tree(0)
    jp = jax.tree.map(jnp.asarray, p)
    tp = to_torch(p)
    jopt, topt = jadamw.init_adamw(jp), adamw.init_adamw(tp)
    for s in range(3):
        g = tree(10 + s)
        jp, jopt, jn = jadamw.adamw_update(
            jcfg, jax.tree.map(jnp.asarray, g), jopt, jp)
        tp2, topt, tn = adamw.adamw_update(tcfg, to_torch(g), topt, tp)
        assert tp2 is tp                     # updated in place
        rel_close(tn, jn)
        assert int(topt.step) == int(jopt.step) == s + 1
        assert topt.step.dtype == torch.int32
        for name, jt, tt in (("params", jp, tp), ("m", jopt.m, topt.m),
                             ("v", jopt.v, topt.v)):
            for a, b in zip(jax.tree.leaves(tt), jax.tree.leaves(jt)):
                rel_close(a, b)


def test_schedule_matches_jax():
    for kw in (dict(), dict(warmup_steps=100, total_steps=1000),
               dict(warmup_steps=0, total_steps=5, min_lr_frac=0.0)):
        jc, tc = jadamw.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
        for step in (0, 1, 99, 100, 101, tc.total_steps):
            want = jadamw.schedule(jc, jnp.int32(step))
            got = adamw.schedule(tc, torch.tensor(step, dtype=torch.int32))
            assert got.dtype == torch.float32
            rel_close(got, want)


def test_global_norm_and_init():
    p = tree(3)
    rel_close(adamw.global_norm(to_torch(p)),
              jadamw.global_norm(jax.tree.map(jnp.asarray, p)))
    st = adamw.init_adamw(to_torch(p))
    assert int(st.step) == 0 and all(
        float(x.abs().sum()) == 0 for x in jax.tree.leaves(st.m)
        + jax.tree.leaves(st.v))


def test_adamw_optimizes_quadratic():
    """``tests/test_streams_and_data.py::test_adamw_optimizes_quadratic``,
    on the port."""
    cfg = adamw.AdamWConfig(lr=0.1, warmup_steps=5, total_steps=200,
                            weight_decay=0.0)
    params = dict(w=torch.tensor([3.0, -2.0]))
    opt = adamw.init_adamw(params)

    def loss(p):
        return torch.sum(torch.square(p["w"] - 1.0))
    for _ in range(150):
        w = params["w"].detach().requires_grad_()
        (g,) = torch.autograd.grad(loss(dict(w=w)), w)
        params, opt, _ = adamw.adamw_update(cfg, dict(w=g), opt, params)
    assert float(loss(params)) < 1e-2


@pytest.mark.parametrize("n,block", [(257, 256), (1000, 64), (512, 256)])
def test_quantize_matches_jax_bit_for_bit(n, block):
    rng = np.random.default_rng(n)
    x = (rng.standard_normal(n) * 3).astype(np.float32)
    x[:5] = [0.5, -0.5, 1.5, 2.5, 0.0]        # round half to even
    jq, js, jpad = jcomp.quantize_int8(jnp.asarray(x), block)
    tq, ts, tpad = compression.quantize_int8(torch.from_numpy(x), block)
    assert tpad == jpad
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        compression.dequantize_int8(tq, ts, tpad, (n,)).numpy(),
        np.asarray(jcomp.dequantize_int8(jq, js, jpad, (n,))))


def test_compression_with_feedback_matches_jax_bit_for_bit():
    g0 = tree(20)
    jres = jcomp.init_residuals(jax.tree.map(jnp.asarray, g0))
    tres = compression.init_residuals(to_torch(g0))
    for s in range(4):
        g = tree(21 + s)
        jcmp, jres = jcomp.compress_with_feedback(
            jax.tree.map(jnp.asarray, g), jres)
        tcmp, tres = compression.compress_with_feedback(to_torch(g), tres)
        for a, b in zip(jax.tree.leaves(tres), jax.tree.leaves(jres)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        jdq = jcomp.decompress(jcmp, jax.tree.map(jnp.asarray, g))
        tdq = compression.decompress(tcmp, to_torch(g))
        for a, b in zip(jax.tree.leaves(tdq), jax.tree.leaves(jdq)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        # (q, scale, pad) leaf by leaf
        jl = jax.tree.leaves(jcmp, is_leaf=lambda x: isinstance(x, tuple))
        tl = jax.tree.leaves(tcmp, is_leaf=lambda x: isinstance(x, tuple))
        for (tq, ts, tp), (jq, js, jp) in zip(tl, jl):
            assert tp == jp
            np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
            np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_compression_error_feedback_contract():
    """``tests/test_fault_tolerance.py::test_compression_error_feedback``
    on the port: the compressed sum plus the residual tracks the true
    sum, and the residual stays bounded."""
    rng = np.random.default_rng(0)
    res = compression.init_residuals(dict(w=torch.zeros(257)))
    total_true, total_comp = np.zeros(257), np.zeros(257)
    for _ in range(30):
        g = dict(w=torch.from_numpy(rng.standard_normal(257).astype(
            np.float32)))
        comp, res = compression.compress_with_feedback(g, res)
        deq = compression.decompress(comp, g)
        total_true += g["w"].numpy()
        total_comp += deq["w"].numpy()
    scale = np.abs(total_true).max()
    assert np.abs(total_true - (total_comp + res["w"].numpy())).max() \
        < 1e-3 * max(scale, 1.0)
    assert res["w"].abs().max() < 0.1
