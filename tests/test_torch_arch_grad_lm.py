"""Every LM arch of the registry: the port's grad step against JAX's, on the
CPU, at the registry's smoke size (``_smoke``: 2 layers, d_model 64), as
``tests/test_arch_smoke.py`` runs it: ``lm_loss`` on B = 2, T = 32 tokens
(targets the tokens rolled by one), its value and the gradient of every
parameter leaf.

The port runs the configs as they are (bf16 compute) through its
attention Function's plain backward.  The yardstick is JAX's gradient in
f32: ``compute_dtype`` f32 and ``flash_attention_xla`` swapped (by
``monkeypatch``; the JAX source is not edited) for ``attention_ref`` in
f32, which is what the port's attention computes and differentiates.
The limit: for the loss and each leaf, the port's
distance from that f32 gradient (max |d| over max |ref|) is at most
max(1e-3, 2 x) JAX's own bf16 gradient's distance from it, so the port
in bf16 is no worse than JAX in bf16.  The MoE archs run with
``capacity_factor`` = E, where no (token, k) pair is dropped (the port's
``moe_dropped`` is held to 0): JAX's two MoE paths and the port agree
only there.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import attention_ref
from repro.models import transformer as jtr
from repro_torch.models import transformer
from repro_torch.train.checkpoint import _flatten_with_names
from test_torch_transformer import ALL, carried, configs, tokens

MOE = ("PHI35_MOE", "ARCTIC")


def no_drop(cfg):
    return dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts)) \
        if cfg.n_experts else cfg


def jax_grads(jcfg, jp, batch, f32):
    if f32:
        jcfg = dataclasses.replace(jcfg, compute_dtype=jnp.float32)
    return jax.value_and_grad(lambda p: jtr.lm_loss(jcfg, p, batch))(jp)


def port_grads(tcfg, tp, batch):
    leaves = [t.requires_grad_() for t in jax.tree.leaves(tp)]
    loss = transformer.lm_loss(tcfg, tp, batch)
    return loss, torch.autograd.grad(loss, leaves)


def dist(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("arch", ALL)
def test_lm_grad_step_matches_jax(arch, monkeypatch):
    jcfg, tcfg = (no_drop(c) for c in configs(arch))
    jp, tp = carried(jcfg, tcfg)
    tok = tokens(tcfg, 2, 32)
    jb = dict(tokens=jnp.asarray(tok), targets=jnp.roll(tok, -1, 1))
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in jb.items()}
    j_loss, j_grads = jax_grads(jcfg, jp, jb, f32=False)
    monkeypatch.setattr(jtr, "flash_attention_xla",
                        lambda q, k, v, causal=True, chunk=512:
                        attention_ref(q, k, v, causal=causal))
    r_loss, r_grads = jax_grads(jcfg, jp, jb, f32=True)
    transformer.reset_moe_dropped()
    t_loss, t_grads = port_grads(tcfg, tp, tb)
    assert transformer.moe_dropped() == 0
    lim = max(1e-3, 2 * dist(j_loss, r_loss))
    assert dist(t_loss.item(), r_loss) <= lim, (t_loss.item(), r_loss)
    names = [n for n, _ in _flatten_with_names(jax.tree.map(np.asarray,
                                                            jp))]
    bad = {}
    for name, t, r, j in zip(names, t_grads, jax.tree.leaves(r_grads),
                             jax.tree.leaves(j_grads)):
        assert t.shape == r.shape and t.dtype == torch.float32, name
        got, own = dist(t.numpy(), r), dist(j, r)
        if got > max(1e-3, 2 * own):
            bad[name] = (got, own)
    assert not bad, bad


def test_remat_recomputes_the_same_gradient():
    """``cfg.remat`` (each layer under ``torch.utils.checkpoint``) gives
    the gradients of the plain forward bit for bit on the CPU, and keeps
    no layer's activations: its saved tensors are the layer inputs."""
    _, tcfg = configs("LLAMA32_1B")
    _, tp = carried(*configs("LLAMA32_1B"))
    tok = torch.from_numpy(tokens(tcfg, 2, 32))
    tb = dict(tokens=tok, targets=torch.roll(tok, -1, 1))
    loss0, g0 = port_grads(tcfg, tp, tb)
    loss1, g1 = port_grads(dataclasses.replace(tcfg, remat=True), tp, tb)
    assert torch.equal(loss0, loss1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


def test_ct_cast_casts_the_cotangent():
    x = torch.ones(3, dtype=torch.bfloat16, requires_grad=True)
    y = transformer.ct_cast(x)
    (g,) = torch.autograd.grad(y.float().sum() * 3.0, x)
    assert g.dtype == torch.bfloat16 and torch.equal(
        g, torch.full((3,), 3.0, dtype=torch.bfloat16))
    with torch.no_grad():
        assert transformer.ct_cast(x) is x
