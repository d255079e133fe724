"""The port's MoE LM forward against the JAX package's, on the CPU: the
phi3.5-moe and arctic smoke configs (``_smoke``: 4 experts, top 2;
arctic with its ``dense_residual`` FFN), ``lm_forward`` (logits and aux),
``lm_loss`` (aux included, 0.01 x aux / n_layers) and teacher-forced
``lm_decode_step`` over ragged lengths, at the tolerances of
``tests/test_torch_transformer.py`` (f32 1e-4 with both packages'
attention swapped for f32, bf16 3e-2; the helpers are that file's).

The routing of every layer is held too (``jax.lax.top_k`` recorded by
``monkeypatch`` on the JAX side, ``transformer._route`` wrapped on the
port's): in f32 the same experts in the same order for every token; in
bf16 the same experts, their order swapped only on a near-tie of JAX's
gates, so the tolerance is never passed by a token routed elsewhere.
The bf16 aux is held within 1e-2: a swapped order moves a token's
count from one expert to the other in ``frac_t`` (1 / S of it).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as jtr
from repro_torch.models import transformer
from test_torch_transformer import (TOL, carried, close, configs,  # noqa
                                    f32_attention, teacher_forced, tokens)

MOE = ["PHI35_MOE", "ARCTIC"]


@pytest.fixture
def routes(monkeypatch):
    """Every layer's gates and top-k indices, JAX's and the port's, in
    call order (JAX's read by an ordered host callback, its forward being
    a scan)."""
    seen = {"jax": [], "torch": []}
    top_k, route = jax.lax.top_k, transformer._route

    def keep(which, gates, topi):
        seen[which].append((np.asarray(gates), np.asarray(topi)))

    def j_top_k(x, k):
        v, i = top_k(x, k)
        jax.debug.callback(lambda g, i: keep("jax", g, i), x, i,
                           ordered=True)
        return v, i

    def t_route(*a):
        out = route(*a)
        keep("torch", out[0], out[2])
        return out
    monkeypatch.setattr(jax.lax, "top_k", j_top_k)
    monkeypatch.setattr(transformer, "_route", t_route)
    return seen


def same_routes(seen, exact):
    """Every token chose the same experts in both packages.  ``exact``:
    in the same order too; else the order of two experts may differ
    where JAX's gates of the two are within 1e-2 (a near-tie that the
    bf16 hidden states' rounding may turn either way; the set, and so
    the output, is the same where no capacity drops)."""
    assert len(seen["jax"]) == len(seen["torch"]) > 0
    for (jg, j), (_, t) in zip(seen["jax"], seen["torch"]):
        if exact:
            np.testing.assert_array_equal(t, j)
            continue
        np.testing.assert_array_equal(np.sort(t, -1), np.sort(j, -1))
        for s in np.nonzero((t != j).any(-1))[0]:
            g = jg[s, j[s]]
            assert g.max() - g.min() < 1e-2, (s, j[s], t[s], g)
    seen["jax"].clear()
    seen["torch"].clear()


def forward_and_loss(arch, dtype, seed, T):
    jc, tc = configs(arch, dtype)
    assert tc.n_experts == 4 and tc.dense_residual == (arch == "ARCTIC")
    jp, tp = carried(jc, tc, seed=seed)
    tok = tokens(jc, 2, T, seed=seed + 2)
    tgt = tokens(jc, 2, T, seed=seed + 3)
    want, jaux = jtr.lm_forward(jc, jp, jnp.asarray(tok))
    got, aux = transformer.lm_forward(tc, tp, torch.from_numpy(tok))
    batch = dict(tokens=tok, targets=tgt)
    loss = transformer.lm_loss(tc, tp, {k: torch.from_numpy(v)
                                        for k, v in batch.items()})
    jloss = jtr.lm_loss(jc, jp, {k: jnp.asarray(v) for k, v in batch.items()})
    return (got, want), (aux, jaux), (loss, jloss)


@pytest.mark.parametrize("arch", MOE)
def test_moe_lm_forward_and_loss_f32(arch, f32_attention, routes):
    logits, aux, loss = forward_and_loss(arch, "f32", 0, 24)
    same_routes(routes, exact=True)
    close(*logits, TOL["f32"])
    # aux: a sum over the layers of E * sum(frac_t * frac_p), about 1 each
    assert 0.5 * 2 < float(aux[0]) < 4 * 2
    close(*aux, 1e-5)
    close(*loss, TOL["f32"])


@pytest.mark.parametrize("arch", MOE)
def test_moe_lm_forward_and_loss_bf16(arch, routes):
    logits, aux, loss = forward_and_loss(arch, "bf16", 1, 40)
    same_routes(routes, exact=False)
    assert logits[0].dtype == torch.bfloat16
    close(*logits, TOL["bf16"])
    close(*aux, 1e-2)
    close(*loss, TOL["bf16"])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", MOE)
def test_moe_decode_teacher_forced(arch, dtype, request, routes):
    if dtype == "f32":
        request.getfixturevalue("f32_attention")
    jc, tc = configs(arch, dtype)
    jp, tp = carried(jc, tc, seed=2)
    steps, tcache, jcache = teacher_forced(jc, tc, jp, tp)
    same_routes(routes, exact=dtype == "f32")
    for tl, jl in steps:
        close(tl, jl, TOL[dtype])
    for t, j in zip(tcache, jcache):
        close(t.float(), np.asarray(j, np.float32), max(TOL[dtype], 2e-2))
