"""The port's MoE FFN (``repro_torch.models.transformer``: ``_route``,
``_ffn_moe``, ``_ffn_moe_ref``) against the JAX package's ``_ffn_moe``, on
the CPU.

Parameters come from JAX's ``init_lm_params`` (the phi3.5-moe and arctic
smoke configs, widened to 8 experts), carried across as numpy; the layer
inputs are made with numpy from a seed.  JAX's routing is read where its
``_ffn_moe`` computes it: ``jax.lax.top_k`` is wrapped, by
``monkeypatch``, to record its gates and indices (the JAX source is not
edited).  Tolerances:

* routing: ``topi`` equal exactly, ties included (the router's columns
  are planted in pairs so that tokens tie at the top-k boundary); the
  f32 gates within 1e-6 (the two libraries' ``exp`` and sums round
  differently) wherever the router logits are equal; in bf16 a token's
  logit now and then rounds to the neighbouring bf16 number in one
  library (other f32 sums), and that token's gates differ by up to
  2e-3; the slots and ``keep`` equal exactly;
* the output, f32 compute: 1e-5 x max(1, max |ref|);
* bf16 compute: one bf16 step of the largest |out| (2^(e - 7) for a
  largest |out| in [2^e, 2^(e+1))), with the routing asserted equal on
  every seed: the two round the expert products' bf16 outputs at other
  places, and each output rounds once;
* ``_ffn_moe_ref`` (the [S, E, cap] einsums) and ``_ffn_moe`` (index
  dispatch): in bf16 equal bit for bit on the CPU (each dispatched row
  has one nonzero term, and the combine sums K = 2 products of bf16
  numbers, exact in f32); in f32, where those products round, within
  1e-6 x max(1, max |ref|).
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import lm_archs as jarchs
from repro.models import transformer as jtr
from repro_torch.configs import lm_archs
from repro_torch.launch import serve
from repro_torch.models import transformer

ARCHS = ["PHI35_MOE", "ARCTIC"]


def configs(arch, dtype="bf16", **kw):
    """JAX's and the port's smoke config of ``arch`` at 8 experts."""
    j = dataclasses.replace(jarchs._smoke(getattr(jarchs, arch)),
                            n_experts=8, **kw)
    t = dataclasses.replace(lm_archs._smoke(getattr(lm_archs, arch)),
                            n_experts=8, **kw)
    if dtype == "f32":
        j = dataclasses.replace(j, compute_dtype=jnp.float32)
        t = dataclasses.replace(t, compute_dtype=torch.float32)
    return j, t


def layer(jc, tc, seed=0, ties=False):
    """Layer 0's parameters of both packages; with ``ties``, router
    columns 1 and 3 copies of 0 and 2 (experts 0 and 1, 2 and 3 tied for
    every token; 4-7 free)."""
    jp = jtr.init_lm_params(jc, jax.random.PRNGKey(seed))
    lp = {k: np.asarray(v[0]) for k, v in jp["layers"].items()}
    if ties:
        lp["router"] = lp["router"].copy()
        lp["router"][:, [1, 3]] = lp["router"][:, [0, 2]]
    return ({k: jnp.asarray(v) for k, v in lp.items()},
            {k: torch.from_numpy(np.array(v)) for k, v in lp.items()})


def inputs(tc, B, T, seed):
    x = np.random.default_rng(seed).standard_normal(
        (B, T, tc.d_model)).astype(np.float32)
    jd = jnp.bfloat16 if tc.compute_dtype == torch.bfloat16 else jnp.float32
    return (jnp.asarray(x).astype(jd),
            torch.from_numpy(x).to(tc.compute_dtype))


@pytest.fixture
def jax_routing(monkeypatch):
    """JAX's gates and top-k indices, as its ``_ffn_moe`` computes them."""
    seen = {}
    top_k = jax.lax.top_k

    def recording(x, k):
        v, i = top_k(x, k)
        seen.update(gates=np.asarray(x), topi=np.asarray(i))
        return v, i
    monkeypatch.setattr(jax.lax, "top_k", recording)
    return seen


def slots_np(topi, E):
    """Each (s, k)'s slot within its expert, counted in (s, k) order."""
    flat, seen = topi.reshape(-1), np.zeros(E, np.int64)
    out = np.empty_like(flat, dtype=np.int64)
    for i, e in enumerate(flat):
        out[i], seen[e] = seen[e], seen[e] + 1
    return out.reshape(topi.shape)


def bf16_step(x) -> float:
    """The spacing of bf16 numbers at the largest |x|."""
    top = float(np.abs(np.asarray(x, np.float32)).max())
    return 2.0 ** (math.floor(math.log2(top)) - 7)


def close(got, want, atol):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_route_matches_jax_with_ties(jax_routing, seed, dtype):
    jc, tc = configs("PHI35_MOE", dtype)
    jlp, tlp = layer(jc, tc, seed, ties=True)
    jx, tx = inputs(tc, 4, 64, seed)
    _, jaux = jtr._ffn_moe(jc, jlp, jx)
    gates, topv, topi, aux = transformer._route(
        tc, tlp, tx.reshape(-1, tc.d_model))
    np.testing.assert_array_equal(topi.numpy(), jax_routing["topi"])
    close(aux, jaux, 1e-6)
    if dtype == "f32":
        close(gates, jax_routing["gates"], 1e-6)
    else:
        # the router product in bf16: the two libraries round a token's
        # f32 sums to the neighbouring bf16 number now and then (its gates
        # then differ by up to ~1e-3); the gates within 1e-6 where the
        # logits are equal, and few tokens where they are not
        jl = np.asarray((jx.reshape(-1, tc.d_model) @ jlp["router"].astype(
            jx.dtype)).astype(jnp.float32))
        tl = (tx.reshape(-1, tc.d_model) @ tlp["router"].to(tx.dtype))
        same = (tl.float().numpy() == jl).all(-1)
        assert same.mean() >= 0.98, f"{(~same).sum()} tokens' logits differ"
        close(gates[same], jax_routing["gates"][same], 1e-6)
        close(gates, jax_routing["gates"], 2e-3)
    want = jax_routing["topi"]
    assert topv.dtype == torch.float32 and topi.shape == want.shape
    # the 1st and 2nd tie where a pair leads, the 2nd and 3rd (the top-k
    # boundary, where torch.topk may keep either) where a pair follows a
    # free expert
    srt = -np.sort(-jax_routing["gates"], axis=-1)
    assert (srt[:, 0] == srt[:, 1]).any()
    assert (srt[:, 1] == srt[:, 2]).any()
    # on a tie the stable sort keeps the lower expert first, as lax.top_k
    lead = torch.from_numpy(srt[:, 0] == srt[:, 1])
    assert (topi[:, 0] < topi[:, 1])[lead].all()


@pytest.mark.parametrize("E", [4, 8, 16, 128])
@pytest.mark.parametrize("S", [1, 7, 300])
def test_slots_by_sort_equal_the_onehot_cumsum(S, E):
    topi = torch.from_numpy(np.stack([
        np.random.default_rng(S * E + s).choice(E, 2, replace=False)
        for s in range(S)]))
    want = slots_np(topi.numpy(), E)
    np.testing.assert_array_equal(transformer._moe_slots(topi, E).numpy(),
                                  want)
    np.testing.assert_array_equal(
        transformer._moe_slots_onehot(topi, E).numpy(), want)


@pytest.mark.parametrize("cf", [1.0, 4.0])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_ffn_moe_matches_jax(jax_routing, arch, dtype, cf):
    jc, tc = configs(arch, dtype, capacity_factor=cf)
    drops = 0
    for seed in (0, 1):
        jlp, tlp = layer(jc, tc, seed)
        jx, tx = inputs(tc, 2, 48, seed + 10)
        want, jaux = jtr._ffn_moe(jc, jlp, jx)
        transformer.reset_moe_dropped()
        got, aux = transformer._ffn_moe(tc, tlp, tx)
        dropped = transformer.moe_dropped()
        assert got.dtype == tc.compute_dtype
        # the routing, the slots and keep: exactly JAX's
        S, E = 2 * 48, tc.n_experts
        _, _, topi, _ = transformer._route(tc, tlp, tx.reshape(S, -1))
        np.testing.assert_array_equal(topi.numpy(), jax_routing["topi"])
        pos = transformer._moe_slots(topi, E).numpy()
        jpos = slots_np(jax_routing["topi"], E)
        np.testing.assert_array_equal(pos, jpos)
        cap = max(math.ceil(S * tc.top_k * cf / E), 4)
        assert dropped == int((jpos >= cap).sum())
        drops += dropped
        tol = 1e-5 * max(1.0, float(np.abs(np.asarray(
            want, np.float32)).max())) if dtype == "f32" else bf16_step(want)
        close(got, want, tol)
        close(aux, jaux, 1e-6)
    # capacity factor 1 drops tokens (the case is not moot), 4 none
    assert (drops > 0) == (cf == 1.0), drops


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_ffn_moe_ref_equals_ffn_moe(arch, dtype):
    jc, tc = configs(arch, dtype)
    _, tlp = layer(jc, tc, 3)
    _, tx = inputs(tc, 3, 40, 4)
    got, aux = transformer._ffn_moe(tc, tlp, tx)
    ref, aux_ref = transformer._ffn_moe_ref(tc, tlp, tx)
    assert torch.equal(aux, aux_ref)
    if dtype == "bf16":
        assert torch.equal(got, ref)
    else:
        close(got, ref.numpy(), 1e-6 * max(1.0, float(ref.abs().max())))


def test_block_weights_are_refused_by_the_dense_dispatch():
    _, tc = configs("PHI35_MOE")
    _, tlp = layer(configs("PHI35_MOE")[0], tc, 0)
    tlp = dict(tlp, moe_wi=tlp["moe_wi"][:2])
    with pytest.raises(ValueError, match="rank's block"):
        transformer._ffn_moe(tc, tlp, inputs(tc, 1, 8, 0)[1])


def test_prefill_reports_the_dropped_tokens():
    """``moe_dropped`` after ``prefill``: the pairs every layer dropped, 0
    where the capacity drops nothing; ``reset_moe_dropped`` clears it."""
    for cf, some in ((1.0, True), (8.0, False)):
        _, tc = configs("PHI35_MOE", capacity_factor=cf)
        p = transformer.init_lm_params(tc, torch.Generator().manual_seed(5))
        tok = torch.from_numpy(np.random.default_rng(5).integers(
            0, tc.vocab, (2, 64)).astype(np.int32))
        transformer.reset_moe_dropped()
        logits = serve.prefill(tc, p, tok)
        assert (transformer.moe_dropped() > 0) == some
        torch.testing.assert_close(
            logits, transformer.lm_forward(tc, p, tok)[0][:, -1], rtol=0,
            atol=0)
