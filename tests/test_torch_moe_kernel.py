"""The MoE FFN on the card, at smoke widths (no JAX here: the CPU tests
hold the port to the JAX package; these hold the card to the plain
version).  They carry the ``gpu`` marker and skip (from a fixture) where
there is no card; ``chip_smoke.py`` phases 45-47 run the same at full
width.

* ``_ffn_moe`` (index dispatch) against ``_ffn_moe_ref`` (the ``[S, E,
  cap]`` einsums) on the card: the routing (``topi``, slots, ``keep``)
  equal exactly; the output bit for bit, or within one bf16 step of the
  largest |out| where cuBLAS rounds an einsum's f32 sums to bf16 in
  parts (split-K);
* ``_ffn_moe_ep`` on ``LocalTiles`` on the card at (1, 2), (1, 4) and
  (2, 2) against the same on the CPU (two bf16 steps: the two devices'
  products round at other places) and, at a capacity factor that drops
  nothing, against ``_ffn_moe`` on the card (one bf16 step);
* the phi3.5-moe and arctic smoke forwards on the card: one flash launch
  a layer, finite logits, within the bf16 tolerance of the CPU forward.
"""
import dataclasses
import math

import pytest
import torch

from repro_torch.configs import lm_archs
from repro_torch.dist import ctx
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import transformer

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the MoE forward's attention is a "
                    "CUDA kernel with no CPU mode there (chip_smoke.py runs "
                    "these comparisons at full width)")
    return torch.device("cuda")


def config(arch, **kw):
    return dataclasses.replace(lm_archs._smoke(getattr(lm_archs, arch)),
                               n_experts=16, **kw)


def step(x) -> float:
    top = float(x.float().abs().max())
    return 2.0 ** (math.floor(math.log2(top)) - 7)


def layer(cfg, dev, seed=0):
    p = transformer.init_lm_params(
        cfg, torch.Generator(device=dev).manual_seed(seed))
    return transformer._layer_params(p, 0)


@pytest.mark.parametrize("arch", ["PHI35_MOE", "ARCTIC"])
@pytest.mark.parametrize("S", [64, 512])
def test_ffn_moe_equals_its_plain_version_on_the_card(card, arch, S):
    cfg = config(arch)
    lp = layer(cfg, card)
    x = torch.randn((1, S, cfg.d_model), device=card,
                    generator=torch.Generator(device=card).manual_seed(S)
                    ).bfloat16()
    _, _, topi, _ = transformer._route(cfg, lp, x[0])
    pos = transformer._moe_slots(topi, cfg.n_experts)
    assert torch.equal(pos, transformer._moe_slots_onehot(topi,
                                                          cfg.n_experts))
    got, aux = transformer._ffn_moe(cfg, lp, x)
    ref, aux_ref = transformer._ffn_moe_ref(cfg, lp, x)
    assert torch.equal(aux, aux_ref)
    assert float((got.float() - ref.float()).abs().max()) <= step(ref)


@pytest.mark.parametrize("shape", [(1, 2), (1, 4), (2, 2)])
def test_ep_on_local_tiles_on_the_card(card, shape):
    cfg = config("PHI35_MOE", moe_impl="ep")
    lp = layer(cfg, card, 1)
    x = torch.randn((2, 64, cfg.d_model), device=card,
                    generator=torch.Generator(device=card).manual_seed(2)
                    ).bfloat16()
    outs = {}
    for dev in (card, torch.device("cpu")):
        ctx.set_dist_mesh(make_host_mesh(*shape, device=dev))
        try:
            outs[dev.type] = transformer._ffn_moe_ep(
                cfg, {k: v.to(dev) for k, v in lp.items()}, x.to(dev))
        finally:
            ctx.set_dist_mesh(None)
    got, want = outs["cuda"][0].cpu().float(), outs["cpu"][0].float()
    assert float((got - want).abs().max()) <= 2 * step(want)
    wide = dataclasses.replace(cfg, capacity_factor=16.0)
    ctx.set_dist_mesh(make_host_mesh(*shape, device=card))
    try:
        transformer.reset_moe_dropped()
        ep, _ = transformer._ffn_moe_ep(wide, lp, x)
    finally:
        ctx.set_dist_mesh(None)
    dense, _ = transformer._ffn_moe(wide, lp, x)
    assert transformer.moe_dropped() == 0
    assert float((ep.float() - dense.float()).abs().max()) <= step(dense)


@pytest.mark.parametrize("arch", ["PHI35_MOE", "ARCTIC"])
def test_moe_forward_on_the_card(card, arch):
    cfg = lm_archs._smoke(getattr(lm_archs, arch))
    p = transformer.init_lm_params(cfg, torch.Generator().manual_seed(0))
    tok = torch.randint(0, cfg.vocab, (2, 64),
                        generator=torch.Generator().manual_seed(1))
    want, want_aux = transformer.lm_forward(cfg, p, tok)
    before = fa_ops.launches
    got, aux = transformer.lm_forward(
        cfg, {k: ({n: t.to(card) for n, t in v.items()}
                  if isinstance(v, dict) else v.to(card))
              for k, v in p.items()}, tok.to(card))
    assert fa_ops.launches - before == cfg.n_layers
    assert bool(torch.isfinite(got).all())
    scale = max(1.0, float(want.float().abs().max()))
    assert float((got.cpu().float() - want.float()).abs().max()) \
        <= 3e-2 * scale
    assert abs(float(aux) - float(want_aux)) <= 1e-2
