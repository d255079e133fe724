"""The five assigned LM-family transformer architectures (public configs;
the port's copy of ``repro.configs.lm_archs``): three dense, and two MoE
(phi3.5-moe, arctic with its dense residual FFN), whose forward runs the
MoE FFN of ``models.transformer`` (``_ffn_moe``, or ``_ffn_moe_ep`` with
``moe_impl="ep"``)."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchBundle, lm_shapes
from repro_torch.models.transformer import LMConfig

# phi3.5-moe-42b-a6.6b [hf:microsoft/Phi-3.5-MoE-instruct]
PHI35_MOE = LMConfig(
    name="phi3.5-moe-42b-a6.6b", n_layers=32, d_model=4096, n_heads=32,
    n_kv_heads=8, d_ff=6400, vocab=32064, n_experts=16, top_k=2,
    gated_ffn=True, norm="ln")

# arctic-480b [hf:Snowflake/snowflake-arctic-base]: 128e top-2 + dense residual
ARCTIC = LMConfig(
    name="arctic-480b", n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=4864, vocab=32000, n_experts=128, top_k=2, dense_residual=True,
    gated_ffn=True, norm="rms")

# starcoder2-3b [arXiv:2402.19173]: GQA kv=2, RoPE, non-gated 4x FFN
STARCODER2_3B = LMConfig(
    name="starcoder2-3b", n_layers=30, d_model=3072, n_heads=24,
    n_kv_heads=2, d_ff=12288, vocab=49152, gated_ffn=False, norm="ln",
    rope_theta=1e5)

# qwen3-1.7b [hf:Qwen/Qwen3-*]: qk_norm, GQA kv=8, head_dim 128
QWEN3_1P7B = LMConfig(
    name="qwen3-1.7b", n_layers=28, d_model=2048, n_heads=16, n_kv_heads=8,
    d_ff=6144, vocab=151936, qk_norm=True, head_dim=128, gated_ffn=True,
    norm="rms", rope_theta=1e6)

# llama3.2-1b [hf:meta-llama/Llama-3.2-1B]
LLAMA32_1B = LMConfig(
    name="llama3.2-1b", n_layers=16, d_model=2048, n_heads=32, n_kv_heads=8,
    d_ff=8192, vocab=128256, gated_ffn=True, norm="rms", rope_theta=5e5)


def _smoke(cfg: LMConfig) -> LMConfig:
    return dataclasses.replace(
        cfg, n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=max(1, min(cfg.n_kv_heads, 2)), d_ff=128, vocab=256,
        head_dim=16, n_experts=min(cfg.n_experts, 4), attn_chunk=32,
        remat=False)


def bundles():
    return [ArchBundle(
        arch_id=cfg.name, family="lm", config=cfg, shapes=lm_shapes(),
        smoke=(lambda c=cfg: _smoke(c)),
        notes="pure full-attention; long_500k run as sharded-KV decode")
        for cfg in (PHI35_MOE, ARCTIC, STARCODER2_3B, QWEN3_1P7B, LLAMA32_1B)]
