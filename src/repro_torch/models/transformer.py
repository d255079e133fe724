"""Decoder-only LM: GQA + RoPE (+ optional qk-norm), dense FFN (the port
of ``repro.models.transformer``; serving forward, prefill and decode).

Parameters are stacked over layers (``[L, ...]``), as in the JAX
package, and the forward is a loop over the stack.  Prefill attention is
the flash-attention kernel (``kernels/flash_attention``): on the card one
launch a layer, on the CPU its plain version, which computes what the
Pallas kernel ``_fa_kernel`` computes (f32 math on the cast inputs).  The
JAX package's model path goes through ``flash_attention_xla`` instead,
which rounds ``q * scale``, k, v and the probabilities to bf16, so the two
agree to bf16 rounding; with the Pallas kernel in its place they agree to
f32 rounding.  Decode attention (``decode_attention``) is plain PyTorch,
like the JAX package's, which is plain jnp too.

Matrix products run in ``cfg.compute_dtype`` (bf16) on weights cast from
their f32 master copy at each use, as JAX's ``wcast`` does.  What is
dropped, with its reason:

* ``ct_cast`` pins a backward's cotangent dtype: this port has no
  backward yet;
* the sharding pins (``wcast``'s ``constrain``, ``model_size``) are no-ops
  on one device: ``wcast(w)`` is ``w.to(cfg.compute_dtype)``;
* ``remat`` and ``attn_chunk`` stay in ``LMConfig`` for its fields' sake
  and are not read: a forward keeps no activations for a backward, and
  the kernel's key tile is its own;
* the MoE FFN (``_ffn_moe``, ``_ffn_moe_ep``): a config with
  ``n_experts > 0`` has its parameters but its forward raises
  ``NotImplementedError`` (a later slice).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.state import resolve_device
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.common import (ParamTree, dense_init, layer_norm,
                                       rms_norm, tree_from_numpy)


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str = "lm"
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 2
    d_ff: int = 1024
    vocab: int = 1024
    head_dim: int = 0            # 0 -> d_model // n_heads
    norm: str = "rms"            # "rms" | "ln"
    qk_norm: bool = False
    gated_ffn: bool = True       # SwiGLU (llama-family); False -> GELU MLP
    rope_theta: float = 10_000.0
    # --- MoE ---
    n_experts: int = 0           # 0 -> dense FFN
    top_k: int = 2
    dense_residual: bool = False  # arctic: dense FFN in parallel with MoE
    capacity_factor: float = 1.25
    # --- numerics ---
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16
    remat: bool = True
    attn_chunk: int = 512
    # --- distribution ---
    moe_impl: str = "dense"

    @property
    def dh(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def n_params(self) -> int:
        """Analytic parameter count (embedding + layers + head)."""
        D, F_, H, K, dh = (self.d_model, self.d_ff, self.n_heads,
                           self.n_kv_heads, self.dh)
        attn = D * H * dh + 2 * D * K * dh + H * dh * D
        ffn = D * F_ * (3 if self.gated_ffn else 2)
        if self.n_experts:
            moe = self.n_experts * ffn + D * self.n_experts
            ffn = moe + (ffn if self.dense_residual else 0)
        per_layer = attn + ffn + 2 * D
        return self.vocab * D * 2 + self.n_layers * per_layer + D

    def n_active_params(self) -> int:
        """Active (per-token) params — MoE uses top_k experts only."""
        if not self.n_experts:
            return self.n_params()
        D, F_ = self.d_model, self.d_ff
        ffn1 = D * F_ * (3 if self.gated_ffn else 2)
        inactive = self.n_layers * (self.n_experts - self.top_k) * ffn1
        return self.n_params() - max(inactive, 0)


# --------------------------------------------------------------------------
# parameters
# --------------------------------------------------------------------------

ONES, ZEROS = "ones", "zeros"


def padded_heads(cfg: LMConfig) -> int:
    """Physical head count: the JAX package's zero-padding of heads to a
    tensor-parallel multiple was measured, refuted and disabled there, so
    this is the published count."""
    return cfg.n_heads


def _param_specs(cfg: LMConfig) -> dict:
    """The parameter tree as ``(shape, init)``: ``init`` is the fan-in of
    a dense draw, or ``ONES`` / ``ZEROS``.  The JAX package's tree."""
    D, F_, H, K, dh, L = (cfg.d_model, cfg.d_ff, padded_heads(cfg),
                          cfg.n_kv_heads, cfg.dh, cfg.n_layers)
    layers = dict(wq=((L, D, H * dh), D), wk=((L, D, K * dh), D),
                  wv=((L, D, K * dh), D), wo=((L, H * dh, D), H * dh),
                  ln1=((L, D), ONES), ln2=((L, D), ONES))
    if cfg.norm == "ln":
        layers.update(ln1b=((L, D), ZEROS), ln2b=((L, D), ZEROS))
    if cfg.qk_norm:
        layers.update(qnorm=((L, dh), ONES), knorm=((L, dh), ONES))

    def ffn(prefix, e=()):
        layers[prefix + "wi"] = ((L, *e, D, F_), D)
        if cfg.gated_ffn:
            layers[prefix + "wg"] = ((L, *e, D, F_), D)
        layers[prefix + "wo"] = ((L, *e, F_, D), F_)

    if cfg.n_experts:
        ffn("moe_", (cfg.n_experts,))
        layers["router"] = ((L, D, cfg.n_experts), D)
        if cfg.dense_residual:
            ffn("ffn_")
    else:
        ffn("ffn_")
    return dict(embed=((cfg.vocab, D), D), unembed=((D, cfg.vocab), D),
                final_norm=((D,), ONES), layers=layers)


def init_lm_params(cfg: LMConfig, gen: torch.Generator) -> dict:
    """Random parameters on ``gen``'s device, in the JAX package's tree
    (stacked ``[L, ...]``); each dense leaf drawn in place, Normal(0,
    1/sqrt(fan_in))."""
    def make(spec):
        if isinstance(spec, dict):
            return {k: make(v) for k, v in spec.items()}
        shape, init = spec
        if init == ONES:
            return torch.ones(shape, dtype=cfg.param_dtype, device=gen.device)
        if init == ZEROS:
            return torch.zeros(shape, dtype=cfg.param_dtype,
                               device=gen.device)
        return dense_init(gen, shape, init, cfg.param_dtype)
    return make(_param_specs(cfg))


def lm_params_from_numpy(cfg: LMConfig, tree, device=None) -> dict:
    """The JAX package's ``init_lm_params`` tree, as numpy arrays, as the
    port's parameters on ``device`` (default ``cuda``)."""
    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        return tuple(t[0]) if isinstance(t, tuple) else tuple(np.shape(t))
    want, got = shapes(_param_specs(cfg)), shapes(tree)
    if got != want:
        raise ValueError(f"the parameter tree does not fit {cfg.name}: "
                         f"{got} != {want}")
    return tree_from_numpy(tree, resolve_device(device))


# --------------------------------------------------------------------------
# rope / norm helpers
# --------------------------------------------------------------------------

def rope(x, positions, theta):
    """x: [B, T, H, dh]; positions: [B, T].  cos and sin are computed in
    f32 and cast to x's dtype before they touch x, as in the JAX package."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].float() * freqs              # [B, T, half]
    cos = torch.cos(ang)[:, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[:, :, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _norm(cfg, x, scale, bias=None):
    if cfg.norm == "ln":
        return layer_norm(x, scale, bias)
    return rms_norm(x, scale)


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------

def decode_attention(q, k_cache, v_cache, lengths):
    """Single-token decode: q [B,1,H,dh]; caches [B,T,Kh,dh]; lengths [B]
    -> [B,1,H,dh] f32.  Plain PyTorch, as the JAX package's is plain jnp:
    q * scale, the caches and the probabilities are rounded to bf16 and
    the products taken in f32 (JAX's ``preferred_element_type``).  Only
    ``q[:, 0]`` is read."""
    B, _, H, dh = q.shape
    T, Kh = k_cache.shape[1], k_cache.shape[2]
    G = H // Kh
    bf16 = torch.bfloat16
    qf = (q[:, 0] * (1.0 / math.sqrt(dh))).reshape(B, Kh, G, dh).to(bf16)
    s = torch.einsum("bkgd,btkd->bkgt", qf.float(),
                     k_cache.to(bf16).float())
    mask = torch.arange(T, device=q.device)[None, :] < lengths[:, None]
    s = s.masked_fill(~mask[:, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", p.to(bf16).float(),
                       v_cache.to(bf16).float())
    return out.reshape(B, 1, H, dh)


def _write_cache(cache, new, lengths):
    """``cache[b, lengths[b] + t] = new[b, t]`` in place (JAX sets a new
    cache functionally and donates the old one).  A position past the
    cache's end is left as it was, as JAX's ``.at[].set`` drops an
    out-of-bounds update; no host sync."""
    B, T = new.shape[:2]
    idx = lengths[:, None] + torch.arange(T, device=new.device)[None, :]
    bidx = torch.arange(B, device=new.device)[:, None]
    keep = (idx < cache.shape[1])[..., None, None]
    idx = idx.clamp(max=cache.shape[1] - 1)
    cache[bidx, idx] = torch.where(keep, new.to(cache.dtype),
                                   cache[bidx, idx])


def _attn(cfg: LMConfig, lp, x, positions, kv_cache=None, lengths=None):
    cd = cfg.compute_dtype
    B, T, _ = x.shape
    H, K, dh = padded_heads(cfg), cfg.n_kv_heads, cfg.dh
    q = (x @ lp["wq"].to(cd)).reshape(B, T, H, dh)
    k = (x @ lp["wk"].to(cd)).reshape(B, T, K, dh)
    v = (x @ lp["wv"].to(cd)).reshape(B, T, K, dh)
    if cfg.qk_norm:
        q = rms_norm(q, lp["qnorm"])
        k = rms_norm(k, lp["knorm"])
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    if kv_cache is None:
        o = flash_attention(q, k, v, causal=True)
        new_cache = None
    else:
        ck, cv = kv_cache                     # [B, Tmax, K, dh]
        _write_cache(ck, k, lengths)
        _write_cache(cv, v, lengths)
        o = decode_attention(q, ck, cv, lengths + T)
        new_cache = (ck, cv)
    o = o.reshape(B, T, H * dh).to(cd)
    return o @ lp["wo"].to(cd), new_cache


# --------------------------------------------------------------------------
# layer / model forward
# --------------------------------------------------------------------------

def _ffn_dense(cfg: LMConfig, lp, x, prefix="ffn_"):
    cd = cfg.compute_dtype
    h = x @ lp[prefix + "wi"].to(cd)
    if cfg.gated_ffn:
        h = h * F.silu(x @ lp[prefix + "wg"].to(cd))
    else:
        h = F.gelu(h, approximate="tanh")      # jax.nn.gelu's default
    return h @ lp[prefix + "wo"].to(cd)


def _layer(cfg: LMConfig, lp, x, positions, kv_cache=None, lengths=None):
    if cfg.n_experts:
        raise NotImplementedError(
            f"{cfg.name}: the MoE FFN (_ffn_moe, _ffn_moe_ep) is not "
            f"ported yet; the port serves the dense configs")
    a, new_cache = _attn(cfg, lp, _norm(cfg, x, lp["ln1"], lp.get("ln1b")),
                         positions, kv_cache, lengths)
    x = x + a
    f = _ffn_dense(cfg, lp, _norm(cfg, x, lp["ln2"], lp.get("ln2b")))
    return x + f, new_cache


def _layer_params(params, i: int) -> dict:
    return {k: v[i] for k, v in params["layers"].items()}


def lm_trunk(cfg: LMConfig, params, tokens, positions=None):
    """tokens: [B, T] -> the final-normed hidden states [B, T, D].  The
    embedding rows are gathered and then cast (JAX casts the whole table,
    then gathers: the same bits, without a cast of the table)."""
    B, T = tokens.shape
    if positions is None:
        positions = torch.arange(T, device=tokens.device).expand(B, T)
    x = params["embed"][tokens].to(cfg.compute_dtype)
    for i in range(cfg.n_layers):
        x, _ = _layer(cfg, _layer_params(params, i), x, positions)
    return rms_norm(x, params["final_norm"])


def lm_forward(cfg: LMConfig, params, tokens, positions=None):
    """tokens: [B, T] -> (logits [B, T, vocab] in the compute dtype, aux)
    (training/prefill, causal).  aux is the MoE load-balancing loss: 0
    for the dense FFN."""
    x = lm_trunk(cfg, params, tokens, positions)
    return (x @ params["unembed"].to(cfg.compute_dtype),
            torch.zeros((), device=x.device))


def lm_loss(cfg: LMConfig, params, batch):
    """batch: dict(tokens [B,T], targets [B,T]).  Cross-entropy from the
    compute-dtype logits with f32 reductions (forward only)."""
    logits, _ = lm_forward(cfg, params, batch["tokens"])
    tgt = logits.gather(-1, batch["targets"][..., None].long())[..., 0]
    lse = torch.logsumexp(logits.float(), dim=-1)
    return (lse - tgt.float()).mean()


def init_kv_cache(cfg: LMConfig, batch: int, max_len: int,
                  dtype=torch.bfloat16, device=None):
    """(k, v) caches, each ``[L, B, max_len, Kh, dh]``, zeros on ``device``
    (default ``cuda``)."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.dh)
    dev = resolve_device(device)
    return (torch.zeros(shape, dtype=dtype, device=dev),
            torch.zeros(shape, dtype=dtype, device=dev))


def lm_decode_step(cfg: LMConfig, params, tokens, kv_cache, lengths):
    """One serving step: tokens [B, 1] + caches -> (next-token logits
    [B, 1, vocab] f32, caches).  kv_cache: tuple of [L, B, Tmax, K, dh],
    written in place at ``lengths`` (the JAX package returns new caches
    and donates the old); lengths: [B] current cache fill."""
    B, T = tokens.shape
    if T != 1:
        raise ValueError(
            f"lm_decode_step takes one token a slot, not {T}: the JAX "
            f"package's decode_attention reads q[:, 0] only, so a step of "
            f"T > 1 there drops queries 1 and up")
    positions = lengths[:, None] + torch.arange(T, device=tokens.device)
    x = params["embed"][tokens].to(cfg.compute_dtype)
    ck, cv = kv_cache
    for i in range(cfg.n_layers):
        x, _ = _layer(cfg, _layer_params(params, i), x, positions,
                      (ck[i], cv[i]), lengths)
    x = rms_norm(x, params["final_norm"])
    return (x @ params["unembed"].to(cfg.compute_dtype)).float(), (ck, cv)


class LM(nn.Module):
    """``lm_forward`` / ``lm_decode_step`` as an ``nn.Module`` holding its
    (frozen) parameters."""

    def __init__(self, cfg: LMConfig, params):
        super().__init__()
        self.cfg = cfg
        self.params = ParamTree(params)

    @classmethod
    def from_numpy(cls, cfg: LMConfig, tree, device=None) -> "LM":
        return cls(cfg, lm_params_from_numpy(cfg, tree, device))

    @torch.no_grad()
    def forward(self, tokens):
        return lm_forward(self.cfg, self.params.tree(), tokens)[0]

    @torch.no_grad()
    def decode_step(self, tokens, kv_cache, lengths):
        return lm_decode_step(self.cfg, self.params.tree(), tokens,
                              kv_cache, lengths)
