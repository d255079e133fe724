"""Decoder-only LM: GQA + RoPE (+ optional qk-norm), dense or MoE FFN (the
port of ``repro.models.transformer``; training forward and loss, prefill
and decode).

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

* the sharding pins (``wcast``'s ``constrain``, ``model_size``): the
  layout is explicit instead.  The forward is one code path over a list
  of rank blocks (``_Mesh``): a whole tree is one rank's blocks on no
  mesh, where every gather and sum is the identity and ``wcast(w)`` is
  ``w.to(cfg.compute_dtype)``; a ``dist.sharding.Placed`` tree (each
  rank's blocks by ``lm_param_shardings``) runs over the registered
  mesh, each rank computing on its blocks, gathering a weight's FSDP
  rows over ``data`` where JAX's ``wcast`` gathers and summing a
  row-parallel product over ``model``, as GSPMD lowers the pins;
* ``attn_chunk`` stays in ``LMConfig`` for its fields' sake and is not
  read: the kernel's key tile is its own;
* ``_ffn_moe``'s ``[S, E, cap]`` dispatch and combine einsums: every
  dispatched row holds one nonzero, so the port gathers the tokens into
  ``[E, cap, D]`` and the expert outputs back to ``[S, K, D]`` instead,
  the same function without the ``S x E x cap`` products (2.2e16 flops a
  layer at phi3.5-moe's 32k prefill).  ``_ffn_moe_ref`` keeps the einsum
  form as the plain version, for the tests and the card check.

What is kept for training: ``ct_cast``, JAX's identity that casts the
cotangent back to x's dtype, at the layer input and at q, k and v; and
``cfg.remat``, which runs each layer under ``torch.utils.checkpoint``
(``use_reentrant=False``) as ``jax.checkpoint`` does, so a layer's
activations are recomputed in the backward (the attention forward kernel
runs twice a layer, and being deterministic it recomputes the same lse).
The attention's backward is the flash backward kernel
(``kernels/flash_attention``) on the card, its plain backward on the
CPU.

The MoE FFN keeps JAX's semantics: routing on the bf16 router product
cast to f32, top-k by a stable descending sort (``lax.top_k``'s order:
on a tie the lower expert first, where ``torch.topk`` may pick either),
the capacity and slots of the (token, k) pairs in (s, k) order, the
gates rounded to the compute dtype in the combine, and the Switch
auxiliary loss.  Expert parallelism (``_moe_ep``: JAX's ``_ffn_moe_ep``,
entered by that name for a whole batch on the registered mesh, and by
the forward on a ``Placed`` tree for each rank's rows) is a function of
its own (its own capacity floor, f32 gates and a bf16 sum over
``model``): it and ``_ffn_moe`` agree only where neither drops a token.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from repro_torch.core.state import resolve_device
from repro_torch.dist import sharding
from repro_torch.dist.ctx import dp_axes_active, get_dist_mesh, model_size
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


EXPERT_LEAVES = ("moe_wi", "moe_wg", "moe_wo")
ROW_CHUNK = 64      # rows of a dense leaf drawn from one generator


def lm_params_meta(cfg: LMConfig) -> dict:
    """``init_lm_params``' tree as meta tensors (shapes and dtypes, no
    storage)."""
    def make(spec):
        if isinstance(spec, dict):
            return {k: make(v) for k, v in spec.items()}
        return torch.empty(spec[0], dtype=cfg.param_dtype, device="meta")
    return make(_param_specs(cfg))


def lm_param_specs(cfg: LMConfig, mesh) -> dict:
    """``dist.sharding.lm_param_shardings`` of ``cfg``'s parameter tree on
    ``mesh``: a spec a leaf."""
    return sharding.lm_param_shardings(mesh, lm_params_meta(cfg))


def init_lm_params(cfg: LMConfig, gen: torch.Generator, mesh=None,
                   rank: int = 0) -> dict:
    """Random parameters on ``gen``'s device, in the JAX package's tree
    (stacked ``[L, ...]``), Normal(0, 1/sqrt(fan_in)); ``s``, drawn from
    ``gen`` once a leaf, seeds the leaf's pieces.  A dense leaf is drawn
    ``ROW_CHUNK`` rows of its last two dims at a time, chunk ``c`` of
    layer ``l`` from a generator seeded ``s + l * n_chunks + c``; an
    expert leaf (``EXPERT_LEAVES``) matrix by matrix, expert ``e`` of
    layer ``l`` seeded ``s + l * E + e``.  So with ``mesh``, the process
    draws only the block of every leaf that ``rank`` holds by
    ``dist.sharding.lm_param_shardings`` (the chunks it overlaps), bit for
    bit that block of the whole draw."""
    dev = gen.device
    specs = lm_param_specs(cfg, mesh) if mesh is not None else None

    def block(shape, spec):
        if spec is None:
            return (slice(None),) * len(shape)
        return sharding.block_slices(mesh, shape, spec, rank)

    def size(shape, idx):
        return [len(range(n)[i]) for n, i in zip(shape, idx)]

    def seed_of():
        return int(torch.randint(0, 2 ** 62, (1,), generator=gen,
                                 device=dev))

    def experts(shape, fan_in, idx):
        seed = seed_of()
        L, E = shape[:2]
        out = torch.empty(size(shape, idx), dtype=cfg.param_dtype,
                          device=dev)
        for l in range(L):
            for i, e in enumerate(range(E)[idx[1]]):
                g = torch.Generator(device=dev).manual_seed(seed + l * E + e)
                out[l, i] = dense_init(g, shape[2:], fan_in,
                                       cfg.param_dtype)[idx[2], idx[3]]
        return out

    def dense(shape, fan_in, idx):
        seed = seed_of()
        lead, (R, C) = shape[:-2], shape[-2:]
        L = math.prod(lead)
        rows = range(R)[idx[-2]]
        n_chunks = -(-R // ROW_CHUNK)
        out = torch.empty(size(shape, idx), dtype=cfg.param_dtype,
                          device=dev)
        flat = out.view(-1, *out.shape[-2:])
        layers = range(L)[idx[0]] if lead else range(1)
        for a, l in enumerate(layers):
            for c in range(rows.start // ROW_CHUNK,
                           -(-rows.stop // ROW_CHUNK)):
                r0, r1 = c * ROW_CHUNK, min(R, (c + 1) * ROW_CHUNK)
                g = torch.Generator(device=dev).manual_seed(
                    seed + l * n_chunks + c)
                piece = dense_init(g, (r1 - r0, C), fan_in, cfg.param_dtype)
                lo, hi = max(r0, rows.start), min(r1, rows.stop)
                flat[a, lo - rows.start:hi - rows.start] = \
                    piece[lo - r0:hi - r0, idx[-1]]
        return out

    def make(tree, specs, name=""):
        if isinstance(tree, dict):
            return {k: make(v, None if specs is None else specs[k], k)
                    for k, v in tree.items()}
        shape, init = tree
        idx = block(shape, specs)
        if init in (ONES, ZEROS):
            fill = torch.ones if init == ONES else torch.zeros
            return fill(size(shape, idx), dtype=cfg.param_dtype, device=dev)
        if name in EXPERT_LEAVES:
            return experts(shape, init, idx)
        return dense(shape, init, idx)
    return make(_param_specs(cfg), specs)


def lm_params_from_numpy(cfg: LMConfig, tree, device=None, mesh=None,
                         rank: int = 0) -> dict:
    """The JAX package's ``init_lm_params`` tree, as numpy arrays, as the
    port's parameters on ``device`` (default ``cuda``); with ``mesh``,
    the block of each leaf that ``rank`` holds by
    ``dist.sharding.lm_param_shardings``."""
    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        return tuple(t[0]) if isinstance(t, tuple) else tuple(np.shape(t))
    want, got = shapes(_param_specs(cfg)), shapes(tree)
    if got != want:
        raise ValueError(f"the parameter tree does not fit {cfg.name}: "
                         f"{got} != {want}")
    if mesh is not None:
        tree = sharding.map_specs(
            lambda x, s: np.ascontiguousarray(
                sharding.shard_block(np.asarray(x), mesh, s, rank)),
            tree, lm_param_specs(cfg, mesh))
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

class _CtCast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.dtype = x.dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype)


def ct_cast(x):
    """Identity that casts the cotangent back to x's dtype (JAX's
    ``ct_cast``): the backward residual and QKV streams stay in the
    compute dtype."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _CtCast.apply(x)
    return x


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


def decode_attention_lse(q, k_cache, v_cache, lengths):
    """``decode_attention`` over one slice of the cache's time axis, for
    merging with the other slices' by log-sum-exp (flash-decoding):
    ``lengths`` [B] the valid positions at the slice's start.  Returns
    (out [B, 1, H, dh] f32, normalised over the slice; lse [B, H] f32,
    each row's log-sum-exp of its scores).  A row with no valid position
    gives out 0 and lse -inf.  The roundings are ``decode_attention``'s."""
    B, _, H, dh = q.shape
    T, Kh = k_cache.shape[1], k_cache.shape[2]
    G = H // Kh
    bf16 = torch.bfloat16
    qf = (q[:, 0] * (1.0 / math.sqrt(dh))).reshape(B, Kh, G, dh).to(bf16)
    s = torch.einsum("bkgd,btkd->bkgt", qf.float(),
                     k_cache.to(bf16).float())
    mask = torch.arange(T, device=q.device)[None, :] < lengths[:, None]
    s = s.masked_fill(~mask[:, None, None, :], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.exp(s - m)
    den = e.sum(dim=-1, keepdim=True)
    p = e / den.clamp_min(1e-30)
    out = torch.einsum("bkgt,btkd->bkgd", p.to(bf16).float(),
                       v_cache.to(bf16).float())
    lse = (m + torch.log(den))[..., 0].reshape(B, H)
    return out.reshape(B, 1, H, dh), lse


def _write_cache(cache, new, lengths):
    """``cache[b, lengths[b] + t] = new[b, t]`` in place (JAX sets a new
    cache functionally and donates the old one).  A position outside the
    cache (past its end; before its start, for a rank's slice of the time
    axis) is left as it was, as JAX's ``.at[].set`` drops an
    out-of-bounds update; no host sync."""
    B, T = new.shape[:2]
    idx = lengths[:, None] + torch.arange(T, device=new.device)[None, :]
    bidx = torch.arange(B, device=new.device)[:, None]
    keep = ((idx >= 0) & (idx < cache.shape[1]))[..., None, None]
    idx = idx.clamp(0, cache.shape[1] - 1)
    cache[bidx, idx] = torch.where(keep, new.to(cache.dtype),
                                   cache[bidx, idx])


# --------------------------------------------------------------------------
# MoE FFN
# --------------------------------------------------------------------------

def _route(cfg: LMConfig, lp, xs):
    """Top-k routing of the tokens ``xs`` [S, D] (compute dtype) ->
    (gates [S, E] f32, topv [S, K] renormalised f32, topi [S, K] int64,
    aux).  The router product runs in the compute dtype and is cast to
    f32, as JAX's; the top k by a stable descending sort, which orders a
    tie as ``lax.top_k`` does (lower expert first); ``aux`` is the Switch
    load-balancing loss E * sum_e(frac_tokens_e * frac_prob_e)."""
    E, K = cfg.n_experts, cfg.top_k
    logits = (xs @ lp["router"].to(cfg.compute_dtype)).float()
    gates = torch.softmax(logits, dim=-1)
    topv, topi = torch.sort(gates, dim=-1, descending=True, stable=True)
    topv, topi = topv[:, :K], topi[:, :K]
    topv = topv / topv.sum(-1, keepdim=True).clamp_min(1e-9)
    frac_t = F.one_hot(topi[:, 0], E).float().mean(0)
    aux = E * (frac_t * gates.mean(0)).sum()
    return gates, topv, topi, aux


def _capacity(cfg: LMConfig, S: int, floor: int) -> int:
    return max(math.ceil(S * cfg.top_k * cfg.capacity_factor
                         / cfg.n_experts), floor)


def _moe_slots(topi, E: int):
    """Each (token, k)'s slot within its expert [S, K]: how many (s', k')
    before it in (s, k) order chose the same expert.  By a stable sort of
    the choices by expert (no [S * K, E] one-hot)."""
    flat = topi.reshape(-1)
    by_e, order = torch.sort(flat, stable=True)
    # each expert's first row in the sorted choices (no host read, as
    # ``bincount`` would make on CUDA)
    start = torch.searchsorted(by_e, torch.arange(E, device=flat.device))
    pos = torch.empty_like(flat)
    pos[order] = torch.arange(flat.numel(), device=flat.device) - start[by_e]
    return pos.view_as(topi)


def _moe_slots_onehot(topi, E: int):
    """``_moe_slots`` as JAX's ``_ffn_moe`` writes it: an exclusive cumsum
    over the (s, k) one-hot."""
    S, K = topi.shape
    flat = F.one_hot(topi, E).reshape(S * K, E)
    return ((flat.cumsum(0) - flat) * flat).sum(-1).reshape(S, K)


# (token, k) pairs the MoE FFNs' capacities dropped since
# ``reset_moe_dropped``: a running count a device, added to on the device
_dropped: dict = {}


def _count_dropped(n) -> None:
    t = _dropped.get(n.device)
    _dropped[n.device] = n if t is None else t + n


def reset_moe_dropped() -> None:
    _dropped.clear()


def moe_dropped() -> int:
    """The (token, k) pairs the MoE FFNs' capacities dropped since
    ``reset_moe_dropped`` (one host read a device; 0 for dense configs; a
    layer recomputed under ``cfg.remat`` counts again)."""
    return sum(int(t) for t in _dropped.values())


def _check_whole_experts(cfg: LMConfig, lp):
    if lp["moe_wi"].shape[0] != cfg.n_experts:
        raise ValueError(
            f"{cfg.name}: the layer holds {lp['moe_wi'].shape[0]} of "
            f"{cfg.n_experts} experts, a rank's block: only EP on the mesh "
            f"it was cut for (a Placed tree, or _ffn_moe_ep) reads a block")


def _experts(cfg: LMConfig, w, ein):
    """Every expert's FFN on its rows: ein [E', c, D] -> [E', c, D], the
    compute dtype; ``w`` the (wi, wg, wo) of those experts."""
    cd = cfg.compute_dtype
    wi, wg, wo = w
    h = torch.matmul(ein, wi.to(cd))
    if cfg.gated_ffn:
        h = h * F.silu(torch.matmul(ein, wg.to(cd)))
    else:
        h = F.gelu(h, approximate="tanh")      # jax.nn.gelu's default
    return torch.matmul(h, wo.to(cd))


def _expert_weights(cfg: LMConfig, lp):
    return (lp["moe_wi"], lp["moe_wg"] if cfg.gated_ffn else None,
            lp["moe_wo"])


def _dispatch(topi, xs, E: int, cap: int):
    """The kept (token, k) pairs' rows in ``[E, cap, D]`` (zero rows
    where an expert has fewer than ``cap``) -> (slot [S, K]: each pair's
    row in it, ``E * cap`` if dropped; keep [S, K]; ein)."""
    S, K = topi.shape
    pos = _moe_slots(topi, E)
    keep = pos < cap
    slot = torch.where(keep, topi * cap + pos, E * cap)
    src = torch.full((E * cap + 1,), S, dtype=torch.long, device=xs.device)
    src.scatter_(0, slot.reshape(-1),
                 torch.arange(S, device=xs.device).repeat_interleave(K))
    xs_pad = torch.cat([xs, xs.new_zeros(1, xs.shape[1])])
    return slot, keep, xs_pad[src[:-1]].view(E, cap, xs.shape[1])


def _combine(eout, slot, keep, topv):
    """Each token's K expert outputs, weighted by its gates rounded to the
    outputs' dtype and summed in f32 in k order, then cast: [S, D]."""
    E, cap, D = eout.shape
    y = eout.view(E * cap, D)[slot.clamp(max=E * cap - 1)]     # [S, K, D]
    g = torch.where(keep, topv, 0.0).to(eout.dtype).float()
    out = g[:, 0, None] * y[:, 0].float()
    for k in range(1, slot.shape[1]):
        out = out + g[:, k, None] * y[:, k].float()
    return out.to(eout.dtype)


def _ffn_moe(cfg: LMConfig, lp, x):
    """Top-k routed experts with GShard-style capacity (JAX's ``_ffn_moe``),
    by index dispatch.  x: [B, T, D] -> ([B, T, D], aux).

    cap = max(ceil(S K capacity_factor / E), 4); a (token, k) at or past
    its expert's cap is dropped.  ``_route``, then ``_dispatch`` gathers
    the kept tokens into ``[E, cap, D]``, ``_experts`` runs one batched
    product an expert matrix, and ``_combine`` gathers each token's K
    outputs back.  The dropped (token, k) pairs go to ``moe_dropped``."""
    B, T, D = x.shape
    S = B * T
    _check_whole_experts(cfg, lp)
    xs = x.reshape(S, D).to(cfg.compute_dtype)
    _, topv, topi, aux = _route(cfg, lp, xs)
    cap = _capacity(cfg, S, 4)
    slot, keep, ein = _dispatch(topi, xs, cfg.n_experts, cap)
    eout = _experts(cfg, _expert_weights(cfg, lp), ein)
    _count_dropped((~keep).sum())
    return _combine(eout, slot, keep, topv).view(B, T, D), aux


def _ffn_moe_ref(cfg: LMConfig, lp, x):
    """The plain version of ``_ffn_moe``: JAX's literal ``[S, E, cap]``
    dispatch and combine einsums (``repro/models/transformer.py``), its
    slots by the one-hot cumsum.  For the tests and the card check; no
    forward calls it."""
    cd = cfg.compute_dtype
    B, T, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    S = B * T
    _check_whole_experts(cfg, lp)
    xs = x.reshape(S, D).to(cd)
    _, topv, topi, aux = _route(cfg, lp, xs)
    cap = _capacity(cfg, S, 4)
    pos = _moe_slots_onehot(topi, E)
    keep = pos < cap
    sidx = torch.arange(S, device=x.device)[:, None].expand(S, K)
    at = (sidx, topi, pos.clamp(max=cap - 1))
    disp = torch.zeros((S, E, cap), dtype=cd, device=x.device)
    disp.index_put_(at, keep.to(cd), accumulate=True)
    ein = torch.einsum("sec,sd->ecd", disp, xs)
    eout = _experts(cfg, _expert_weights(cfg, lp), ein)
    comb = torch.zeros((S, E, cap), dtype=cd, device=x.device)
    comb.index_put_(at, torch.where(keep, topv, 0.0).to(cd), accumulate=True)
    out = torch.einsum("sec,ecd->sd", comb, eout)
    return out.view(B, T, D), aux


def _ep_rank(cfg: LMConfig, w, xs_l, topi_l, topv_l, first: int,
             cap: int):
    """One rank's experts, JAX's ``local_moe``: for each local expert the
    first ``cap`` (token, k) pairs that chose it in (s, k) order (a
    stable sort of ~hit), its FFN, the output weighted by the f32 gates
    and added at the tokens in local-expert order (within an expert a
    token comes once, so the order of the adds is JAX's) -> [S_loc, D]
    in the compute dtype."""
    K = cfg.top_k
    E_loc = w[0].shape[0]
    assign, gate = topi_l.reshape(-1), topv_l.reshape(-1)
    mine = first + torch.arange(E_loc, device=assign.device)
    hit = assign[None, :] == mine[:, None]                 # [E_loc, S_loc*K]
    order = torch.argsort((~hit).to(torch.int32), dim=1, stable=True)
    order = order[:, :cap]
    valid = hit.gather(1, order)
    tok = order // K
    g = torch.where(valid, gate[order], 0.0)
    ye = _experts(cfg, w, xs_l[tok]).float() * g[..., None]
    out = torch.zeros((xs_l.shape[0], xs_l.shape[1]), dtype=torch.float32,
                      device=xs_l.device)
    for el in range(E_loc):
        out.index_add_(0, tok[el], ye[el])
    _count_dropped((hit.sum(1) - cap).clamp_min(0).sum())
    return out.to(cfg.compute_dtype)


# --------------------------------------------------------------------------
# the forward: one code path over a list of rank blocks
# --------------------------------------------------------------------------

class _Mesh:
    """Where the forward runs, one entry a local rank in every list it
    handles (the order of ``mesh.local_ranks``): this process's ranks of
    the registered mesh, for a tree ``Placed`` by ``lm_param_shardings``;
    or, with ``mesh`` None, one rank holding a whole tree, on which every
    gather and sum below is the identity.  ``whole`` gathers a weight
    where JAX's ``wcast`` gathers it; ``sum_model`` and ``gather_model``
    are the sums and gathers over ``model`` that GSPMD inserts."""

    def __init__(self, mesh=None):
        self.mesh = mesh
        if mesh is None:
            self.tr, self.ranks, self.dp = None, (0,), ()
            self.n_dp = self.tp = 1
            self.m = self.d = [0]
            return
        if mesh.transport is None:
            raise ValueError("the forward over a mesh needs a mesh with a "
                             "transport (LocalTiles or ProcessGroupTiles)")
        self.tr, self.ranks = mesh.transport, mesh.local_ranks
        self.dp = tuple(a for a in dp_axes_active(mesh)
                        if a in mesh.axis_names)
        self.n_dp = math.prod(mesh.shape[a] for a in self.dp)
        self.tp = model_size(mesh)
        self.m = [mesh.coords(r).get("model", 0) for r in self.ranks]
        self.d = [mesh.axis_index(r, self.dp) for r in self.ranks]

    def whole(self, blocks, spec, keep=()):
        """Each rank's block, gathered along every dimension its ``spec``
        (None: a whole leaf) splits over axes other than ``keep``."""
        for dim, entry in enumerate(spec or ()):
            if entry is None or entry in keep:
                continue
            axes = (entry,) if isinstance(entry, str) else tuple(entry)
            blocks = self.tr.axis_gather(self.mesh, axes, blocks, dim)
        return blocks

    def wcast(self, trees, specs, name, cfg, keep=()):
        """JAX's ``wcast`` of leaf ``name`` of each rank's tree: cast to
        the compute dtype, then gathered (the FSDP rows over dp;
        ``keep=("model",)`` keeps the TP block).  ``specs``: the trees'
        specs, None for whole trees."""
        return self.whole([t[name].to(cfg.compute_dtype) for t in trees],
                          None if specs is None else specs[name], keep)

    def sum_model(self, blocks):
        if self.tp == 1:
            return blocks
        return self.tr.axis_sum(self.mesh, ("model",), blocks)

    def gather_model(self, blocks, dim):
        if self.tp == 1:
            return blocks
        return self.tr.axis_gather(self.mesh, ("model",), blocks, dim)

    def rows(self, x):
        """Batch rows for each rank, from a whole ``[B, ...]`` tensor (over
        dp where they divide, else whole) or a ``Placed`` one: (blocks,
        the batch dimension's spec entry)."""
        if self.mesh is None:
            return [x], None
        if not isinstance(x, sharding.Placed):
            x = sharding.lay_out(x, self.mesh,
                                 ("dp",) + (None,) * (x.dim() - 1))
        return x.blocks, x.specs[0]


def _placed(params):
    """(``_Mesh``, the tree as a ``Placed``): a ``Placed`` tree on the
    registered mesh, or a whole tree as one rank's blocks with no specs."""
    if not isinstance(params, sharding.Placed):
        return _Mesh(), sharding.Placed(None, None, [params])
    mesh = get_dist_mesh()
    if mesh is None or params.mesh is not mesh:
        raise ValueError("a laid-out parameter tree runs on the registered "
                         "mesh: dist.ctx.set_dist_mesh(its mesh)")
    return _Mesh(mesh), params


def _mm_f32(x, w):
    """``x @ w`` with its sums kept in f32 (the tensor cores' accumulator,
    not rounded to the compute dtype)."""
    if x.dtype == torch.float32:
        return x @ w
    x2 = x.reshape(-1, x.shape[-1])
    y = torch.mm(x2, w, out_dtype=torch.float32) if x.is_cuda \
        else x2.float() @ w.float()
    return y.reshape(*x.shape[:-1], w.shape[-1])


def _row_parallel(R, xs, ws, split: bool):
    """``x @ w`` on each rank; where ``split``, ``w``'s rows (and ``x``'s
    columns) are the rank's block over ``model``, and the partial sums,
    kept in f32, are added over ``model`` and rounded once, as one
    device's whole product rounds once (a bf16 sum of bf16 partials put
    the decode 3.5% off the whole model on the card)."""
    if not split or R.tp == 1:
        return [x @ w for x, w in zip(xs, ws)]
    return [y.to(xs[0].dtype) for y in R.sum_model(
        [_mm_f32(x, w) for x, w in zip(xs, ws)])]


def _layer_params(params, i: int) -> dict:
    return {k: v[i] for k, v in params["layers"].items()}


def _layer_blocks(P, i: int):
    """Layer ``i``'s blocks of every local rank and their specs (None for
    whole trees)."""
    lps = [_layer_params(t, i) for t in P.blocks]
    if P.specs is None:
        return lps, None
    return lps, {k: s[1:] for k, s in P.specs["layers"].items()}


def _embed(cfg, R, P, toks):
    """JAX's ``wcast(embed, "model", None)[tokens]`` (the rows gathered,
    then cast: the same bits as JAX's cast of the whole table).  Where the
    vocabulary is split over ``model`` each rank looks the tokens up in
    its block of rows (zero elsewhere), and the sum over ``model``
    completes each row (one nonzero term: exact)."""
    spec = None if P.specs is None else P.specs["embed"]
    if spec is None or spec[0] is None:
        return [t["embed"][tok].to(cfg.compute_dtype)
                for t, tok in zip(P.blocks, toks)]
    vshape = sharding.whole_shape(R.mesh, P.blocks[0]["embed"].shape, spec)
    xs = []
    for r, tok, t in zip(R.ranks, toks, P.blocks):
        e = t["embed"]
        v0 = sharding.block_slices(R.mesh, vshape, spec, r)[0].start
        local = tok.long() - v0
        ok = (local >= 0) & (local < e.shape[0])
        xs.append(torch.where(ok[..., None],
                              e[local.clamp(0, e.shape[0] - 1)]
                              .to(cfg.compute_dtype), 0))
    axes = (spec[0],) if isinstance(spec[0], str) else tuple(spec[0])
    return R.tr.axis_sum(R.mesh, axes, xs)


def _attn(cfg, R, lps, ls, xs, pos, caches=None, lengths=None, cspec=None):
    """Attention on each rank.  Where the heads and KV heads divide
    ``model`` (JAX's head sharding; always on one rank): the rank's q / k
    / v columns are its heads, its ``wo`` rows their output
    (``_row_parallel``); the flash kernel runs once per rank on its
    heads, and the decode cache holds its KV heads.  Where they do not
    (JAX's fallback, ``flash_attention_xla``): the weights are gathered
    whole, a prefill's query rows are split over ``model`` (the rank's
    flash over the rows up to its last, keeping its own) and gathered
    back, and the decode cache is split on its time axis (``cspec``, the
    cache's spec without its layer dim), each rank attending over its
    slice and the slices merged by their log-sum-exp."""
    cd = cfg.compute_dtype
    H, K, dh = padded_heads(cfg), cfg.n_kv_heads, cfg.dh
    tp = R.tp
    heads = H % tp == 0 and K % tp == 0
    keep = ("model",) if heads else ()
    w = {n: R.wcast(lps, ls, n, cfg, keep) for n in ("wq", "wk", "wv", "wo")}
    Hl, Kl = (H // tp, K // tp) if heads else (H, K)
    seq = not heads and caches is None and xs[0].shape[1] % tp == 0
    tsplit = cspec is not None and cspec[1] == "model"
    outs, parts = [], []
    for k, x in enumerate(xs):
        B, T, _ = x.shape
        s0, s1 = (R.m[k] * T // tp, (R.m[k] + 1) * T // tp) if seq \
            else (0, T)
        xe = x[:, :s1] if seq else x
        q = (xe @ w["wq"][k]).reshape(B, s1, Hl, dh)
        kk = (xe @ w["wk"][k]).reshape(B, s1, Kl, dh)
        vv = (xe @ w["wv"][k]).reshape(B, s1, Kl, dh)
        if cfg.qk_norm:
            q = rms_norm(q, lps[k]["qnorm"])
            kk = rms_norm(kk, lps[k]["knorm"])
        q = rope(q, pos[k][:, :s1], cfg.rope_theta)
        kk = rope(kk, pos[k][:, :s1], cfg.rope_theta)
        if caches is None:
            o = flash_attention(ct_cast(q), ct_cast(kk), ct_cast(vv),
                                causal=True)
            outs.append(o[:, s0:] if seq else o)
            continue
        ck, cv = caches[k]
        t0 = R.m[k] * ck.shape[1] if tsplit else 0
        _write_cache(ck, kk, lengths[k] - t0)
        _write_cache(cv, vv, lengths[k] - t0)
        if tsplit:
            valid = (lengths[k] + T - t0).clamp(0, ck.shape[1])
            parts.append(decode_attention_lse(q, ck, cv, valid))
        else:
            outs.append(decode_attention(q, ck, cv, lengths[k] + T))
    if parts:
        # the slices' partial softmaxes, merged by their log-sum-exp
        lse = R.gather_model([p[1][None] for p in parts], 0)
        o = R.gather_model([p[0][None] for p in parts], 0)
        for l, oo in zip(lse, o):
            wgt = torch.exp(l - torch.logsumexp(l, dim=0))
            outs.append((wgt[:, :, None, :, None] * oo).sum(dim=0))
    flat = [o.reshape(*o.shape[:2], Hl * dh).to(cd) for o in outs]
    ys = _row_parallel(R, flat, w["wo"], heads)
    return R.gather_model(ys, 1) if seq else ys


def _ffn_dense(cfg, R, lps, ls, xs, prefix="ffn_"):
    """The dense FFN on each rank: ``wi`` and ``wg`` column-parallel over
    ``model`` (their FSDP rows gathered), ``wo`` row-parallel."""
    keep = ("model",)
    wi = R.wcast(lps, ls, prefix + "wi", cfg, keep)
    wg = R.wcast(lps, ls, prefix + "wg", cfg, keep) if cfg.gated_ffn \
        else None
    wo = R.wcast(lps, ls, prefix + "wo", cfg, keep)
    hs = []
    for k, x in enumerate(xs):
        h = x @ wi[k]
        if cfg.gated_ffn:
            h = h * F.silu(x @ wg[k])
        else:
            h = F.gelu(h, approximate="tanh")      # jax.nn.gelu's default
        hs.append(h)
    split = ls is not None and ls[prefix + "wo"][0] == "model"
    return _row_parallel(R, hs, wo, split)


def _ep_applies(cfg: LMConfig, S: int, n_dp: int) -> bool:
    """JAX's conditions for EP: S splits over dp, and a dp rank routes at
    least ``E // 4`` (token, k) pairs (else the dense dispatch is cheap,
    e.g. batch-1 decode)."""
    return S % n_dp == 0 and (S // n_dp) * cfg.top_k >= cfg.n_experts // 4


def _moe_ep(cfg, R, lps, ls, hs, rows_split: bool):
    """Expert parallelism, JAX's ``_ffn_moe_ep`` under ``shard_map``: the
    experts split over ``model``, each dp rank routing its share of the
    tokens (its own rows where ``rows_split``, else its slice of the
    whole batch each rank holds), S // n_dp of them, to its own ``E //
    n_model`` experts with its own capacity ``max(ceil(S_loc K cf / E),
    8)``; a bf16 sum over ``model`` completes the combine.  A whole
    batch's outputs are gathered over dp.  -> (outputs, aux of the whole
    batch)."""
    cd = cfg.compute_dtype
    Br, T, D = hs[0].shape
    E = cfg.n_experts
    S = Br * T * (R.n_dp if rows_split else 1)
    if E % R.tp or cfg.d_model % R.n_dp:
        raise ValueError(f"{E} experts over model {R.tp} and d_model "
                         f"{cfg.d_model} over dp {R.n_dp} do not split")
    E_loc, S_loc = E // R.tp, S // R.n_dp
    cap = _capacity(cfg, S_loc, 8)
    router = R.wcast(lps, ls, "router", cfg)
    w = []
    for n in EXPERT_LEAVES:
        if n == "moe_wg" and not cfg.gated_ffn:
            w.append([None] * len(lps))
            continue
        spec = None if ls is None else ls[n]
        blocks = [lp[n] for lp in lps]
        if spec is None or spec[0] is None:
            # a whole leaf: the rank's experts (before the cast)
            blocks = [b[m * E_loc:(m + 1) * E_loc]
                      for b, m in zip(blocks, R.m)]
        w.append(R.whole([b.to(cd) for b in blocks], spec, ("model",)))
    parts, frac, gsum = [], [], []
    for k, h in enumerate(hs):
        xs = h.reshape(-1, D).to(cd)
        if not rows_split:
            xs = xs[R.d[k] * S_loc:(R.d[k] + 1) * S_loc]
        gates, topv, topi, _ = _route(cfg, {"router": router[k]}, xs)
        frac.append(F.one_hot(topi[:, 0], E).float().sum(0))
        gsum.append(gates.sum(0))
        parts.append(_ep_rank(cfg, [ww[k] for ww in w], xs, topi, topv,
                              R.m[k] * E_loc, cap))
    ys = R.sum_model(parts)
    if R.n_dp > 1:
        frac = R.tr.axis_sum(R.mesh, R.dp, frac)
        gsum = R.tr.axis_sum(R.mesh, R.dp, gsum)
        if not rows_split:
            ys = R.tr.axis_gather(R.mesh, R.dp, ys, 0)
    aux = E * ((frac[0] / S) * (gsum[0] / S)).sum()
    return [y.reshape(h.shape) for y, h in zip(ys, hs)], aux


def _ep_leaf_spec(cfg, R, name: str, w):
    """The spec of ``_ffn_moe_ep``'s expert leaf ``w`` [E, ...]: None for
    the whole leaf; ``lm_param_shardings``' where this process holds one
    rank and ``w`` is its block."""
    whole = (cfg.n_experts, cfg.d_ff, cfg.d_model) if name == "moe_wo" \
        else (cfg.n_experts, cfg.d_model, cfg.d_ff)
    if tuple(w.shape) == whole:
        return None
    spec = sharding.lm_layer_spec(R.mesh, name, whole)
    want = tuple(len(range(n)[i]) for n, i in zip(
        whole, sharding.block_slices(R.mesh, whole, spec, R.ranks[0])))
    if len(R.ranks) != 1 or tuple(w.shape) != want:
        raise ValueError(f"{name}: {tuple(w.shape)} is neither the whole "
                         f"leaf {whole} nor this process's block {want}")
    return spec


def _ffn_moe_ep(cfg: LMConfig, lp, x):
    """JAX's ``_ffn_moe_ep`` on a whole batch x [B, T, D] over the
    registered mesh: ``_moe_ep`` with every rank holding the batch, each
    routing its dp slice, and the outputs gathered over dp, so that
    every process returns the whole batch's (on ``LocalTiles`` every rank
    runs in this process).  ``lp``'s expert leaves are whole, or, where
    this process holds one rank, that rank's block by
    ``lm_param_shardings``.  Falls back to ``_ffn_moe`` on JAX's
    conditions: no mesh, or ``_ep_applies`` false."""
    mesh = get_dist_mesh()
    B, T, D = x.shape
    R = None if mesh is None else _Mesh(mesh)
    if R is None or not _ep_applies(cfg, B * T, R.n_dp):
        return _ffn_moe(cfg, lp, x)
    ls = {n: _ep_leaf_spec(cfg, R, n, lp[n]) for n in EXPERT_LEAVES
          if n in lp}
    ls["router"] = None
    n = len(R.ranks)
    ys, aux = _moe_ep(cfg, R, [lp] * n, ls, [x] * n, rows_split=False)
    return ys[0], aux


def _moe(cfg, R, lps, ls, hs, rows_split: bool):
    """The MoE FFN on each rank -> (outputs, aux of the whole batch).  A
    whole tree: ``_ffn_moe_ep`` (``moe_impl="ep"``) or ``_ffn_moe``.  Over
    a mesh: ``_moe_ep`` on each rank's rows where ``moe_impl="ep"`` and
    ``_ep_applies``; else ``_ffn_moe`` of the whole batch on each rank,
    the experts and the router gathered whole, each rank keeping its
    rows."""
    if R.mesh is None:
        y, aux = (_ffn_moe_ep if cfg.moe_impl == "ep" else _ffn_moe)(
            cfg, lps[0], hs[0])
        return [y], aux
    S = hs[0].shape[0] * hs[0].shape[1] * (R.n_dp if rows_split else 1)
    if cfg.moe_impl == "ep" and _ep_applies(cfg, S, R.n_dp):
        return _moe_ep(cfg, R, lps, ls, hs, rows_split)
    names = [n for n in EXPERT_LEAVES + ("router",) if n in lps[0]]
    w = {n: R.whole([lp[n] for lp in lps], ls[n]) for n in names}
    gather = rows_split and R.n_dp > 1
    xs = R.tr.axis_gather(R.mesh, R.dp, hs, 0) if gather else hs
    ys, aux = [], None
    for k, x in enumerate(xs):
        y, aux = _ffn_moe(cfg, {n: w[n][k] for n in names}, x)
        if gather:
            y = y[R.d[k] * hs[k].shape[0]:(R.d[k] + 1) * hs[k].shape[0]]
        ys.append(y)
    return ys, aux


def _layer(cfg, R, lps, ls, xs, pos, rows_split=False, caches=None,
           lengths=None, cspec=None):
    """One layer on each rank -> (outputs, aux)."""
    xs = [ct_cast(x) for x in xs]   # the backward residual stream in cd
    h = [_norm(cfg, x, lp["ln1"], lp.get("ln1b")) for x, lp in zip(xs, lps)]
    a = _attn(cfg, R, lps, ls, h, pos, caches, lengths, cspec)
    xs = [x + y for x, y in zip(xs, a)]
    h = [_norm(cfg, x, lp["ln2"], lp.get("ln2b")) for x, lp in zip(xs, lps)]
    aux = torch.zeros((), device=xs[0].device)
    if cfg.n_experts:
        f, aux = _moe(cfg, R, lps, ls, h, rows_split)
        if cfg.dense_residual:
            f = [y + z for y, z in zip(f, _ffn_dense(cfg, R, lps, ls, h))]
    else:
        f = _ffn_dense(cfg, R, lps, ls, h)
    return [x + y for x, y in zip(xs, f)], aux


def _layers(cfg, R, P, xs, pos, rows_split, caches=None, lengths=None,
            cspec=None):
    """Every layer in turn -> (outputs, aux summed over the layers).  With
    ``cfg.remat`` and gradients on, each layer runs under
    ``torch.utils.checkpoint``; ``caches`` hold each rank's ``(k, v)``
    stacks over the layers."""
    aux = torch.zeros((), device=xs[0].device)
    remat = cfg.remat and torch.is_grad_enabled() and caches is None
    for i in range(cfg.n_layers):
        lps, ls = _layer_blocks(P, i)
        if remat:
            xs, a = torch.utils.checkpoint.checkpoint(
                _layer, cfg, R, lps, ls, xs, pos, rows_split,
                use_reentrant=False)
        else:
            c = None if caches is None else \
                [(ck[i], cv[i]) for ck, cv in caches]
            xs, a = _layer(cfg, R, lps, ls, xs, pos, rows_split, c, lengths,
                           cspec)
        aux = aux + a
    return xs, aux


def _trunk(cfg, R, P, tokens, positions):
    """(each rank's final-normed hidden states, aux, the batch
    dimension's spec entry)."""
    toks, bspec = R.rows(tokens)
    if positions is None:
        pos = [torch.arange(t.shape[1], device=t.device).expand(t.shape)
               for t in toks]
    else:
        pos, _ = R.rows(positions)
    xs = _embed(cfg, R, P, toks)
    xs, aux = _layers(cfg, R, P, xs, pos, bspec is not None)
    xs = [rms_norm(x, t["final_norm"]) for x, t in zip(xs, P.blocks)]
    return xs, aux, bspec


def _unplace(R, P, spec, blocks):
    """A whole tree's one block, or the blocks ``Placed`` by ``spec``."""
    return blocks[0] if R.mesh is None else \
        sharding.Placed(P.mesh, spec, blocks)


def lm_trunk(cfg: LMConfig, params, tokens, positions=None):
    """tokens: [B, T] -> (the final-normed hidden states [B, T, D], aux
    summed over the layers).  The embedding rows are gathered and then
    cast (JAX casts the whole table, then gathers: the same bits, without
    a cast of the table).  On a ``Placed`` tree (laid out by
    ``lm_param_shardings``) the forward runs over the registered mesh,
    each rank on its blocks, and the hidden states come ``Placed`` by
    batch rows."""
    R, P = _placed(params)
    xs, aux, bspec = _trunk(cfg, R, P, tokens, positions)
    return _unplace(R, P, (bspec, None, None), xs), aux


def lm_forward(cfg: LMConfig, params, tokens, positions=None):
    """tokens: [B, T] -> (logits [B, T, vocab] in the compute dtype, aux)
    (training/prefill, causal).  aux is the MoE load-balancing loss summed
    over the layers: 0 for the dense FFN.  On a ``Placed`` tree the logits
    come ``Placed`` by batch rows and, as JAX constrains them, time over
    ``model`` where it divides (JAX keeps no [T, V] on a device)."""
    R, P = _placed(params)
    xs, aux, bspec = _trunk(cfg, R, P, tokens, positions)
    un = R.wcast(P.blocks, P.specs, "unembed", cfg)
    T = xs[0].shape[1]
    tsplit = R.tp > 1 and T % R.tp == 0
    out = []
    for k, x in enumerate(xs):
        if tsplit:
            x = x[:, R.m[k] * T // R.tp:(R.m[k] + 1) * T // R.tp]
        out.append(x @ un[k])
    spec = (bspec, "model" if tsplit else None, None)
    return _unplace(R, P, spec, out), aux


def lm_last_logits(cfg: LMConfig, params, tokens):
    """tokens [B, T] -> the last position's logits [B, vocab] (compute
    dtype): the numbers of ``lm_forward(...)[0][:, -1]``, without the
    [B, T, vocab] logits (``Placed`` by batch rows on a ``Placed``
    tree)."""
    R, P = _placed(params)
    xs, _, bspec = _trunk(cfg, R, P, tokens, None)
    un = R.wcast(P.blocks, P.specs, "unembed", cfg)
    return _unplace(R, P, (bspec, None),
                    [h[:, -1] @ u for h, u in zip(xs, un)])


def lm_loss(cfg: LMConfig, params, batch):
    """batch: dict(tokens [B,T], targets [B,T]).  Cross-entropy from the
    compute-dtype logits with f32 reductions, plus 0.01 x aux / n_layers
    for a MoE config."""
    logits, aux = lm_forward(cfg, params, batch["tokens"])
    tgt = logits.gather(-1, batch["targets"][..., None].long())[..., 0]
    lse = torch.logsumexp(logits.float(), dim=-1)
    loss = (lse - tgt.float()).mean()
    if cfg.n_experts:
        loss = loss + 0.01 * aux / cfg.n_layers
    return loss


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
    and donates the old); lengths: [B] current cache fill.  A MoE layer
    routes the B tokens as one batch (S = B), as JAX's does.  On a
    ``Placed`` tree the step runs over the registered mesh: the cache
    ``Placed`` by ``lm_cache_shardings`` (laid out here where given
    whole), the logits by batch rows."""
    R, P = _placed(params)
    toks, bspec = R.rows(tokens)
    T = toks[0].shape[1]
    if T != 1:
        raise ValueError(
            f"lm_decode_step takes one token a slot, not {T}: the JAX "
            f"package's decode_attention reads q[:, 0] only, so a step of "
            f"T > 1 there drops queries 1 and up")
    if R.mesh is None:
        caches, lens, cspec = [kv_cache], [lengths], None
    else:
        if not isinstance(kv_cache, sharding.Placed):
            kv_cache = sharding.lay_out(kv_cache, R.mesh,
                                        sharding.lm_cache_shardings(
                                            R.mesh, cfg,
                                            kv_cache[0].shape[1]))
        lens = lengths.blocks if isinstance(lengths, sharding.Placed) else \
            sharding.lay_out(lengths, R.mesh,
                             (kv_cache.specs[0][1],)).blocks
        caches, cspec = kv_cache.blocks, kv_cache.specs[0][1:]
    pos = [n[:, None] + torch.arange(T, device=t.device)[None, :]
           for n, t in zip(lens, toks)]
    xs = _embed(cfg, R, P, toks)
    xs, _ = _layers(cfg, R, P, xs, pos, bspec is not None, caches, lens,
                    cspec)
    xs = [rms_norm(x, t["final_norm"]) for x, t in zip(xs, P.blocks)]
    un = R.wcast(P.blocks, P.specs, "unembed", cfg)
    logits = [(x @ u).float() for x, u in zip(xs, un)]
    return _unplace(R, P, (bspec, None, None), logits), kv_cache


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
