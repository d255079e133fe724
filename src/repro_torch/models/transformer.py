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

* the sharding pins (``wcast``'s ``constrain``, ``model_size``) are no-ops
  on one device: ``wcast(w)`` is ``w.to(cfg.compute_dtype)``;
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
auxiliary loss.  ``_ffn_moe_ep`` is JAX's expert parallelism over the
registered port mesh (``dist.ctx.get_dist_mesh``), a function of its own
(its own capacity floor, f32 gates and a bf16 sum over ``model``): the
two agree only where neither drops a token.
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
from repro_torch.dist.ctx import dp_axes_active, get_dist_mesh
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


def init_lm_params(cfg: LMConfig, gen: torch.Generator, mesh=None,
                   rank: int = 0) -> dict:
    """Random parameters on ``gen``'s device, in the JAX package's tree
    (stacked ``[L, ...]``); each dense leaf drawn in place, Normal(0,
    1/sqrt(fan_in)).  The experts' leaves (``EXPERT_LEAVES``) are drawn
    matrix by matrix, expert ``e`` of layer ``l`` from a generator seeded
    ``s + l * E + e``, ``s`` drawn from ``gen`` once a leaf; so with
    ``mesh``, the process draws only the block of each that ``rank``
    holds by ``dist.sharding.lm_param_shardings`` (the rest whole), bit
    for bit that block of the whole draw."""
    dev = gen.device

    def experts(name, shape, fan_in):
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=gen,
                                 device=dev))
        L, E = shape[:2]
        idx = (slice(None),) * 4
        if mesh is not None:
            spec = (None, *sharding.lm_layer_spec(mesh, name, shape[1:]))
            idx = sharding.block_slices(mesh, shape, spec, rank)
        es = range(E)[idx[1]]
        out = torch.empty([len(range(n)[i]) for n, i in zip(shape, idx)],
                          dtype=cfg.param_dtype, device=dev)
        for l in range(L):
            for i, e in enumerate(es):
                g = torch.Generator(device=dev).manual_seed(seed + l * E + e)
                out[l, i] = dense_init(g, shape[2:], fan_in,
                                       cfg.param_dtype)[idx[2], idx[3]]
        return out

    def make(spec, name=""):
        if isinstance(spec, dict):
            return {k: make(v, k) for k, v in spec.items()}
        shape, init = spec
        if init == ONES:
            return torch.ones(shape, dtype=cfg.param_dtype, device=dev)
        if init == ZEROS:
            return torch.zeros(shape, dtype=cfg.param_dtype, device=dev)
        if name in EXPERT_LEAVES:
            return experts(name, shape, init)
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
        o = flash_attention(ct_cast(q), ct_cast(k), ct_cast(v), causal=True)
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
            f"{cfg.n_experts} experts, a rank's block: only _ffn_moe_ep, "
            f"on the mesh it was cut for, reads a block")


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


def _ep_weights(cfg: LMConfig, mesh, lp, ranks) -> list:
    """Each local rank's (wi, wg, wo) of its experts, in the compute dtype
    and whole on D: its block by ``lm_param_shardings``' spec (cut from
    the whole leaf, or the leaf itself where this process holds one
    rank's block), cast, then gathered over the dp axes, as JAX casts
    and all-gathers the D-sharded bf16 weights."""
    dp = dp_axes_active(mesh)
    out = []
    for name in EXPERT_LEAVES:
        if name == "moe_wg" and not cfg.gated_ffn:
            out.append([None] * len(ranks))
            continue
        w = lp[name]
        if name == "moe_wo":
            whole = (cfg.n_experts, cfg.d_ff, cfg.d_model)
        else:
            whole = (cfg.n_experts, cfg.d_model, cfg.d_ff)
        spec = sharding.lm_layer_spec(mesh, name, whole)
        if tuple(w.shape) == whole:
            blocks = [sharding.shard_block(w, mesh, spec, r) for r in ranks]
        else:
            want = tuple(len(range(n)[i]) for n, i in zip(
                whole, sharding.block_slices(mesh, whole, spec, ranks[0])))
            if len(ranks) != 1 or tuple(w.shape) != want:
                raise ValueError(f"{name}: {tuple(w.shape)} is neither the "
                                 f"whole leaf {whole} nor this process's "
                                 f"block {want}")
            blocks = [w]
        blocks = [b.to(cfg.compute_dtype) for b in blocks]
        out.append(mesh.transport.axis_gather(
            mesh, dp, blocks, 2 if name == "moe_wo" else 1))
    return list(zip(*out))


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


def _ffn_moe_ep(cfg: LMConfig, lp, x):
    """Expert parallelism over the registered mesh (JAX's ``_ffn_moe_ep``
    under ``shard_map``): the experts split over ``model``, the tokens
    over the dp axes, each rank routing its tokens to its own ``E //
    n_model`` experts with its own capacity ``max(ceil(S_loc K cf / E),
    8)``, and a bf16 sum over ``model`` completing the combine.  Falls
    back to ``_ffn_moe`` on JAX's conditions: no mesh, S not a multiple
    of the dp size, or ``(S // n_dp) * K < E // 4``.

    On ``LocalTiles`` every rank runs in this process and the output is
    the dp shards' in order.  Over processes (``ProcessGroupTiles``) this
    process runs its rank; that needs ``data`` 1, as every process holds
    the whole batch (the port shards no activations: ``constrain`` is an
    identity), so the dp shards have no process of their own to run
    them."""
    mesh = get_dist_mesh()
    dp = dp_axes_active(mesh)
    B, T, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    S = B * T
    n_dp = 1 if mesh is None else math.prod(mesh.shape[a] for a in dp)
    if mesh is None or S % n_dp or (S // n_dp) * K < E // 4:
        # tiny token counts (e.g. batch-1 decode): dense dispatch is cheap
        return _ffn_moe(cfg, lp, x)
    n_model = mesh.shape["model"]
    ranks = mesh.local_ranks
    if mesh.transport is None:
        raise ValueError("_ffn_moe_ep needs a mesh with a transport "
                         "(LocalTiles or ProcessGroupTiles)")
    if len(ranks) < mesh.size and n_dp > 1:
        raise NotImplementedError(
            f"_ffn_moe_ep over processes runs at data 1, not over "
            f"{dict(mesh.shape)}: every process holds the whole batch (the "
            f"port shards no activations), so a dp shard has no process of "
            f"its own")
    if E % n_model or cfg.d_model % n_dp:
        raise ValueError(f"{E} experts over model {n_model} and d_model "
                         f"{cfg.d_model} over dp {n_dp} do not split")
    E_loc, S_loc = E // n_model, S // n_dp
    cap = _capacity(cfg, S_loc, 8)
    xs = x.reshape(S, D).to(cfg.compute_dtype)
    _, topv, topi, aux = _route(cfg, lp, xs)
    weights = _ep_weights(cfg, mesh, lp, ranks)
    parts = []
    for r, w in zip(ranks, weights):
        d = mesh.axis_index(r, dp)
        sl = slice(d * S_loc, (d + 1) * S_loc)
        parts.append(_ep_rank(cfg, w, xs[sl], topi[sl], topv[sl],
                              mesh.coords(r)["model"] * E_loc, cap))
    summed = mesh.transport.axis_sum(mesh, ("model",), parts)
    if len(ranks) == 1:
        return summed[0].view(B, T, D), aux
    out = torch.empty_like(xs)
    for r, y in zip(ranks, summed):
        d = mesh.axis_index(r, dp)
        out[d * S_loc:(d + 1) * S_loc] = y
    return out.view(B, T, D), aux


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
    """One layer -> (x, aux, new cache)."""
    x = ct_cast(x)   # the backward residual stream in the compute dtype
    a, new_cache = _attn(cfg, lp, _norm(cfg, x, lp["ln1"], lp.get("ln1b")),
                         positions, kv_cache, lengths)
    x = x + a
    h = _norm(cfg, x, lp["ln2"], lp.get("ln2b"))
    aux = torch.zeros((), device=x.device)
    if cfg.n_experts:
        moe = _ffn_moe_ep if cfg.moe_impl == "ep" else _ffn_moe
        f, aux = moe(cfg, lp, h)
        if cfg.dense_residual:
            f = f + _ffn_dense(cfg, lp, h)
    else:
        f = _ffn_dense(cfg, lp, h)
    return x + f, aux, new_cache


def _layer_params(params, i: int) -> dict:
    return {k: v[i] for k, v in params["layers"].items()}


def lm_trunk(cfg: LMConfig, params, tokens, positions=None):
    """tokens: [B, T] -> (the final-normed hidden states [B, T, D], aux
    summed over the layers).  The embedding rows are gathered and then
    cast (JAX casts the whole table, then gathers: the same bits, without
    a cast of the table)."""
    B, T = tokens.shape
    if positions is None:
        positions = torch.arange(T, device=tokens.device).expand(B, T)
    x = params["embed"][tokens].to(cfg.compute_dtype)
    aux = torch.zeros((), device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(cfg.n_layers):
        lp = _layer_params(params, i)
        if remat:
            x, a = torch.utils.checkpoint.checkpoint(
                _layer_xa, cfg, lp, x, positions, use_reentrant=False)
        else:
            x, a = _layer_xa(cfg, lp, x, positions)
        aux = aux + a
    return rms_norm(x, params["final_norm"]), aux


def _layer_xa(cfg, lp, x, positions):
    x, a, _ = _layer(cfg, lp, x, positions)
    return x, a


def lm_forward(cfg: LMConfig, params, tokens, positions=None):
    """tokens: [B, T] -> (logits [B, T, vocab] in the compute dtype, aux)
    (training/prefill, causal).  aux is the MoE load-balancing loss summed
    over the layers: 0 for the dense FFN."""
    x, aux = lm_trunk(cfg, params, tokens, positions)
    return x @ params["unembed"].to(cfg.compute_dtype), aux


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
    routes the B tokens as one batch (S = B), as JAX's does."""
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
        x, _, _ = _layer(cfg, _layer_params(params, i), x, positions,
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
