"""Plain PyTorch version of the flash-attention forward: the function of
``repro/kernels/flash_attention/kernel.py::_fa_kernel``.

f32 math on the cast inputs: ``q`` is scaled by ``1/sqrt(dh)`` after the
cast, the scores are masked to ``NEG_INF`` where ``col > row`` (both
counted from 0, as ``_fa_kernel`` does; ``ref.py::attention_ref`` of the
JAX package aligns the diagonal at the end instead, and the two agree only
when ``Tq == Tk``), and the output is ``acc / max(l, 1e-30)`` in q's
dtype.  GQA reads KV head ``h // G`` through a reshape, with no repeat.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _scores(q, k, causal: bool, t0: int = 0):
    """The scaled, masked f32 scores of query rows ``t0..`` of ``q``
    against every key: [B, Kh, G, Tq', Tk]."""
    B, Tq, H, dh = q.shape
    Tk, Kh = k.shape[1], k.shape[2]
    qf = (q.float() * (1.0 / math.sqrt(dh))).reshape(B, Tq, Kh, H // Kh, dh)
    s = torch.einsum("btkgd,bskd->bkgts", qf, k.float())
    if causal:
        rows = t0 + torch.arange(Tq, device=q.device)[:, None]
        cols = torch.arange(Tk, device=q.device)[None, :]
        s = s.masked_fill(cols > rows, NEG_INF)
    return s


def flash_attention_fwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, causal: bool = True
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """q: [B, Tq, H, dh]; k/v: [B, Tk, Kh, dh] -> (out [B, Tq, H, dh] in
    q's dtype, lse [B, H, Tq] f32: each row's log-sum-exp of the scaled
    scores, m + log(max(l, 1e-30)), what the forward kernels store)."""
    B, Tq, H, dh = q.shape
    s = _scores(q, k, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1).clamp(min=1e-30)                   # [B, Kh, G, Tq]
    acc = torch.einsum("bkgts,bskd->btkgd", p, v.float())
    out = acc / l.permute(0, 3, 1, 2)[..., None]
    lse = (m[..., 0] + torch.log(l)).reshape(B, H, Tq)
    return out.reshape(B, Tq, H, dh).to(q.dtype), lse


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """q: [B, Tq, H, dh]; k/v: [B, Tk, Kh, dh] -> [B, Tq, H, dh]."""
    return flash_attention_fwd_ref(q, k, v, causal)[0]


def flash_attention_bwd_ref(q, k, v, o, lse, dout, causal: bool = True,
                            chunk: int = 512):
    """The plain backward of the forward above, given its output ``o``
    and ``lse`` [B, H, Tq] and the output gradient ``dout``: (dq, dk, dv)
    f32, in f32 math over query tiles of ``chunk`` rows (so the
    probabilities of a tile, [B, H, chunk, Tk] f32, are all it holds):
    delta = rowsum(dout o), P = exp(S - lse), dV = P^T dO, dS = P (dO V^T -
    delta), dQ = dS K / sqrt(dh), dK = dS^T Q / sqrt(dh).  The backward
    kernel (``csrc/flash_attention_bwd.cuh``) is held to it."""
    B, Tq, H, dh = q.shape
    Tk, Kh = k.shape[1], k.shape[2]
    G = H // Kh
    scale = 1.0 / math.sqrt(dh)
    kf, vf = k.float(), v.float()
    dq = torch.empty((B, Tq, H, dh), dtype=torch.float32, device=q.device)
    dk = torch.zeros((B, Tk, Kh, dh), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for t0 in range(0, Tq, chunk):
        t1 = min(t0 + chunk, Tq)
        s = _scores(q[:, t0:t1], k, causal, t0)           # [B,Kh,G,t,Tk]
        lse_t = lse[:, :, t0:t1].reshape(B, Kh, G, t1 - t0, 1)
        p = torch.exp(s - lse_t)
        do = dout[:, t0:t1].float().reshape(B, t1 - t0, Kh, G, dh)
        delta = (do * o[:, t0:t1].float().reshape(do.shape)).sum(-1)
        dv += torch.einsum("bkgts,btkgd->bskd", p, do)
        dp = torch.einsum("btkgd,bskd->bkgts", do, vf)
        ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
        dq[:, t0:t1] = (torch.einsum("bkgts,bskd->btkgd", ds, kf)
                        * scale).reshape(B, t1 - t0, H, dh)
        qf = q[:, t0:t1].float().reshape(B, t1 - t0, Kh, G, dh)
        dk += torch.einsum("bkgts,btkgd->bskd", ds, qf) * scale
    return dq, dk, dv


def tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to tf32 (1 + 10 bits; to nearest, ties away from
    0), by bit operations on its f32 encoding: the low 13 bits are 0, as
    the 3xTF32 kernel's ``cvt.rna.tf32.f32`` and mask leave them."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) = (tf32(x), tf32(x - hi)); x - hi is exact in f32."""
    hi = tf32(x)
    return hi, tf32(x.float() - hi)


def key_order(tk: int) -> torch.Tensor:
    """The 3xTF32 kernel's order of the keys in each group of 8 (0 2 4 6 1
    3 5 7, so that P's A fragment is the accumulator as it lies):
    position i of V^T holds key ``key_order(tk)[i]``; ``tk`` a multiple
    of 8."""
    i = torch.arange(tk)
    return (i & ~7) + 2 * (i % 4) + (i % 8) // 4


def flash_attention_tf32x3(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, causal: bool = True,
                           terms: int = 3,
                           order: torch.Tensor | None = None,
                           v_order: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """The 3xTF32 kernel's arithmetic in plain PyTorch (tests only): every
    operand split into tf32 hi and lo, S = Q_hi K_lo^T + Q_lo K_hi^T + Q_hi
    K_hi^T and O = P_lo V_hi + P_hi V_lo + P_hi V_hi (products of tf32
    values exact in f32, summed in f32), the softmax in f32 as
    ``flash_attention_ref``.  ``terms=1`` keeps only hi x hi (one TF32
    product).  ``order`` permutes the keys of P and ``v_order`` those of V
    before P V (``v_order`` defaults to ``order``); f32 out."""
    B, Tq, H, dh = q.shape
    Tk, Kh = k.shape[1], k.shape[2]
    G = H // Kh
    qh, ql = tf32_split((q.float() * (1.0 / math.sqrt(dh))).reshape(
        B, Tq, Kh, G, dh))
    kh, kl = tf32_split(k)

    def qk(a, b):
        return torch.einsum("btkgd,bskd->bkgts", a, b)
    s = qk(qh, kh) if terms == 1 else qk(qh, kl) + qk(ql, kh) + qk(qh, kh)
    if causal:
        rows = torch.arange(Tq, device=q.device)[:, None]
        cols = torch.arange(Tk, device=q.device)[None, :]
        s = s.masked_fill(cols > rows, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1)
    vv = v.float()
    v_order = order if v_order is None else v_order
    if order is not None:
        p = p[..., order]
    if v_order is not None:
        vv = vv[:, v_order]
    ph, pl = tf32_split(p)
    vh, vl = tf32_split(vv)

    def pv(a, b):
        return torch.einsum("bkgts,bskd->btkgd", a, b)
    acc = pv(ph, vh) if terms == 1 else pv(pl, vh) + pv(ph, vl) + pv(ph, vh)
    out = acc / l.clamp(min=1e-30).permute(0, 3, 1, 2)[..., None]
    return out.reshape(B, Tq, H, dh)
