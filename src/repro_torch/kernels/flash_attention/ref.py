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


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """q: [B, Tq, H, dh]; k/v: [B, Tk, Kh, dh] -> [B, Tq, H, dh]."""
    B, Tq, H, dh = q.shape
    Tk, Kh = k.shape[1], k.shape[2]
    G = H // Kh
    qf = (q.float() * (1.0 / math.sqrt(dh))).reshape(B, Tq, Kh, G, dh)
    s = torch.einsum("btkgd,bskd->bkgts", qf, k.float())
    if causal:
        rows = torch.arange(Tq, device=q.device)[:, None]
        cols = torch.arange(Tk, device=q.device)[None, :]
        s = s.masked_fill(cols > rows, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgts,bskd->btkgd", p, v.float())
    out = acc / l.clamp(min=1e-30).permute(0, 3, 1, 2)[..., None]
    return out.reshape(B, Tq, H, dh).to(q.dtype)
