"""Gradient compression for the slow inter-pod axis (the port of
``repro.optim.compression``).

int8 block quantization with error feedback: the quantization error is
carried to the next step in a residual, which keeps compressed SGD/Adam
convergent (the 1-bit Adam / EF-SGD lineage).  ``torch.round`` rounds
half to even, as ``jnp.round`` does, so both packages give the same
``q``, ``scale`` and residuals bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.dist.sharding import tree_leaves


def quantize_int8(x, block: int = 256):
    """x: any float tensor -> (q int8 [n_blocks, block], scale f32
    [n_blocks, 1] per block, pad)."""
    flat = x.reshape(-1)
    pad = (-flat.numel()) % block
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    blocks = flat.reshape(-1, block)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale.float(), pad


def dequantize_int8(q, scale, pad, shape):
    flat = (q.float() * scale).reshape(-1)
    if pad:
        flat = flat[:-pad]
    return flat.reshape(shape)


def _rebuild(tree, leaves):
    """``tree``'s structure of dicts, lists and tuples with ``leaves`` in
    order (a tuple of three is a leaf of ``comp``)."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "shape"):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    return next(leaves)


def compress_with_feedback(grads, residuals, block: int = 256):
    """Returns (compressed repr, new residuals).  residuals: a tree like
    grads (the running quantization error, f32)."""
    comp, res = [], []
    for g, r in zip(tree_leaves(grads), tree_leaves(residuals)):
        gf = g.float() + r
        q, s, pad = quantize_int8(gf, block)
        comp.append((q, s, pad))
        res.append(gf - dequantize_int8(q, s, pad, gf.shape))
    return (_rebuild(grads, iter(comp)), _rebuild(grads, iter(res)))


def decompress(comp, grads_like):
    """The tree of ``grads_like`` from ``comp``, each leaf in its dtype."""
    out = []

    def walk(c, g):
        if isinstance(g, dict):
            for k in g:
                walk(c[k], g[k])
        elif isinstance(g, (list, tuple)):
            for ci, gi in zip(c, g):
                walk(ci, gi)
        else:
            q, s, pad = c
            out.append(dequantize_int8(q, s, pad, g.shape).to(g.dtype))
    walk(comp, grads_like)
    return _rebuild(grads_like, iter(out))


def init_residuals(grads_like):
    return _rebuild(grads_like, iter(
        torch.zeros(g.shape, dtype=torch.float32, device=g.device)
        for g in tree_leaves(grads_like)))
