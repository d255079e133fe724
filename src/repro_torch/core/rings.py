"""Vectorized fixed-capacity ring buffers over the cell grid.

Every queue in the machine (action queues, channel buffers, future
queues) is a ring buffer with leading batch dims (e.g. ``[H, W]``), a
capacity axis and a trailing message-word axis.  Pushes and pops are
one-hot ``where`` ops, as in the JAX engine, so the plain version keeps
its data flow.
"""
from __future__ import annotations

import torch


def _iota(cap: int, device) -> torch.Tensor:
    return torch.arange(cap, dtype=torch.int32, device=device)


def ring_push(buf, cnt, head, msg, mask):
    """Masked FIFO push: append ``msg`` at the tail wherever ``mask``.

    Shapes: ``buf [*B, CAP, W]``, ``cnt/head/mask [*B]``, ``msg [*B, W]``.
    Returns the updated ``(buf, cnt)``.  The caller guarantees
    ``cnt < CAP`` wherever ``mask`` is True.
    """
    cap = buf.shape[-2]
    tail = (head + cnt) % cap
    oh = (_iota(cap, buf.device) == tail[..., None]) & mask[..., None]
    buf = torch.where(oh[..., None], msg[..., None, :], buf)
    cnt = cnt + mask.to(cnt.dtype)
    return buf, cnt


def ring_peek(buf, head):
    """Read every ring's head element without consuming it:
    ``buf [*B, CAP, W]``, ``head [*B]`` -> ``[*B, W]``."""
    cap = buf.shape[-2]
    idx = (head % cap).long()[..., None, None].expand(
        *head.shape, 1, buf.shape[-1])
    return torch.gather(buf, -2, idx).squeeze(-2)


def ring_pop(cnt, head, cap: int, mask):
    """Masked pop: advance ``head`` and decrement ``cnt`` where ``mask``."""
    m = mask.to(cnt.dtype)
    return cnt - m, (head + m) % cap


def ring_free(cnt, cap: int, reserve: int = 0):
    """Admission predicate: True where ``cnt < cap - reserve``."""
    return cnt < (cap - reserve)
