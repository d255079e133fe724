"""Active-message ("action") codec.

A message is a fixed 5-word int32 record::

    word 0  opcode        (OP_*, 0 = empty)
    word 1  dst address   (cell * slots + slot)
    word 2  arg0
    word 3  arg1
    word 4  arg2, or with ``cfg.faults`` the seal (:func:`msg_seal`)

Float arguments (application values, e.g. BFS levels) ride the int32
words by bit-cast (``Tensor.view``), never by value conversion, so a
payload crosses the network bit for bit.

Query batching (``repro_torch.mq``, DESIGN §10) widens the record to
``5 + (qbatch - 1)`` words.  Words 0-4 keep their meaning: payload slot 0
stays in word 2 and the seal slot in word 4; payload slots
``1 .. qbatch-1`` ride the extension words ``5 ..``.  For the app-like
opcodes (``OP_APP``, ``OP_RHIZOME_FWD``) word 3 is the **qsel** bitmask:
0 selects every query slot, bit ``q`` set restricts the relax to slot
``q`` (an admission seed).  ``OP_ALLOC`` keeps its requester value in
word 3 and carries slots ``1 ..`` in the extension words.  At
``qbatch == 1`` the record is the 5-word one.
"""
from __future__ import annotations

import torch

MSG_WORDS = 5

# ---- opcodes ----
OP_NOP = 0
OP_INSERT_EDGE = 1    # args: (edge dst root addr, weight bits, -)
OP_APP = 2            # args: (value bits, -, -)   the application action
OP_ALLOC = 3          # args: (requester addr, requester value bits, -)
OP_SET_FUTURE = 4     # args: (new ghost addr, -, -)
OP_RHIZOME_FWD = 5    # args: (value bits, -, -)   sibling-rhizome value sync
OP_LINK_RHIZOME = 6   # args: (requester rhizome addr, -, -)
OP_REPAIR = 7         # args: (value bits, -, -)   recovery-path relax

# ---- directions (mesh links) ----
DIR_N, DIR_S, DIR_W, DIR_E = 0, 1, 2, 3
N_DIRS = 4

# ---- staging target-buffer codes (exec stage) ----
TB_CHAN_N, TB_CHAN_S, TB_CHAN_W, TB_CHAN_E = 0, 1, 2, 3
TB_AQ_SELF = 4


def f2i(x: torch.Tensor) -> torch.Tensor:
    """Bit-cast float32 -> int32 (payload word)."""
    return x.to(torch.float32).contiguous().view(torch.int32)


def i2f(x: torch.Tensor) -> torch.Tensor:
    """Bit-cast int32 -> float32."""
    return x.to(torch.int32).contiguous().view(torch.float32)


def make_msg(op, dst, a0=0, a1=0, a2=0) -> torch.Tensor:
    """Build a message; broadcasting over leading dims.  At least one
    argument must be a tensor (it fixes the device)."""
    dev = next(a.device for a in (op, dst, a0, a1, a2)
               if isinstance(a, torch.Tensor))
    parts = torch.broadcast_tensors(*(
        torch.as_tensor(a, dtype=torch.int32, device=dev)
        for a in (op, dst, a0, a1, a2)))
    return torch.stack(parts, dim=-1)


def msg_seal(m: torch.Tensor) -> torch.Tensor:
    """Integrity seal of a message: the XOR of words 0..3.  Word 4, which
    no opcode reads, holds it wherever ``cfg.faults`` is set: staging and
    the IO cells seal what they inject, and phase 0 discards an
    application message whose seal no longer matches (DESIGN §9)."""
    return m[..., 0] ^ m[..., 1] ^ m[..., 2] ^ m[..., 3]


def seal_msg(m: torch.Tensor) -> torch.Tensor:
    """``m`` with word 4 set to :func:`msg_seal`."""
    return torch.cat([m[..., :4], msg_seal(m)[..., None]], dim=-1)


# ---------------- query-batched (vector payload) helpers (DESIGN §10) ----


def msg_words(qbatch: int) -> int:
    """Record width in int32 words for a query batch of ``qbatch``."""
    return MSG_WORDS + max(0, qbatch - 1)


def pad_msg(m: torch.Tensor, n_words: int) -> torch.Tensor:
    """``m`` right-padded with zero extension words to ``n_words`` (the
    non-app opcodes, whose extension words are dead payload)."""
    if m.shape[-1] == n_words:
        return m
    pad = torch.zeros(m.shape[:-1] + (n_words - m.shape[-1],),
                      dtype=m.dtype, device=m.device)
    return torch.cat([m, pad], dim=-1)


def msg_qvals(m: torch.Tensor, qbatch: int) -> torch.Tensor:
    """The ``[..., qbatch]`` int32 payload of an app-like message: word 2
    is slot 0, the extension words slots 1.. (bit-cast floats)."""
    if qbatch == 1:
        return m[..., 2:3]
    return torch.cat([m[..., 2:3], m[..., MSG_WORDS:]], dim=-1)


def make_qmsg(op, dst, qbits: torch.Tensor, a1=0) -> torch.Tensor:
    """An app-like message carrying the ``[..., Q]`` int32 payload
    ``qbits``: slot 0 in word 2, slots 1.. in the extension words, the
    qsel mask ``a1`` in word 3.  At ``Q == 1`` it is :func:`make_msg`."""
    head = make_msg(op, dst, qbits[..., 0], a1)
    if qbits.shape[-1] == 1:
        return head
    return torch.cat([head, qbits[..., 1:]], dim=-1)


def qsel_mask(a1: torch.Tensor, qbatch: int) -> torch.Tensor:
    """``[..., qbatch]`` bool: the query slots an app-like message
    addresses: all where ``a1 == 0``, else the slots of ``a1``'s set
    bits."""
    q = torch.arange(qbatch, dtype=torch.int32, device=a1.device)
    bits = (a1[..., None] >> q) & 1
    return (a1[..., None] == 0) | (bits == 1)
