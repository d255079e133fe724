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
