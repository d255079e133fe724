"""Ghost-vertex allocation (paper Fig. 5) and root placement.

The *vicinity allocator* keeps ghost vertices within ``vicinity_hops``
(default 2) of the requesting cell: a rotating per-cell counter walks a
nearest-first table of ring offsets, so the choice is deterministic yet
spread out.  The *random allocator* hashes (cell, counter) to any cell of
the chip.  If the chosen cell is full, its ``allocate`` handler forwards
the request to the next cell (linear probe).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.config import EngineConfig


def rhizome_addr(cfg: EngineConfig, vid, k):
    """Global address of rhizome root ``k`` of vertex ``vid``: slot
    ``k * root_slots + vid // n_cells`` of cell ``(vid + k * stride) %
    n_cells``.  At ``rhizome_cap=1`` only ``k=0``, the canonical root."""
    cell = (vid + k * cfg.rhizome_stride) % cfg.n_cells
    return cell * cfg.slots + k * cfg.root_slots + vid // cfg.n_cells


def rhizome_rcs(cfg: EngineConfig, vid, k):
    """Host-side placement: (row, col, slot) of rhizome root ``k``."""
    cell = (vid + k * cfg.rhizome_stride) % cfg.n_cells
    return (cell // cfg.width, cell % cfg.width,
            k * cfg.root_slots + vid // cfg.n_cells)


def rhizome_owner_vid(cfg: EngineConfig, cellid, slot):
    """Inverse placement map: vertex id owning primary ``slot`` of
    ``cellid``."""
    k = slot // cfg.root_slots
    j = slot % cfg.root_slots
    home = (cellid - k * cfg.rhizome_stride) % cfg.n_cells
    return j * cfg.n_cells + home


def vicinity_offsets(hops: int) -> np.ndarray:
    """``[K, 2]`` (dy, dx) ring offsets with Chebyshev distance in
    ``[1, hops]``, nearest first."""
    offs = [(dy, dx)
            for dy in range(-hops, hops + 1)
            for dx in range(-hops, hops + 1)
            if max(abs(dy), abs(dx)) >= 1]
    offs.sort(key=lambda p: (max(abs(p[0]), abs(p[1])), p))
    return np.asarray(offs, np.int32)


U32 = 0xFFFFFFFF


def random_alloc_cell(cfg: EngineConfig, cell, arot):
    """The random allocator's splitmix-style hash of (cell, ``arot``) to
    a flat cell id, in uint32 arithmetic as the JAX engine computes it.
    torch has no general uint32 arithmetic: this computes in int64 and
    keeps the low 32 bits after every multiply and add (an int64 product
    of two 32-bit values may wrap, its low 32 bits stay right)."""
    x = (cell.long() & U32) * 0x9E3779B9 & U32
    x = (x + (arot.long() & U32) * 0x85EBCA6B) & U32
    x = x ^ (x >> 16)
    x = x * 0xC2B2AE35 & U32
    x = x ^ (x >> 13)
    return (x % cfg.n_cells).to(torch.int32)


def choose_alloc_cell(cfg: EngineConfig, rows, cols, arot):
    """Target-cell choice of ``cfg.allocator``; rows/cols/arot ``[H,W]``
    int32 -> ``[H,W]`` flat cell ids."""
    if cfg.allocator == "random":
        return random_alloc_cell(cfg, rows * cfg.width + cols, arot)
    offs = torch.as_tensor(vicinity_offsets(cfg.vicinity_hops),
                           device=arot.device)
    k = (arot % len(offs)).long()
    r = torch.clamp(rows + offs[k, 0], 0, cfg.height - 1)
    c = torch.clamp(cols + offs[k, 1], 0, cfg.width - 1)
    return r * cfg.width + c
