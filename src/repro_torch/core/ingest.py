"""Streaming edge ingestion via IO cells (paper §2, §4 "Graph Construction").

One IO cell per chip column, attached to the row-0 cell of its column.
Every cycle each IO cell reads the next edge of its residual stream,
creates the ``insert-edge-action`` and sends it into the fabric at its
cell (action queue if the source vertex lives there, else the YX
channel).  Backpressure stalls the IO cell: it retries the same edge next
cycle.  With ``cfg.faults`` the IO cells seal what they inject, and a
row with a negative dst is the repair pass's ``OP_REPAIR`` (DESIGN §9).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import rings
from repro_torch.core.alloc import rhizome_addr
from repro_torch.core.config import EngineConfig
from repro_torch.core.msg import (OP_INSERT_EDGE, OP_REPAIR, make_msg,
                                  pad_msg, seal_msg)
from repro_torch.core.routing import (deliver, manhattan_hops, msg_lane,
                                     yx_target_buffer)
from repro_torch.core.state import TM_IO, MachineState, root_addr


def load_stream(cfg: EngineConfig, st: MachineState, edges: np.ndarray,
                limit: int | None = None):
    """Distribute an increment's edges round-robin over the IO cells:
    edge ``k`` goes to IO cell ``k % IO``, after any unconsumed residue of
    an earlier load.

    ``edges`` is int32 ``[m, 3]`` rows of (src vid, dst vid, weight
    bits).  Edges beyond an IO cell's ``io_stream_cap``, and edges past
    ``limit`` new admissions, are returned as the spill (in arrival
    order) for a later pass.  Returns ``(state, spill)``.

    ``io_edges`` is updated in place on its device: only the residue
    move, the new edges and the zeroing of the rows the old load left
    behind touch it -- never a copy of the whole buffer -- and the result
    equals the JAX engine's freshly zeroed buffer.
    """
    IO, L = cfg.io_cells, cfg.io_stream_cap
    io_n = st.io_n.cpu().numpy().astype(np.int64)
    io_pos = st.io_pos.cpu().numpy().astype(np.int64)
    rem = io_n - io_pos
    edges = np.asarray(edges, np.int32).reshape(-1, 3)
    k = np.arange(len(edges))
    io_of = k % IO
    pos = rem[io_of] + k // IO
    placed = pos < L
    if limit is not None:
        placed &= np.cumsum(placed) <= limit
    new_n = rem + np.bincount(io_of[placed], minlength=IO)

    buf = st.io_edges
    for i in np.nonzero((rem > 0) & (io_pos > 0))[0]:
        buf[i, :rem[i]] = buf[i, io_pos[i]:io_n[i]].clone()
    for i in np.nonzero(io_n > new_n)[0]:
        buf[i, new_n[i]:io_n[i]] = 0
    if placed.any():
        dev = buf.device
        buf[torch.from_numpy(io_of[placed]).to(dev),
            torch.from_numpy(pos[placed]).to(dev)] = \
            torch.from_numpy(edges[placed]).to(dev)
    st = st._replace(
        io_n=torch.from_numpy(new_n.astype(np.int32)).to(buf.device),
        io_pos=torch.zeros_like(st.io_pos))
    return st, edges[~placed]


def _io_cells(IO: int, tile, dev):
    """The IO cells a stage serves: their IO indices (= their global
    columns) and their row and columns in the state's arrays -- all of row
    0 without a tile; on a tile (``core.state.Tile``) the IO cells it owns,
    ``None`` if it owns none."""
    if tile is None:
        io = torch.arange(IO, device=dev)
        return io, 0, io
    row = -tile.r0
    g0, g1 = max(tile.c0 + tile.oc0, 0), min(tile.c0 + tile.oc1, IO)
    if not tile.or0 <= row < tile.or1 or g0 >= g1:
        return None
    io = torch.arange(g0, g1, device=dev)
    return io, row, io - tile.c0


def io_stage(cfg: EngineConfig, st: MachineState, rows, cols, tile=None):
    """One injection attempt per IO cell per cycle (vectorized on row 0;
    on a ``tile``, over the IO cells it owns)."""
    S, Q = cfg.slots, cfg.queue_cap
    dev = st.io_pos.device
    cells = _io_cells(cfg.io_cells, tile, dev)
    if cells is None:
        return st
    io, row, lc = cells
    n = io.numel()
    io_pos = st.io_pos[io]
    pend = io_pos < st.io_n[io]                                 # [n]
    cur = st.io_edges[io, torch.clamp(io_pos,
                                      max=cfg.io_stream_cap - 1).long()]
    r0 = torch.zeros(n, dtype=torch.int32, device=dev)
    c0 = io.to(torch.int32)
    # the insert goes to the source vertex's rhizome root k with the least
    # dist + pref * half_diam: pref = (k - io_pos) % R rotates a hub's
    # inserts over its roots, unless another root is more than half a
    # diameter closer; ties go to the lowest k (the canonical root at
    # rhizome_cap=1).  The edge's destination names its canonical root.
    R = cfg.rhizome_cap
    ks = torch.arange(R, dtype=torch.int32, device=dev)[None, :]
    cand = rhizome_addr(cfg, cur[:, 0:1], ks)                   # [n, R]
    dist = manhattan_hops(cfg, cand // S, r0[:, None], c0[:, None])
    half_diam = max(1, (cfg.height + cfg.width - 2) // 2)
    pref = (ks - io_pos[:, None]) % R
    best = torch.argmin(dist + pref * half_diam, dim=1)  # first minimum
    tgt = cand.gather(1, best[:, None])[:, 0]
    msg = make_msg(OP_INSERT_EDGE, tgt, root_addr(cfg, cur[:, 1]), cur[:, 2])
    if cfg.qbatch > 1:
        # an insert's payload is (dst, weight): the extension words of a
        # query-batched record are dead here
        msg = pad_msg(msg, cfg.msg_words)
    if cfg.faults is not None:
        # a repair sentinel row (vid, -(k+1), value bits) is no edge: it
        # re-injects vid's durable value at its rhizome root k as an
        # OP_REPAIR, through the same admission and backpressure
        rp = cur[:, 1] < 0
        rp_tgt = rhizome_addr(cfg, cur[:, 0], -cur[:, 1] - 1)
        tgt = torch.where(rp, rp_tgt, tgt)
        msg = torch.where(rp[:, None], make_msg(OP_REPAIR, rp_tgt, cur[:, 2]),
                          msg)
        msg = seal_msg(msg)
    tb = yx_target_buffer(cfg, tgt // S, r0, c0)
    # injected inserts are application traffic: the app-level AQ reserve
    aq0, aqn0, ch0, chn0, accepted = deliver(
        cfg, st.aq[row, lc], st.aq_n[row, lc], st.aq_head[row, lc],
        st.ch[row, lc], st.ch_n[row, lc], st.ch_head[row, lc], msg, tb,
        msg_lane(cfg, msg[..., 0], msg[..., 1]), pend,
        rings.ring_free(st.aq_n[row, lc], Q, cfg.aq_reserve + cfg.sys_reserve))
    aq, aq_n, ch, ch_n, pos = (st.aq.clone(), st.aq_n.clone(), st.ch.clone(),
                               st.ch_n.clone(), st.io_pos.clone())
    aq[row, lc], aq_n[row, lc], ch[row, lc], ch_n[row, lc] = \
        aq0, aqn0, ch0, chn0
    pos[io] = io_pos + accepted.to(torch.int32)
    st = st._replace(aq=aq, aq_n=aq_n, ch=ch, ch_n=ch_n, io_pos=pos)
    if cfg.telemetry:
        # IO cell i sits on row 0, column i
        tm = st.tm_cell.clone()
        tm[row, lc, TM_IO] += accepted.to(torch.int32)
        st = st._replace(tm_cell=tm)
    return st
