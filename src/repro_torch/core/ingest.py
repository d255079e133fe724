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


def io_stage(cfg: EngineConfig, st: MachineState, rows, cols):
    """One injection attempt per IO cell per cycle (vectorized on row 0)."""
    S, Q, IO = cfg.slots, cfg.queue_cap, cfg.io_cells
    dev = st.io_pos.device
    pend = st.io_pos < st.io_n                                  # [IO]
    cur = st.io_edges[torch.arange(IO, device=dev),
                      torch.clamp(st.io_pos, max=cfg.io_stream_cap - 1).long()]
    r0 = torch.zeros(IO, dtype=torch.int32, device=dev)
    c0 = torch.arange(IO, dtype=torch.int32, device=dev)
    # the insert goes to the source vertex's rhizome root k with the least
    # dist + pref * half_diam: pref = (k - io_pos) % R rotates a hub's
    # inserts over its roots, unless another root is more than half a
    # diameter closer; ties go to the lowest k (the canonical root at
    # rhizome_cap=1).  The edge's destination names its canonical root.
    R = cfg.rhizome_cap
    ks = torch.arange(R, dtype=torch.int32, device=dev)[None, :]
    cand = rhizome_addr(cfg, cur[:, 0:1], ks)                   # [IO, R]
    dist = manhattan_hops(cfg, cand // S, r0[:, None], c0[:, None])
    half_diam = max(1, (cfg.height + cfg.width - 2) // 2)
    pref = (ks - st.io_pos[:, None]) % R
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
        cfg, st.aq[0], st.aq_n[0], st.aq_head[0],
        st.ch[0], st.ch_n[0], st.ch_head[0], msg, tb,
        msg_lane(cfg, msg[..., 0], msg[..., 1]), pend,
        rings.ring_free(st.aq_n[0], Q, cfg.aq_reserve + cfg.sys_reserve))
    aq, aq_n, ch, ch_n = (st.aq.clone(), st.aq_n.clone(), st.ch.clone(),
                          st.ch_n.clone())
    aq[0], aq_n[0], ch[0], ch_n[0] = aq0, aqn0, ch0, chn0
    st = st._replace(aq=aq, aq_n=aq_n, ch=ch, ch_n=ch_n,
                     io_pos=st.io_pos + accepted.to(torch.int32))
    if cfg.telemetry:
        # IO cell i sits on row 0, column i
        tm = st.tm_cell.clone()
        tm[0, :, TM_IO] += accepted.to(torch.int32)
        st = st._replace(tm_cell=tm)
    return st
