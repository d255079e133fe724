"""YX dimension-ordered routing on the cell mesh (paper §4) with
virtual-lane flow control on the physical links (DESIGN §7).

Messages take vertical (row) hops first, then horizontal; one hop per
cycle per link.  The hop stage is a masked ``torch.roll`` over the
``[H, W]`` grid, one direction at a time in the fixed order N, S, W, E,
so arrivals at one cell in one cycle are sequenced deterministically.
Each link multiplexes ``cfg.lanes`` virtual lanes: lane 0 is the escape
lane of protocol traffic, lanes ``1..lanes-1`` carry application traffic
hashed by destination (:func:`msg_lane`), and a round-robin arbiter
grants one admissible lane a link a cycle.  At ``lanes > 1``
:func:`park_stage` drains the per-cell park ring, where staging parks a
remote emission whose lane is full; at ``lanes=1`` every message rides
lane 0 and nothing parks.
"""
from __future__ import annotations

import torch

from repro_torch.core import rings
from repro_torch.core.config import EngineConfig
from repro_torch.core.msg import (DIR_E, DIR_N, DIR_S, DIR_W, N_DIRS,
                                  OP_ALLOC, OP_LINK_RHIZOME, OP_RHIZOME_FWD,
                                  OP_SET_FUTURE, TB_AQ_SELF, TB_CHAN_E,
                                  TB_CHAN_N, TB_CHAN_S, TB_CHAN_W)
from repro_torch.core.state import (TM_HOP, TM_L_BLOCK, TM_L_GRANT,
                                    TM_UNPARK, MachineState, tm_cell_add)


def is_protocol(op):
    """True where ``op`` is a system/continuation opcode: these get the
    deeper ``aq_reserve``-only admission bound at the action queue and
    the escape lane."""
    return ((op == OP_ALLOC) | (op == OP_SET_FUTURE)
            | (op == OP_LINK_RHIZOME) | (op == OP_RHIZOME_FWD))


def msg_lane(cfg: EngineConfig, op, dst):
    """Virtual-lane id of a message (all lane 0 at ``lanes=1``)."""
    shape = torch.broadcast_shapes(op.shape, dst.shape)
    if cfg.lanes == 1:
        return torch.zeros(shape, dtype=torch.int32, device=dst.device)
    data = 1 + dst % (cfg.lanes - 1)
    return torch.where(is_protocol(op), 0, data).to(torch.int32)


def manhattan_hops(cfg: EngineConfig, dst_cell, rows, cols):
    """YX path length from cell ``(rows, cols)`` to ``dst_cell``: the
    distance the IO cells weigh when they pick a rhizome root."""
    dr = dst_cell // cfg.width
    dc = dst_cell % cfg.width
    return (dr - rows).abs() + (dc - cols).abs()


def yx_target_buffer(cfg: EngineConfig, dst_cell, rows, cols):
    """Next-buffer code (``TB_*``) for a message at ``(rows, cols)``:
    N/S while the row differs, W/E while only the column differs,
    ``TB_AQ_SELF`` on arrival."""
    dr = dst_cell // cfg.width
    dc = dst_cell % cfg.width
    vert = torch.where(dr < rows, TB_CHAN_N, TB_CHAN_S)
    horiz = torch.where(dc < cols, TB_CHAN_W, TB_CHAN_E)
    out = torch.where(dr != rows, vert,
                      torch.where(dc != cols, horiz, TB_AQ_SELF))
    return out.to(torch.int32)


def deliver(cfg: EngineConfig, aq, aq_n, aq_head, ch, ch_n, ch_head,
            msg, tb, lane, want, aq_room):
    """Place ``msg`` into the local action queue (``tb == TB_AQ_SELF``,
    gated by the caller's ``aq_room`` predicate) or lane ``lane`` of one
    of the four outgoing channels (gated by ``lane_capacity``).

    Operands share arbitrary leading batch dims ``*B`` (the ``[H, W]``
    grid, or the ``[W]`` row-0 slice in the IO stage).  Returns
    ``(aq, aq_n, ch, ch_n, ok)``; where ``want & ~ok`` the message stays
    with the caller.
    """
    ok_aq = want & (tb == TB_AQ_SELF) & aq_room
    aq, aq_n = rings.ring_push(aq, aq_n, aq_head, msg, ok_aq)
    dev = msg.device
    # one push over all (direction, lane) rings: a message targets at
    # most one of them
    ok = ((want & (tb >= 0) & (tb < N_DIRS))[..., None, None]
          & (rings._iota(N_DIRS, dev)[:, None] == tb[..., None, None])
          & (rings._iota(cfg.lanes, dev) == lane[..., None, None])
          & rings.ring_free(ch_n, cfg.lane_capacity))           # [*B,4,L]
    ch, ch_n = rings.ring_push(ch, ch_n, ch_head, msg[..., None, None, :],
                               ok)
    return aq, aq_n, ch, ch_n, ok_aq | ok.any(dim=-1).any(dim=-1)


def park_stage(cfg: EngineConfig, st: MachineState, rows, cols):
    """Re-inject each cell's park-ring head into its YX next lane
    (``lanes > 1`` only; the caller skips it otherwise).  On failure the
    head rotates to the tail, so one blocked message cannot block the
    rest of the ring.  ``aq_room`` is False: a parked message is remote by
    construction and never enters the action queue."""
    PK = cfg.park_capacity
    head = rings.ring_peek(st.pk, st.pk_head)                  # [H,W,MSG]
    want = st.pk_n > 0
    tb = yx_target_buffer(cfg, head[..., 1] // cfg.slots, rows, cols)
    lane = msg_lane(cfg, head[..., 0], head[..., 1])
    aq, aq_n, ch, ch_n, ok = deliver(
        cfg, st.aq, st.aq_n, st.aq_head, st.ch, st.ch_n, st.ch_head,
        head, tb, lane, want, torch.zeros_like(want))
    # success: pop.  failure: rotate (head -> tail; the count is kept)
    fail = want & ~ok
    tail = (st.pk_head + st.pk_n) % PK
    oh = (rings._iota(PK, head.device) == tail[..., None]) & fail[..., None]
    pk = torch.where(oh[..., None], head[..., None, :], st.pk)
    st = st._replace(aq=aq, aq_n=aq_n, ch=ch, ch_n=ch_n, pk=pk,
                     pk_n=st.pk_n - ok.to(torch.int32),
                     pk_head=(st.pk_head + want.to(torch.int32)) % PK)
    if cfg.telemetry:
        st = tm_cell_add(st, (TM_UNPARK, ok))
    return st


# direction -> (row shift, col shift) that moves a message ALONG d.
_SHIFT = {DIR_N: (-1, 0), DIR_S: (1, 0), DIR_W: (0, -1), DIR_E: (0, 1)}


def shift_to_receiver(arr, d):
    """Align per-sender values ``[H, W, ...]`` with the receiving cell of
    a hop along direction ``d`` (a torus roll; the caller masks the
    wrapped edge with :func:`valid_receiver_mask`)."""
    dy, dx = _SHIFT[d]
    if dy:
        arr = torch.roll(arr, dy, dims=0)
    if dx:
        arr = torch.roll(arr, dx, dims=1)
    return arr


def shift_to_sender(arr, d):
    """Inverse of :func:`shift_to_receiver`."""
    dy, dx = _SHIFT[d]
    if dy:
        arr = torch.roll(arr, -dy, dims=0)
    if dx:
        arr = torch.roll(arr, -dx, dims=1)
    return arr


def valid_receiver_mask(cfg: EngineConfig, d, device):
    """``[H, W]`` bool: True where a receiver's direction-``d`` sender
    exists on the mesh (not a torus wrap of the roll)."""
    H, W = cfg.height, cfg.width
    r = torch.arange(H, device=device)[:, None]
    c = torch.arange(W, device=device)[None, :]
    m = {DIR_N: r < H - 1, DIR_S: r > 0, DIR_W: c < W - 1, DIR_E: c > 0}[d]
    return m.expand(H, W)


def _aq_room(cfg: EngineConfig, op, aq_n):
    """Hop/IO admission at the action queue: external pushes leave the
    local-emission reserve free, application traffic also the system
    headroom (DESIGN §4.2)."""
    Q = cfg.queue_cap
    return torch.where(is_protocol(op),
                       rings.ring_free(aq_n, Q, cfg.aq_reserve),
                       rings.ring_free(aq_n, Q, cfg.aq_reserve
                                       + cfg.sys_reserve))


def hop_stage(cfg: EngineConfig, st: MachineState, rows, cols):
    """One routing cycle: every link carries at most one message, the
    round-robin lane arbiter picks which.  Each direction round reads the
    receivers' queue counts as the earlier rounds of this cycle left
    them.  With telemetry each round adds, at the sender, a grant to the
    lane that popped its flit and a blocked cycle to every other lane
    occupied at the round's start, and at the receiver its accepted flit
    (``TM_HOP``).

    Fault injection (``cfg.faults``, DESIGN §9) lives in this stage:
    blackout windows mask a link's admissible lanes (a delay, counted in
    ``FLT_BLACKOUT``), and drop / duplicate / corrupt act on the granted
    flit, decided by ``fault_hash16`` of the cycle and the sender's link.
    A dropped flit is popped and never delivered, but counts as a link
    departure in ``hops``, so departures less deliveries (``TM_HOP``) is
    the drop count; a duplicated flit is delivered and kept by the
    sender; a corrupted flit has a bit of its value word flipped in the
    copy that travels, for the seal check at pop to catch.
    Returns ``(state, hops_this_cycle)``."""
    L, LC = cfg.lanes, cfg.lane_capacity
    dev = rows.device
    hops = torch.zeros((), dtype=torch.int32, device=dev)
    aq, aq_n, aq_head = st.aq, st.aq_n, st.aq_head
    ch, ch_n, ch_head = st.ch, st.ch_n, st.ch_head
    ch_rr = st.ch_rr
    if cfg.telemetry:
        st = st._replace(tm_lane=st.tm_lane.clone())
        arrived = torch.zeros_like(aq_n)
    liota = rings._iota(L, dev)
    plan = cfg.faults
    if plan is not None:
        from repro_torch.resilience.faults import (FLT_BLACKOUT, FLT_DROP,
                                                   FLT_DUP, fault_hash16,
                                                   is_droppable)
        flt = st.flt.clone()
        # the decision hashes of salts 1-3 (drop, dup, corrupt) for every
        # link of the cycle, [3, H, W, 4]; link id = cell * 4 + dir
        link = ((rows * cfg.width + cols) * N_DIRS)[..., None] \
            + rings._iota(N_DIRS, dev)
        hashes = fault_hash16(plan.seed, st.cycle, link,
                              rings._iota(3, dev)[:, None, None, None] + 1)

    for d in (DIR_N, DIR_S, DIR_W, DIR_E):
        valid = valid_receiver_mask(cfg, d, dev)
        heads = rings.ring_peek(ch[:, :, d], ch_head[:, :, d])  # [H,W,L,MSG]
        occ = ch_n[:, :, d] > 0                                 # [H,W,L]
        msg_r = shift_to_receiver(heads, d)
        occ_r = shift_to_receiver(occ, d) & valid[..., None]
        dst_cell = msg_r[..., 1] // cfg.slots                   # [H,W,L]
        tb = yx_target_buffer(cfg, dst_cell, rows[..., None], cols[..., None])
        adm = (tb == TB_AQ_SELF) & _aq_room(cfg, msg_r[..., 0],
                                            aq_n[..., None])
        for dd in range(N_DIRS):
            adm = adm | ((tb == dd) & rings.ring_free(ch_n[:, :, dd], LC))
        adm_s = shift_to_sender(occ_r & adm, d)                 # [H,W,L]
        if plan is not None:
            # a blackout window's link grants nothing; a link-cycle under
            # two windows counts once (the second sees adm_s masked)
            for (br, bc, bd, b0, bn) in plan.blackouts:
                if bd != d:
                    continue
                dead = torch.zeros((cfg.height, cfg.width), dtype=torch.bool,
                                   device=dev)
                dead[br, bc] = True
                dead &= (st.cycle >= b0) & (st.cycle < b0 + bn)
                flt[FLT_BLACKOUT] += (dead[..., None] & adm_s).sum(
                    dtype=torch.int32)
                adm_s = adm_s & ~dead[..., None]

        # round-robin grant: the admissible lane closest after ch_rr wins
        rr = ch_rr[:, :, d]
        pri = (liota - rr[..., None]) % L
        key = torch.where(adm_s, pri, L)
        kmin = key.min(dim=-1).values
        granted = adm_s.any(dim=-1)                             # [H,W]
        g = torch.where(
            granted,
            torch.where(key == kmin[..., None], liota, 0).sum(dim=-1),
            0).to(torch.int32)
        oh_g = liota == g[..., None]                            # [H,W,L]
        sel = torch.where(oh_g[..., None], heads, 0).sum(dim=2).to(torch.int32)

        # the fault decisions on the granted flit, in the sender's frame
        drop_s = dup_s = None
        if plan is not None:
            drp = is_droppable(sel[..., 0]) & granted           # [H,W]
            h1, h2, h3 = hashes[..., d]
            if plan.drop_thr:
                drop_s = drp & (h1 < plan.drop_thr)
            if plan.dup_thr:
                dup_s = drp & (h2 < plan.dup_thr)
            if plan.corrupt_thr:
                corr = drp & (h3 < plan.corrupt_thr)
                if drop_s is not None:
                    corr = corr & ~drop_s
                # flip one value-word bit of the copy that travels
                bit = (1 << (8 + (h3 & 7))).to(torch.int32)
                sel = sel.clone()
                sel[..., 2] = torch.where(corr, sel[..., 2] ^ bit,
                                          sel[..., 2])

        # deliver the granted head at the receiver (granted implies
        # admissible, so acceptance == grant, unless it was dropped)
        msg_g = shift_to_receiver(sel, d)
        want_r = shift_to_receiver(granted, d) & valid
        lane_g = shift_to_receiver(g, d)
        drop_r = (None if drop_s is None
                  else want_r & shift_to_receiver(drop_s, d))
        tb_g = yx_target_buffer(cfg, msg_g[..., 1] // cfg.slots, rows, cols)
        aq, aq_n, ch, ch_n, accepted_r = deliver(
            cfg, aq, aq_n, aq_head, ch, ch_n, ch_head, msg_g, tb_g, lane_g,
            want_r if drop_r is None else want_r & ~drop_r,
            _aq_room(cfg, msg_g[..., 0], aq_n))
        # a departure is a delivery or a drop on the link: hops counts
        # departures, TM_HOP deliveries
        departed_r = accepted_r if drop_r is None else accepted_r | drop_r
        popped_r = departed_r
        if dup_s is not None:
            dup_r = accepted_r & shift_to_receiver(dup_s, d)
            popped_r = departed_r & ~dup_r      # the sender keeps a dup
            flt[FLT_DUP] += dup_r.sum(dtype=torch.int32)
        if drop_r is not None:
            flt[FLT_DROP] += drop_r.sum(dtype=torch.int32)
        hops = hops + departed_r.sum(dtype=torch.int32)
        # pop the granted lane at the sender (after the push above: a
        # cell that forwards straight on pushes with the pre-pop count);
        # the pointer moves past the lane on every departure
        acc_s = shift_to_sender(popped_r, d)
        adv_s = shift_to_sender(departed_r, d)
        n2, h2 = rings.ring_pop(ch_n[:, :, d], ch_head[:, :, d], LC,
                                acc_s[..., None] & oh_g)
        ch_n = ch_n.clone()
        ch_head = ch_head.clone()
        ch_rr = ch_rr.clone()
        ch_n[:, :, d] = n2
        ch_head[:, :, d] = h2
        ch_rr[:, :, d] = torch.where(adv_s, (g + 1) % L, rr)
        if cfg.telemetry:
            won = oh_g & acc_s[..., None]                       # [H,W,L]
            st.tm_lane[:, :, d, :, TM_L_GRANT] += won.to(torch.int32)
            st.tm_lane[:, :, d, :, TM_L_BLOCK] += (occ & ~won).to(torch.int32)
            arrived += accepted_r.to(torch.int32)

    if cfg.telemetry:
        st = tm_cell_add(st, (TM_HOP, arrived))
    if plan is not None:
        st = st._replace(flt=flt)
    return st._replace(aq=aq, aq_n=aq_n, ch=ch, ch_n=ch_n, ch_head=ch_head,
                       ch_rr=ch_rr), hops
