"""Action execution: the diffusive programming model's compute stage.

AM-CCA executes one operation per cell per cycle: either a computing
instruction (phase 0 of an action) or the staging of one new message
(``propagate``).  An action occupies its cell for ``1 + T`` cycles -- one
mutate cycle plus one per emission, with backpressure stalls when the
target buffer is full (paper §4; ``core/exec_stage.py`` of the JAX
package, whose handlers this file carries for ``qbatch=1``, with the
telemetry planes and the fault plan's seals; at ``lanes > 1`` a remote
emission that finds its lane full parks in the cell's park ring):

  OP_INSERT_EDGE  insert-edge-action with the ghost/future protocol
  OP_APP          the application action (bfs-action et al.)
  OP_ALLOC        remote ghost allocation (vicinity allocator)
  OP_SET_FUTURE   continuation return: set future, drain deferred queue
  OP_RHIZOME_FWD / OP_LINK_RHIZOME  the rhizome protocol's handlers
                  (reached only at rhizome_cap>1): a secondary root's
                  activation and deferred-insert drain, the canonical
                  root's link-ack and its sibling broadcast
  OP_REPAIR       (``cfg.faults`` only) the repair pass's relax: an
                  OP_APP that re-diffuses even when nothing changed

Every slot access is a gather or a one-hot ``where`` over the slot axis.
"""
from __future__ import annotations

import torch

from repro_torch.core import rings
from repro_torch.core.alloc import (choose_alloc_cell, rhizome_addr,
                                    rhizome_owner_vid)
from repro_torch.core.apps import DiffusionApp
from repro_torch.core.config import EngineConfig
from repro_torch.core.msg import (OP_ALLOC, OP_APP, OP_INSERT_EDGE,
                                  OP_LINK_RHIZOME, OP_REPAIR, OP_RHIZOME_FWD,
                                  OP_SET_FUTURE, TB_AQ_SELF, f2i, i2f,
                                  make_msg, msg_seal, seal_msg)
from repro_torch.core.routing import deliver, msg_lane, yx_target_buffer
from repro_torch.core.state import (G_NULL, G_PENDING, G_SET, TM_ALLOC,
                                    TM_BCAST, TM_EXEC, TM_PARK, TM_STAGE,
                                    TM_STALL, MachineState, tm_cell_add)


def _oh(idx, n, mask=None):
    """One-hot ``[..., n]`` selector; optionally masked."""
    oh = torch.arange(n, dtype=torch.int32, device=idx.device) == idx[..., None]
    if mask is not None:
        oh = oh & mask[..., None]
    return oh


def _expand(oh, arr):
    """Reshape a ``[H,W,S]`` selector to broadcast against ``arr``."""
    return oh.reshape(oh.shape + (1,) * (arr.ndim - oh.ndim))


def sel(arr, slot):
    """``arr[i, j, slot[i, j]]``: ``[H,W,S,...]`` -> ``[H,W,...]``."""
    idx = slot.long().reshape(slot.shape + (1,) * (arr.ndim - 2))
    idx = idx.expand(*slot.shape, 1, *arr.shape[3:])
    return torch.gather(arr, 2, idx).squeeze(2)


def put(arr, slot, val, mask):
    """``arr[i, j, slot[i, j]] = val`` where ``mask``; ``val`` is
    ``[H,W,...]`` or a scalar."""
    oh = _expand(_oh(slot, arr.shape[2], mask), arr)
    val = torch.as_tensor(val, dtype=arr.dtype, device=arr.device)
    if val.ndim >= 2 and val.shape[:2] == arr.shape[:2]:
        val = val.unsqueeze(2)
    return torch.where(oh, val, arr)


def _pick(*cases, default):
    """Nested ``where`` over messages: the first ``(mask, msg)`` whose
    mask holds wins, else ``default``."""
    out = default
    for mask, msg in reversed(cases):
        out = torch.where(mask[..., None], msg, out)
    return out


# --------------------------------------------------------------------------
# EXEC-A: staging -- the active action emits its next message (1 per cycle)
# --------------------------------------------------------------------------

def staging_stage(cfg: EngineConfig, app: DiffusionApp, st: MachineState,
                  rows, cols):
    W, S, E = cfg.width, cfg.slots, cfg.edge_cap
    active = st.cvalid & (st.cphase >= 1) & (st.cphase <= st.cT)

    op = st.cmsg[..., 0]
    dst = st.cmsg[..., 1]
    slot = dst % S
    k = st.cphase - 1                   # emission index
    cellid = rows * W + cols

    is_app = op == OP_APP
    if cfg.faults is not None:
        # an OP_REPAIR emits as OP_APP does; only its ghost forward keeps
        # the opcode, so the whole ghost chain re-diffuses its edges
        is_rp = op == OP_REPAIR
        is_app = is_app | is_rp
    is_sf = op == OP_SET_FUTURE
    is_rf = op == OP_RHIZOME_FWD
    is_appl = is_app | is_rf            # app-like: edge diffusion + forward

    # ---- OP_APP / OP_RHIZOME_FWD: (rf) deferred-insert drains, per-edge
    #      diffusion, (app) sibling broadcasts, then ghost forward ----
    kd = k - st.cdrain
    ne = sel(st.nedges, slot)
    ek = torch.clamp(kd, 0, E - 1)
    e_dst = sel(st.edst, slot).gather(-1, ek.long()[..., None])[..., 0]
    e_w = sel(st.ew, slot).gather(-1, ek.long()[..., None])[..., 0]
    app_edge_msg = make_msg(OP_APP, e_dst, f2i(app.edge_value(st.cemit, e_w)))
    gs = sel(st.gstate, slot)
    ga = sel(st.gaddr, slot)
    fwd_op = (OP_APP if cfg.faults is None
              else torch.where(is_rp, OP_REPAIR, OP_APP))
    app_fwd_msg = make_msg(fwd_op, ga, f2i(st.cemit))
    rss = sel(st.rstate, slot)
    n_bcast = torch.where(is_app & (slot < cfg.root_slots) & (rss == G_SET),
                          cfg.rhizome_cap - 1, 0)
    v_self = slot * cfg.n_cells + cellid
    sib = torch.clamp(kd - ne + 1, 1, max(cfg.rhizome_cap - 1, 1))
    bc_msg = make_msg(OP_RHIZOME_FWD, rhizome_addr(cfg, v_self, sib),
                      f2i(st.cemit))
    is_bcast = is_app & (kd >= ne) & (kd < ne + n_bcast)
    appl_is_fwd = is_appl & (kd >= ne + n_bcast) & (k >= st.cdrain)

    # ---- OP_SET_FUTURE: retarget the head of the future queue, then
    #      (last) the coalesced deferred app-forward, if any ----
    fqn_cur = sel(st.fq_n, slot)
    fqh_cur = sel(st.fq_head, slot)
    fq_e = rings.ring_peek(sel(st.fq, slot), fqh_cur)        # [H,W,3]
    sf_is_ins = fq_e[..., 0] == OP_INSERT_EDGE
    sf_fq_msg = torch.where(
        sf_is_ins[..., None],
        make_msg(OP_INSERT_EDGE, ga, fq_e[..., 1], fq_e[..., 2]),
        make_msg(OP_APP, ga, fq_e[..., 1]))
    sf_from_fq = is_sf & (fqn_cur > 0)
    sf_from_fwd = is_sf & (fqn_cur == 0)   # the coalesced forward
    fwd_here = sel(st.fwd_val, slot)
    sf_msg = torch.where(sf_from_fq[..., None], sf_fq_msg,
                         make_msg(OP_APP, ga, f2i(fwd_here)))

    # ---- rf activation drain: re-inject a deferred insert locally ----
    rf_drain = is_rf & (k < st.cdrain)
    drain_msg = make_msg(OP_INSERT_EDGE, dst, fq_e[..., 1], fq_e[..., 2])

    appl_msg = _pick((rf_drain, drain_msg), (appl_is_fwd, app_fwd_msg),
                     (is_bcast, bc_msg), default=app_edge_msg)
    emis = _pick((is_appl, appl_msg), (is_sf, sf_msg), default=st.cout)
    if cfg.faults is not None:
        # every message the compute stage emits passes here (phase 0's
        # cout too), so sealing here and at the IO cells covers the
        # network; park and hop copy the words as they are
        emis = seal_msg(emis)

    # ---- app ghost-forward onto a *pending* future: coalesce into the
    #      per-slot monotone forward register (never stalls) ----
    to_reg = active & appl_is_fwd & (gs == G_PENDING)
    ohreg = _oh(slot, S, to_reg)
    fwd_val = torch.where(ohreg, app.fwd_merge(st.fwd_val, st.cemit[..., None]),
                          st.fwd_val)
    fwd_pending = st.fwd_pending | ohreg

    tb = yx_target_buffer(cfg, emis[..., 1] // S, rows, cols)

    # ---- try to push (network or local queue); local delivery may use
    #      the reserved slots, so an action never self-deadlocks ----
    push_active = active & ~to_reg
    aq, aq_n, ch, ch_n, ok_push = deliver(
        cfg, st.aq, st.aq_n, st.aq_head, st.ch, st.ch_n, st.ch_head,
        emis, tb, msg_lane(cfg, emis[..., 0], emis[..., 1]), push_active,
        rings.ring_free(st.aq_n, cfg.queue_cap))
    ok_total = to_reg | ok_push         # register writes always succeed
    pk, pk_n = st.pk, st.pk_n
    parked = torch.zeros_like(ok_push)
    if cfg.lanes > 1:
        # transit parking: a remote emission whose lane is full goes into
        # the cell's park ring (drained by routing.park_stage), so the
        # cell keeps consuming; with the ring full the action stays active
        parked = (push_active & ~ok_push & (tb != TB_AQ_SELF)
                  & rings.ring_free(pk_n, cfg.park_capacity))
        pk, pk_n = rings.ring_push(pk, pk_n, st.pk_head, emis, parked)
        ok_total = ok_total | parked

    # ---- SET_FUTURE / rf-drain bookkeeping on successful stages ----
    fq_pop = ok_total & (sf_from_fq | rf_drain)
    n2, h2 = rings.ring_pop(fqn_cur, fqh_cur, cfg.futq_cap, fq_pop)
    fq_n = put(st.fq_n, slot, n2, fq_pop)
    fq_head = put(st.fq_head, slot, h2, fq_pop)
    sf_clear = ok_total & sf_from_fwd
    fwd_val = put(fwd_val, slot, app.fwd_neutral, sf_clear)
    fwd_pending = fwd_pending & ~_oh(slot, S, sf_clear)

    # ---- advance / retire ----
    new_phase = st.cphase + ok_total.to(torch.int32)
    done = active & ok_total & (new_phase > st.cT)
    stall = active & ~ok_total

    st = st._replace(
        aq=aq, aq_n=aq_n, ch=ch, ch_n=ch_n, pk=pk, pk_n=pk_n,
        fq_n=fq_n, fq_head=fq_head,
        fwd_val=fwd_val, fwd_pending=fwd_pending,
        cphase=new_phase, cvalid=st.cvalid & ~done,
        stat_exec=st.stat_exec + done.sum(dtype=torch.int32),
        # a parked emission counts as a stall too
        stat_stall=st.stat_stall + stall.sum(dtype=torch.int32)
        + parked.sum(dtype=torch.int32))
    if cfg.telemetry:
        # a park is no TM_STALL: sum(TM_STALL) + sum(TM_PARK) == stalls
        st = tm_cell_add(st, (TM_STAGE, active & ok_total),
                         (TM_STALL, stall), (TM_PARK, parked),
                         (TM_BCAST, push_active & ok_total & is_bcast))
    return st, active


# --------------------------------------------------------------------------
# EXEC-B: pop + phase 0 (the action's computing instruction)
# --------------------------------------------------------------------------

def phase0_stage(cfg: EngineConfig, app: DiffusionApp, st: MachineState,
                 rows, cols, busy_at_start):
    H, W, S, E = cfg.height, cfg.width, cfg.slots, cfg.edge_cap
    FQ, Q = cfg.futq_cap, cfg.queue_cap
    cellid = rows * W + cols

    has = ~busy_at_start & (st.aq_n > 0)
    m = rings.ring_peek(st.aq, st.aq_head)  # [H,W,MSG]
    op = torch.where(has, m[..., 0], 0)
    if cfg.faults is not None:
        # the seal check: an application message corrupted in transit is
        # popped as a counted no-op instead of relaxing a poisoned value
        from repro_torch.resilience.faults import FLT_CORRUPT, is_droppable
        bad = has & is_droppable(op) & (msg_seal(m) != m[..., 4])
        op = torch.where(bad, 0, op)
    dst, a0, a1 = m[..., 1], m[..., 2], m[..., 3]
    slot = dst % S

    vals_s = sel(st.vals, slot)             # [H,W,VN]
    ne = sel(st.nedges, slot)
    gs = sel(st.gstate, slot)
    fqn = sel(st.fq_n, slot)
    rs = sel(st.rstate, slot)
    on_s = sel(st.rhz_on, slot)

    is_ins = op == OP_INSERT_EDGE
    is_app = op == OP_APP
    is_alc = op == OP_ALLOC
    is_sf = op == OP_SET_FUTURE
    is_rf = op == OP_RHIZOME_FWD
    is_lr = op == OP_LINK_RHIZOME
    # the repair pass's relax: an OP_APP that forces its re-diffusion
    is_rp = (op == OP_REPAIR) if cfg.faults is not None else None

    # secondary rhizome slots start inactive; an insert reaching one
    # before its link-ack defers
    in_sec = (slot >= cfg.root_slots) & (slot < cfg.primary_slots)
    inactive = in_sec & ~on_s

    # ---------------- INSERT-EDGE paths (Listing 6) ----------------
    room = ne < E
    p_room = is_ins & ~inactive & room
    p_fwd = is_ins & ~inactive & ~room & (gs == G_SET)
    p_defer = is_ins & ~inactive & ~room & (gs == G_PENDING)
    p_null = is_ins & ~inactive & ~room & (gs == G_NULL)
    p_rlink = is_ins & inactive & (rs == G_NULL)
    p_rdef = is_ins & inactive & (rs == G_PENDING)

    # the only infeasible phase 0: a deferred insert with a full future
    # queue -- the head ROTATES to the queue tail instead of wedging it
    feasible = ~((p_defer | p_rlink | p_rdef) & (fqn >= FQ))
    pop = has & feasible
    rotate = has & ~feasible
    p_room, p_fwd, p_defer, p_null = (p_room & pop, p_fwd & pop,
                                      p_defer & pop, p_null & pop)
    p_rlink, p_rdef = p_rlink & pop, p_rdef & pop
    is_app, is_alc, is_sf, is_rf, is_lr = (
        is_app & pop, is_alc & pop, is_sf & pop, is_rf & pop, is_lr & pop)
    if is_rp is not None:
        is_rp = is_rp & pop

    # -- room: insert the edge into this RPVO node
    eidx = torch.clamp(ne, max=E - 1)
    ohSE = _oh(slot, S, p_room)[..., None] & _oh(eidx, E)[..., None, :]
    edst = torch.where(ohSE, a0[..., None, None], st.edst)
    ew = torch.where(ohSE, i2f(a1)[..., None, None], st.ew)
    nedges = st.nedges + _oh(slot, S, p_room).to(torch.int32)
    prop = app.propagate_on_insert(vals_s)
    ins_T = (p_room & prop).to(torch.int32)
    ins_out = make_msg(OP_APP, a0,
                       f2i(app.edge_value(vals_s[..., 0], i2f(a1))))

    # -- fwd: recursively propagate the insert to the ghost
    fwd_out = make_msg(OP_INSERT_EDGE, sel(st.gaddr, slot), a0, a1)

    # -- defer: enqueue the insert on the pending future (Fig. 4 step 3)
    push_mask = p_defer | p_null | p_rlink | p_rdef
    tailq = (sel(st.fq_head, slot) + fqn) % FQ
    ohq = _oh(slot, S, push_mask)[..., None] & _oh(tailq, FQ)[..., None, :]
    entry = torch.stack([torch.full_like(a0, OP_INSERT_EDGE), a0, a1], -1)
    fq = torch.where(ohq[..., None], entry[..., None, None, :], st.fq)
    fq_n = st.fq_n + _oh(slot, S, push_mask).to(torch.int32)

    # -- null: future -> pending, send allocate with continuation (Fig. 3)
    gstate = put(st.gstate, slot, G_PENDING, p_null)
    tgt_cell = choose_alloc_cell(cfg, rows, cols, st.arot)
    arot = st.arot + p_null.to(torch.int32)
    null_out = make_msg(OP_ALLOC, tgt_cell * S, dst, f2i(vals_s[..., 0]))

    # -- rlink: mark pending, request activation at the canonical root
    rstate = put(st.rstate, slot, G_PENDING, p_rlink)
    owner = rhizome_owner_vid(cfg, cellid, slot)
    owner_root = (owner % cfg.n_cells) * S + owner // cfg.n_cells
    rlink_out = make_msg(OP_LINK_RHIZOME, owner_root, cellid * S + slot)

    # ---------------- APP / RHIZOME-FWD relax (Listing 5) ----------------
    relaxing = is_app | is_rf
    app_like = is_app
    if is_rp is not None:
        relaxing = relaxing | is_rp
        app_like = is_app | is_rp
    new_vals, changed = app.relax(vals_s, i2f(a0))
    changed = changed & relaxing
    vals = put(st.vals, slot, new_vals, relaxing)
    n_bcast = torch.where(app_like & (slot < cfg.root_slots) & (rs == G_SET),
                          cfg.rhizome_cap - 1, 0)
    forced = changed if is_rp is None else changed | is_rp
    app_T = torch.where(forced, ne + n_bcast + (gs != G_NULL).to(torch.int32),
                        0)

    # -- rhizome-fwd extras: activate a pending sibling root and drain its
    #    deferred inserts back onto the local action queue
    rf_act = is_rf & in_sec & ~on_s
    rhz_on = st.rhz_on | _oh(slot, S, rf_act)
    rstate = put(rstate, slot, G_SET, rf_act)
    drain_n = torch.where(is_rf & (gs != G_PENDING) & (ne == 0), fqn, 0)
    rf_T = drain_n + torch.where(is_rf & changed,
                                 ne + (gs != G_NULL).to(torch.int32), 0)
    app_T = torch.where(is_rf, 0, app_T)

    # ---------------- LINK-RHIZOME (canonical-root handler) ----------
    rstate = put(rstate, slot, G_SET, is_lr)
    lr_out = make_msg(OP_RHIZOME_FWD, a0, f2i(vals_s[..., 0]))

    # ---------------- ALLOC (system action) ----------------
    alc_room = is_alc & (st.nfree < S)
    alc_full = is_alc & ~(st.nfree < S)
    g_new = st.nfree
    gseed = torch.full_like(vals_s, app.init_val)
    gseed[..., 0] = i2f(a1)
    vals = put(vals, g_new, gseed, alc_room)
    nedges = put(nedges, g_new, 0, alc_room)
    gaddr0 = put(st.gaddr, g_new, -1, alc_room)
    gstate = put(gstate, g_new, G_NULL, alc_room)
    fq_n = put(fq_n, g_new, 0, alc_room)
    fq_head = put(st.fq_head, g_new, 0, alc_room)
    fwd_val = put(st.fwd_val, g_new, app.fwd_neutral, alc_room)
    fwd_pending = st.fwd_pending & ~_oh(g_new, S, alc_room)
    new_addr = cellid * S + st.nfree
    nfree = st.nfree + alc_room.to(torch.int32)
    alc_ok_out = make_msg(OP_SET_FUTURE, a0, new_addr)
    alc_fwd_out = make_msg(OP_ALLOC, ((cellid + 1) % cfg.n_cells) * S, a0, a1)

    # ---------------- SET-FUTURE (continuation return) ----------
    gaddr = put(gaddr0, slot, a0, is_sf)
    gstate = put(gstate, slot, G_SET, is_sf)
    sf_T = torch.where(is_sf,
                       fqn + sel(st.fwd_pending, slot).to(torch.int32), 0)

    # ---------------- combine: T, cout, registers, queue pop --------------
    one_emit = p_fwd | p_null | p_rlink | alc_room | alc_full | is_lr
    T = (ins_T + one_emit.to(torch.int32) + app_T + sf_T + rf_T
         ).to(torch.int32)
    cout = _pick((p_room, ins_out), (p_fwd, fwd_out), (p_null, null_out),
                 (p_rlink, rlink_out), (is_lr, lr_out),
                 (alc_room, alc_ok_out), (alc_full, alc_fwd_out),
                 default=st.cout)

    # pop (feasible) or rotate-to-tail (infeasible): head always advances
    move = pop | rotate
    tail = (st.aq_head + st.aq_n) % Q
    ohT = _oh(tail, Q, rotate)
    aq = torch.where(ohT[..., None], m[..., None, :], st.aq)
    st = st._replace(
        vals=vals, nedges=nedges, edst=edst, ew=ew, gaddr=gaddr,
        gstate=gstate, rhz_on=rhz_on, rstate=rstate, nfree=nfree,
        fq=fq, fq_n=fq_n, fq_head=fq_head,
        fwd_val=fwd_val, fwd_pending=fwd_pending,
        aq=aq, aq_n=st.aq_n - pop.to(torch.int32),
        aq_head=(st.aq_head + move.to(torch.int32)) % Q, arot=arot,
        cmsg=torch.where(pop[..., None], m, st.cmsg),
        cvalid=st.cvalid | (pop & (T > 0)),
        cphase=torch.where(pop, 1, st.cphase),
        cT=torch.where(pop, T, st.cT),
        cemit=torch.where(relaxing, new_vals[..., 0], st.cemit),
        cout=cout,
        cdrain=torch.where(pop, torch.where(is_rf, drain_n, 0), st.cdrain),
        stat_exec=st.stat_exec + (pop & (T == 0)).sum(dtype=torch.int32),
        stat_allocs=st.stat_allocs + alc_room.sum(dtype=torch.int32),
        stat_stall=st.stat_stall + rotate.sum(dtype=torch.int32))
    if cfg.faults is not None:
        flt = st.flt.clone()
        flt[FLT_CORRUPT] += bad.sum(dtype=torch.int32)
        st = st._replace(flt=flt)
    if cfg.telemetry:
        st = tm_cell_add(st, (TM_EXEC, pop), (TM_ALLOC, alc_room),
                         (TM_STALL, rotate))
    return st, pop
