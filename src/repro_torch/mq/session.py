"""MQSession -- serve Q concurrent queries over one evolving graph.

The port of ``repro/mq/session.py``.  The session wraps a
:class:`StreamingEngine` built from a ``qbatch = Q`` composite app
(``mq.app.batch_app``) and adds the tenant lifecycle (DESIGN §10):

* **admit** a query into a free slot at an increment boundary: reset only
  that slot's value plane (and its ``qchg`` / ``qlast``) to its app's
  neutral element, the shared graph untouched, and push one qsel-masked
  ``OP_APP`` seed onto the action queue of the source's canonical root,
  on the state's device: one message, relaxing one tenant.  A
  label-flood query (CC) writes every vertex's label instead, and must be
  admitted before the first edge streams in.
* **track quiescence per query** from the ``qchg`` / ``qlast`` counters
  phase 0 accumulates: a slot whose count stayed zero over an increment
  has settled, and ``qlast`` is the cycle of its last change.
* **retire / recycle** a slot: read its values with the slot app's own
  combine, then free it for the next tenant.  Admitting another app
  rebuilds the composite, which here is a new table of slot codes for
  the next launch, not a new kernel.

Admission happens only at increment boundaries, where the machine is
quiescent, so a recycled slot never sees a payload of its previous
tenant.

On a sharded state (``ses.eng.state = dist.cca.shard_state(cfg,
ses.eng.state, mesh)``, JAX's ``device_put`` under
``cca_state_shardings``) the session writes and reads only what each tile
owns, through ``dist.cca``: a slot's planes on whole tiles, a seed pushed
in the tile that owns its cell, a label flood in the owned cells, and
the per-slot counters reduced over the ranks on the device.  Every host
decision (a slot's state, its settle cycle, a full queue) comes from
values reduced over the ranks, so every process decides alike.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.alloc import rhizome_rcs
from repro_torch.core.apps import APPS, DiffusionApp
from repro_torch.core.config import EngineConfig
from repro_torch.core.engine import StreamingEngine
from repro_torch.core.msg import MSG_WORDS, OP_APP
from repro_torch.core.state import root_addr
from repro_torch.dist import cca
from repro_torch.mq.app import batch_app

# the value a source vertex starts from, by app (BFS / SSSP distance 0,
# widest bottleneck +INF, reliable probability 1)
DEFAULT_SEEDS = {"bfs": 0.0, "sssp": 0.0, "widest": 1e9, "reliable": 1.0}

# label-flood apps: admission writes every vertex's label before the
# stream, no seed message
LABEL_APPS = ("cc",)


def label_seed(eng: StreamingEngine, val_idx: int = 0) -> None:
    """A label-flood admission: every vertex's value ``val_idx`` at every
    rhizome root becomes its own id (in the owning tiles, where
    sharded)."""
    cfg = eng.cfg
    vids = np.arange(cfg.n_vertices, dtype=np.int64)[None, :]
    ks = np.arange(cfg.rhizome_cap, dtype=np.int64)[:, None]
    r, c, s = rhizome_rcs(cfg, vids, ks)
    labels = np.broadcast_to(vids.astype(np.float32), r.shape)
    if eng._sharded:
        cca.write_cells(eng.state, "vals", r, c, (s, val_idx), labels)
        return
    dev = eng.state.vals.device
    idx = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in (r, c, s))
    eng.state.vals[idx + (val_idx,)] = torch.from_numpy(
        np.array(labels)).to(dev)


@dataclasses.dataclass
class QuerySlot:
    """One tenant: its app, source and the slot's generation."""
    app: DiffusionApp | None = None
    source: int = -1
    generation: int = 0
    state: str = "free"               # free | active | settled
    admit_cycle: int = 0
    settle_cycle: int | None = None   # qlast at the first quiet boundary
    increments: int = 0

    @property
    def latency_cycles(self) -> int | None:
        if self.settle_cycle is None:
            return None
        return self.settle_cycle - self.admit_cycle


class MQSession:
    """A Q-batched serving session over one :class:`StreamingEngine`.
    ``apps`` names the slots' apps at start (all BFS by default);
    ``device=None`` means the card."""

    def __init__(self, cfg: EngineConfig, qbatch: int,
                 apps: "list[str] | None" = None, device=None):
        names = list(apps) if apps else ["bfs"] * qbatch
        if len(names) != qbatch:
            raise ValueError(f"{len(names)} slot apps for qbatch={qbatch}")
        self.composite = batch_app(names)
        self.eng = StreamingEngine(cfg, self.composite, device=device)
        self.slots = [QuerySlot() for _ in range(qbatch)]
        self.edges_seen = 0

    @property
    def qbatch(self) -> int:
        return self.eng.cfg.qbatch

    @property
    def slot_apps(self) -> tuple:
        return (self.composite.slot_apps if self.composite.qbatch > 1
                else (self.composite,))

    # ---------------- admission ----------------

    def free_slots(self) -> "list[int]":
        return [q for q, s in enumerate(self.slots) if s.state == "free"]

    def admit(self, app: str | DiffusionApp, source: int,
              slot: int | None = None, seed: float | None = None) -> int:
        """Admit a query into a free slot (the first free one by default)
        and return the slot.  A label-flood app only before the first
        edge streams in."""
        a = APPS[app] if isinstance(app, str) else app
        if slot is None:
            free = self.free_slots()
            if not free:
                raise RuntimeError("no free query slot (retire one first)")
            slot = free[0]
        s = self.slots[slot]
        if s.state != "free":
            raise ValueError(f"slot {slot} is {s.state}")
        if a.name in LABEL_APPS and self.edges_seen:
            raise ValueError(
                f"label-flood app {a.name!r} must be admitted before the "
                "stream starts (existing edges never re-trigger)")
        if self.slot_apps[slot].name != a.name:
            self._rebuild(slot, a)
        self._reset_slot_plane(slot)
        cycle = int(self._cycle())
        if a.name in LABEL_APPS:
            self._write_labels(slot)
        else:
            self._inject_seed(
                slot, source,
                DEFAULT_SEEDS[a.name] if seed is None else seed)
        self.slots[slot] = QuerySlot(app=a, source=source,
                                     generation=s.generation + 1,
                                     state="active", admit_cycle=cycle)
        return slot

    def _rebuild(self, slot: int, a: DiffusionApp):
        names = [sa.name for sa in self.slot_apps]
        names[slot] = a.name
        self.composite = batch_app(names)
        # n_vals and qbatch are unchanged, so the state fits as it is; the
        # next launch takes the new table of slot codes
        self.eng.app = self.composite

    def _cycle(self) -> torch.Tensor:
        """The machine's cycle (every tile's, where sharded)."""
        st = self.eng.state
        return st.tiles[0].cycle if self.eng._sharded else st.cycle

    def _slot_value(self, field: str, q: int) -> float:
        v = getattr(self.composite, field)
        return float(np.float32(v[q] if self.composite.qbatch > 1 else v))

    def _reset_slot_plane(self, slot: int):
        """Reset slot ``slot``'s value plane to its app's neutral element;
        the graph (edges, ghosts, rhizomes) is untouched."""
        st, q = self.eng.state, slot
        init = self._slot_value("init_val", q)
        neutral = self._slot_value("fwd_neutral", q)
        if self.eng._sharded:
            cca.write_plane(st, "vals", 0 if self.qbatch == 1 else q, init)
            cca.write_plane(st, "fwd_val", ... if self.qbatch == 1 else q,
                            neutral)
            if self.qbatch > 1:
                cca.reset_slot(st, q)
            return
        with torch.no_grad():
            if self.qbatch == 1:
                st.vals[..., 0] = init
                st.fwd_val[...] = neutral
            else:
                st.vals[..., q] = init
                st.fwd_val[..., q] = neutral
                st.qchg[q] = 0
                st.qlast[q] = st.cycle

    def _write_labels(self, slot: int):
        """CC-style admission: every vertex becomes its own source."""
        label_seed(self.eng, slot if self.qbatch > 1 else 0)

    def _inject_seed(self, slot: int, source: int, seed: float):
        """Push one qsel-masked OP_APP onto the action queue of the
        source's canonical-root cell (the boundary is quiescent, so the
        queue has room and nothing in flight can overtake it)."""
        cfg, st = self.eng.cfg, self.eng.state
        addr = int(root_addr(cfg, source))
        cell = addr // cfg.slots
        r, c = cell // cfg.width, cell % cfg.width
        m = np.zeros(cfg.msg_words, np.int32)
        m[0], m[1] = OP_APP, addr
        if self.qbatch == 1:
            m[2] = np.float32(seed).view(np.int32)
        else:
            payload = np.asarray(self.composite.init_val, np.float32).copy()
            payload[slot] = seed
            bits = payload.view(np.int32)
            m[2] = bits[0]
            m[MSG_WORDS:] = bits[1:]
            m[3] = np.int32(np.uint32(1 << slot))   # qsel: this tenant only
        if self.eng._sharded:
            cca.push_action(st, r, c, m, cfg.queue_cap)
            return
        n, head = (int(x) for x in torch.stack(
            [st.aq_n[r, c], st.aq_head[r, c]]).tolist())
        if n >= cfg.queue_cap:
            raise RuntimeError(f"action queue of cell ({r}, {c}) full at an "
                               "increment boundary")
        st.aq[r, c, (head + n) % cfg.queue_cap] = torch.from_numpy(m).to(
            st.aq.device)
        st.aq_n[r, c] = n + 1

    # ---------------- streaming ----------------

    def run_increment(self, edges, **kw):
        """Ingest one edge increment, run to quiescence, then fold the
        per-slot relax counters into each tenant's lifecycle."""
        edges = np.asarray(edges, np.int32).reshape(-1, 3)
        res = self.eng.run_increment(edges, **kw)
        self.edges_seen += len(edges)
        st, Q = self.eng.state, self.eng.cfg.qbatch
        if self.eng._sharded:
            rec = cca.slot_counters(st).tolist()
            qchg, qlast, end_cycle = rec[:Q], rec[Q:2 * Q], rec[-1]
        else:
            qchg, qlast = st.qchg.tolist(), st.qlast.tolist()
            end_cycle = int(st.cycle)
        for q, s in enumerate(self.slots):
            if s.state == "free":
                continue
            s.increments += 1
            if self.qbatch == 1:
                # no per-slot counters at qbatch == 1: global quiescence is
                # the query's, the boundary a conservative settle point
                changed = 1 if len(edges) else 0
                last = end_cycle
            else:
                changed, last = qchg[q], qlast[q]
            if s.state == "active" and changed == 0:
                s.state = "settled"
                s.settle_cycle = last
            elif s.state == "settled" and changed > 0:
                # the evolving graph re-activated a settled tenant; its
                # first-settle latency stays recorded
                s.state = "active"
        return res

    # ---------------- readback / retirement ----------------

    def values(self, slot: int, n: int | None = None) -> np.ndarray:
        """The slot's values, combined over rhizome roots with the slot
        app's own combine (min, or max for the max-monotone apps)."""
        return self.eng.values(n, val_idx=slot if self.qbatch > 1 else 0,
                               combine=self.slot_apps[slot].combine)

    def settled_slots(self) -> "list[int]":
        return [q for q, s in enumerate(self.slots) if s.state == "settled"]

    def retire(self, slot: int, collect_values: bool = False) -> dict:
        """Free a slot for recycling; returns the tenant's receipt."""
        s = self.slots[slot]
        if s.state == "free":
            raise ValueError(f"slot {slot} already free")
        receipt = dict(slot=slot, app=s.app.name, source=s.source,
                       generation=s.generation,
                       admit_cycle=s.admit_cycle,
                       settle_cycle=s.settle_cycle,
                       latency_cycles=s.latency_cycles,
                       increments=s.increments)
        if collect_values:
            receipt["values"] = self.values(slot)
        self.slots[slot] = QuerySlot(generation=s.generation)
        return receipt
