"""FrontDesk -- tenant admission control and per-query latency accounting.

The port of ``repro/mq/frontdesk.py``.  Pending queries wait here and are
admitted into free :class:`MQSession` slots at increment boundaries,
gated on the ``tm_hiw`` action-queue hi-water plane (DESIGN §8/§9): when
the last increment drove any cell's queue to ``hiw_frac`` of the usable
depth (``queue_cap`` less the §4.2 reserves) or above, new tenants wait,
and each waiting request counts a deferral.  With telemetry off the gate
is open.  ``latency_report`` folds the retired tenants' receipts into
the ``obs.metrics`` percentile summary, in machine cycles.
"""
from __future__ import annotations

import collections
import dataclasses

import numpy as np

from repro_torch.core.state import TM_HW_AQ
from repro_torch.mq.session import MQSession
from repro_torch.obs import metrics


@dataclasses.dataclass
class QueryRequest:
    app: str
    source: int
    submitted_pos: int = 0       # the increment index at submission


class FrontDesk:
    """The admission queue in front of an :class:`MQSession`."""

    def __init__(self, session: MQSession, hiw_frac: float = 0.75):
        self.session = session
        self.hiw_frac = hiw_frac
        self.pending: "collections.deque[QueryRequest]" = collections.deque()
        self.receipts: "list[dict]" = []
        self.pos = 0                 # increments pumped
        self.deferrals = 0           # admissions the gate delayed

    def submit(self, app: str, source: int) -> QueryRequest:
        req = QueryRequest(app=app, source=source, submitted_pos=self.pos)
        self.pending.append(req)
        return req

    def admission_open(self) -> bool:
        """The tm_hiw gate: open while the last increment's worst
        action-queue hi-water mark stayed under ``hiw_frac`` of the
        usable depth."""
        cfg = self.session.eng.cfg
        if not cfg.telemetry:
            return True
        # the largest mark over the grid's cells (over each tile's owned
        # cells and the ranks, where sharded)
        hiw = int(self.session.eng._over_cells(
            "tm_hiw", lambda t: t[..., TM_HW_AQ].max(), "max"))
        ceiling = cfg.queue_cap - cfg.aq_reserve - cfg.sys_reserve
        return hiw < self.hiw_frac * ceiling

    def pump(self) -> "list[int]":
        """Admit pending tenants into free slots (at a boundary only);
        returns the slots admitted into."""
        admitted = []
        if self.pending and not self.admission_open():
            self.deferrals += len(self.pending)
            return admitted
        for _ in self.session.free_slots():
            if not self.pending:
                break
            req = self.pending.popleft()
            admitted.append(self.session.admit(req.app, req.source))
        return admitted

    def step(self, edges, **kw):
        """One serving beat: admit, stream one increment, retire the
        settled tenants into receipts (freeing their slots)."""
        self.pump()
        res = self.session.run_increment(edges, **kw)
        self.pos += 1
        for q in self.session.settled_slots():
            self.receipts.append(self.session.retire(q))
        return res

    def drain(self, max_increments: int = 64, **kw):
        """Run empty increments until every tenant has settled and nothing
        is pending (the end-of-stream flush)."""
        empty = np.zeros((0, 3), np.int32)
        for _ in range(max_increments):
            if not self.pending and not any(
                    s.state == "active" for s in self.session.slots):
                break
            self.step(empty, **kw)

    def latency_report(self) -> dict:
        """Percentile summary (``obs.metrics.summarize``) of per-query
        time to quiescence, in machine cycles."""
        lat = [r["latency_cycles"] for r in self.receipts
               if r["latency_cycles"] is not None]
        out = metrics.summarize(lat, unit="cycles")
        out["deferrals"] = self.deferrals
        out["served"] = len(self.receipts)
        return out
