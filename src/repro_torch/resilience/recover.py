"""Livelock recovery: boundary snapshots, config escalation, migration
(DESIGN §9), the port's copy of ``repro.resilience.recover``.

A livelock (DESIGN §4.2) is a sizing failure -- the workload's message
dependency depth exceeded the buffers -- so retrying the same config
wedges again, deterministically.  Recovery therefore escalates: restore
the increment-boundary state, re-run the increment under a relieved
config (more virtual lanes, then a deeper action queue), with
exponential backoff between attempts and each attempt, the flight
recorder's wedge report included, logged in
``StreamingEngine.recovery_log``.

Escalation changes ``lanes`` / ``queue_cap`` and so the shapes of the
channel, park and action-queue leaves: the boundary state cannot be
loaded as it is.  :func:`migrate_state` uses that a boundary is
quiescent (every queue, channel, park ring, future queue and active
register empty): only the durable storage leaves carry information, and
their shapes do not depend on lanes or queue_cap, so migration copies
them into a fresh ``init_state`` of the new config.  Both functions take
a whole state: a sharded engine gathers its boundary
(``dist.cca.gather_state``) and shards the migrated state again.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.state import MachineState, init_state

# Leaves that carry durable information at a quiescent boundary; every
# other leaf is empty there or a counter the increment restart resets.
# Their shapes depend only on the grid and slot geometry.
STORAGE_LEAVES = ("vals", "nedges", "edst", "ew", "gaddr", "gstate",
                  "rhz_on", "rstate", "nfree", "arot")
# the leaves whose sums say whether work is pending (assert_boundary)
PENDING_LEAVES = ("aq_n", "ch_n", "pk_n", "fq_n", "cvalid", "fwd_pending",
                  "io_n", "io_pos")


@dataclasses.dataclass(frozen=True)
class RecoveryPolicy:
    """Retry policy for ``run_increment(recover=...)``.

    Attempt ``k`` (1-based) re-runs the increment from the boundary
    snapshot under ``lanes = base + k * lanes_step`` and ``queue_cap =
    base + k * queue_cap_step``, after sleeping ``backoff_s * 2**(k-1)``
    seconds.  After ``max_attempts`` retries the original
    ``LivelockError`` is re-raised with the attempt log.
    """
    max_attempts: int = 3
    backoff_s: float = 0.0
    lanes_step: int = 1
    queue_cap_step: int = 0

    def escalate(self, base_cfg, k: int):
        """The attempt-``k`` relief config derived from ``base_cfg``."""
        kw = {}
        if self.lanes_step:
            kw["lanes"] = base_cfg.lanes + k * self.lanes_step
        if self.queue_cap_step:
            kw["queue_cap"] = base_cfg.queue_cap + k * self.queue_cap_step
        new = dataclasses.replace(base_cfg, **kw)
        new.validate()
        return new


def boundary_snapshot(st: MachineState) -> MachineState:
    """A copy, on ``st``'s device, of what :func:`assert_boundary` and
    :func:`migrate_state` read of ``st``: the storage and pending leaves
    and the cycle.  Its other leaves are ``st``'s own tensors, which the
    next increment goes on to update; neither function reads them (at a
    paper-scale config this leaves out the 768 MiB stream buffer)."""
    return st._replace(**{k: getattr(st, k).clone() for k in
                          STORAGE_LEAVES + PENDING_LEAVES + ("cycle",)})


def assert_boundary(st: MachineState) -> None:
    """Raise unless ``st`` is a quiescent increment boundary (the only
    state from which :func:`migrate_state` is sound).  The seven pending
    counts come back in one host transfer."""
    counts = torch.stack([
        st.aq_n.sum(dtype=torch.int64), st.ch_n.sum(dtype=torch.int64),
        st.pk_n.sum(dtype=torch.int64), st.fq_n.sum(dtype=torch.int64),
        st.cvalid.sum(dtype=torch.int64),
        st.fwd_pending.sum(dtype=torch.int64),
        (st.io_n.long() - st.io_pos.long()).sum()]).tolist()
    pending = dict(zip(("action queues", "channels", "park rings",
                        "future queues", "active actions",
                        "coalesced forwards", "io stream"), counts))
    busy = {k: v for k, v in pending.items() if v}
    if busy:
        raise ValueError(
            "recovery snapshot is not an increment boundary — migration "
            f"is only sound at quiescence (pending work: {busy})")


def migrate_state(new_cfg, app, snapshot: MachineState,
                  strict: bool = True) -> MachineState:
    """Carry a quiescent boundary ``snapshot`` into a fresh machine of
    ``new_cfg`` (typically an escalated lanes / queue_cap config), built
    on the snapshot's device.

    Copies only :data:`STORAGE_LEAVES` and the cycle; queues, channels and
    registers start empty (they were empty: quiescence) and the counters
    and planes start at zero, as the increment restart resets them.
    """
    if strict:
        assert_boundary(snapshot)
    fresh = init_state(new_cfg, init_vals=app.init_val,
                       fwd_init=app.fwd_neutral, device=snapshot.vals.device)
    moved = {}
    for name in STORAGE_LEAVES:
        src, dst = getattr(snapshot, name), getattr(fresh, name)
        if src.shape != dst.shape:
            raise ValueError(
                f"cannot migrate leaf '{name}': shape {tuple(src.shape)} -> "
                f"{tuple(dst.shape)}; escalation may only change lanes / "
                "queue_cap-class capacities, not the grid or slot layout")
        moved[name] = src.to(dst.dtype, copy=True)
    return fresh._replace(cycle=snapshot.cycle.to(torch.int32, copy=True),
                          **moved)
