"""Resilience of the port (DESIGN §9), the names of ``repro.resilience``
that it carries so far:

* fault injection -- a seeded, static :class:`FaultPlan` applied inside
  ``cycle_body`` and the fault instances of both CUDA cycle kernels
  (drop / blackout / duplicate / corrupt), with message seals and the
  ``flt`` counter leaf (:mod:`repro_torch.resilience.faults`);
* detection and repair -- the end-of-increment loss detector and the
  bounded ``OP_REPAIR`` pass of ``core.engine.StreamingEngine``.

Durable state (checkpoint / restore), the livelock recovery policy and
the ingest guard are not ported yet: ``run_increment(ckpt=, recover=)``
and ``EngineConfig(ingest_guard=True)`` raise ``NotImplementedError``.
"""
from repro_torch.resilience.faults import (FLT_BLACKOUT, FLT_CORRUPT,
                                           FLT_DROP, FLT_DUP, N_FLT,
                                           FaultPlan, fault_hash16,
                                           is_droppable)

__all__ = [
    "FLT_BLACKOUT", "FLT_CORRUPT", "FLT_DROP", "FLT_DUP", "FaultPlan",
    "N_FLT", "fault_hash16", "is_droppable",
]
