"""Resilience of the port (DESIGN §9), the names of ``repro.resilience``:

* durable state -- ``StreamingEngine.checkpoint`` / ``restore`` route the
  ``MachineState``, the stream cursor and a config fingerprint through
  ``train.checkpoint.Checkpointer`` at increment boundaries
  (:mod:`repro_torch.resilience.checkpoint`);
* fault injection -- a seeded, static :class:`FaultPlan` applied inside
  ``cycle_body`` and the fault instances of both CUDA cycle kernels
  (drop / blackout / duplicate / corrupt), with message seals and the
  ``flt`` counter leaf (:mod:`repro_torch.resilience.faults`);
* detection and degradation -- the end-of-increment loss detector and
  the bounded ``OP_REPAIR`` pass of ``core.engine.StreamingEngine``;
  :class:`RecoveryPolicy` escalation on livelock with boundary-state
  migration (:mod:`repro_torch.resilience.recover`); ``tm_hiw``-gated
  ingest admission (``EngineConfig(ingest_guard=True)``).
"""
from repro_torch.resilience.checkpoint import (CKPT_KIND, config_fingerprint,
                                               stream_manifest)
from repro_torch.resilience.faults import (FLT_BLACKOUT, FLT_CORRUPT,
                                           FLT_DROP, FLT_DUP, N_FLT,
                                           FaultPlan, fault_hash16,
                                           is_droppable)
from repro_torch.resilience.recover import (STORAGE_LEAVES, RecoveryPolicy,
                                            assert_boundary,
                                            boundary_snapshot, migrate_state)

__all__ = [
    "CKPT_KIND", "FLT_BLACKOUT", "FLT_CORRUPT", "FLT_DROP", "FLT_DUP",
    "FaultPlan", "N_FLT", "RecoveryPolicy", "STORAGE_LEAVES",
    "assert_boundary", "boundary_snapshot", "config_fingerprint",
    "fault_hash16", "is_droppable", "migrate_state", "stream_manifest",
]
