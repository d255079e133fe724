"""Core: the paper's message-driven streaming dynamic graph engine."""
from repro_torch.core.apps import (APPS, BFS, CC, INGEST_ONLY, SSSP,
                                   DiffusionApp)
from repro_torch.core.config import EngineConfig
from repro_torch.core.engine import (LIVELOCK_CHUNKS, CycleStats,
                                     IncrementResult, LivelockError,
                                     StreamingEngine, cycle_body,
                                     cycle_step, quiescent)
from repro_torch.core.state import (MachineState, init_state, root_addr,
                                    state_from_numpy, state_to_numpy)

__all__ = [
    "APPS", "BFS", "CC", "INGEST_ONLY", "SSSP", "DiffusionApp",
    "EngineConfig", "CycleStats", "IncrementResult", "LIVELOCK_CHUNKS",
    "LivelockError", "StreamingEngine", "MachineState", "cycle_body",
    "cycle_step", "quiescent", "init_state", "root_addr",
    "state_from_numpy", "state_to_numpy",
]
