"""Core: the paper's message-driven streaming dynamic graph engine."""
from repro_torch.core.apps import APPS, BFS, CC, SSSP, DiffusionApp
from repro_torch.core.config import EngineConfig
from repro_torch.core.engine import (LIVELOCK_CHUNKS, IncrementResult,
                                     LivelockError, StreamingEngine,
                                     cycle_body, quiescent)
from repro_torch.core.state import (MachineState, init_state, root_addr,
                                    state_from_numpy, state_to_numpy)

__all__ = [
    "APPS", "BFS", "CC", "SSSP", "DiffusionApp", "EngineConfig",
    "IncrementResult", "LIVELOCK_CHUNKS", "LivelockError", "StreamingEngine",
    "MachineState", "cycle_body", "quiescent", "init_state", "root_addr",
    "state_from_numpy", "state_to_numpy",
]
