"""Plain PyTorch version of one cycle-kernel launch.

``frozen_cycles`` runs up to ``n_cycles`` engine cycles
(``core.engine.cycle_body``) and freezes at quiescence, so a launch never
overshoots the quiescent state and the final ``cycle`` counter is the
exact quiescence cycle (``repro/kernels/cca_cycle/ref.py``).  Stopping at
the first quiescent cycle is the same as running the frozen identity
cycles.  The CPU tests run it, and ``chip_smoke.py`` holds the CUDA
kernel against it on the card.
"""
from __future__ import annotations

import torch

from repro_torch.core.apps import DiffusionApp
from repro_torch.core.config import EngineConfig
from repro_torch.core.engine import cycle_body, quiescent
from repro_torch.core.state import MachineState


def frozen_cycles(cfg: EngineConfig, app: DiffusionApp, st: MachineState,
                  n_cycles: int):
    """Returns ``(state, quiescent_at_end, cycles_run)``."""
    ran = 0
    while ran < n_cycles and not bool(quiescent(st)):
        st, _ = cycle_body(cfg, app, st)
        ran += 1
    return st, bool(quiescent(st)), ran


def cca_cycle_chunk_ref(cfg: EngineConfig, app: DiffusionApp,
                        st: MachineState, n_cycles: int | None = None):
    """Same return convention as ``ops.cca_cycle_chunk``: ``(state,
    int32 [quiescent, cycles_run])``; the input state is not modified."""
    n_cycles = cfg.chunk if n_cycles is None else n_cycles
    st, q, ran = frozen_cycles(cfg, app, st, n_cycles)
    return st, torch.tensor([int(q), ran], dtype=torch.int32,
                            device=st.aq.device)
