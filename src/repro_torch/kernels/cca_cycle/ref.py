"""Plain PyTorch version of one cycle-kernel launch.

``frozen_cycles`` runs up to ``n_cycles`` engine cycles
(``core.engine.cycle_body``) and freezes at quiescence, so a launch never
overshoots the quiescent state and the final ``cycle`` counter is the
exact quiescence cycle (``repro/kernels/cca_cycle/ref.py``).  Stopping at
the first quiescent cycle is the same as running the frozen identity
cycles.  With ``trace=True`` it also returns the ``(active, in_flight)``
row of each cycle it ran (``core.engine.cycle_step``'s stats), the rows
the kernel's traced launch fills.  The CPU tests run it, and
``chip_smoke.py`` holds the CUDA kernel against it on the card.
"""
from __future__ import annotations

import torch

from repro_torch.core.apps import DiffusionApp
from repro_torch.core.config import EngineConfig
from repro_torch.core.engine import cycle_body, cycle_step, quiescent
from repro_torch.core.state import MachineState, owned


def frozen_cycles(cfg: EngineConfig, app: DiffusionApp, st: MachineState,
                  n_cycles: int, trace: bool = False):
    """Returns ``(state, quiescent_at_end, cycles_run)``, and with
    ``trace`` the int32 ``[cycles_run, 2]`` rows ``(active, in_flight)``
    as a fourth item."""
    ran, rows = 0, []
    while ran < n_cycles and not bool(quiescent(st)):
        if trace:
            st, stats = cycle_step(cfg, app, st)
            rows.append(torch.stack([stats.active, stats.in_flight]))
        else:
            st, _ = cycle_body(cfg, app, st)
        ran += 1
    if not trace:
        return st, bool(quiescent(st)), ran
    rows = torch.stack(rows) if rows else torch.zeros(
        (0, 2), dtype=torch.int32, device=st.aq.device)
    return st, bool(quiescent(st)), ran, rows


def cca_cycle_chunk_ref(cfg: EngineConfig, app: DiffusionApp,
                        st: MachineState, n_cycles: int | None = None,
                        trace: torch.Tensor | None = None):
    """Same return convention as ``ops.cca_cycle_chunk``: ``(state,
    int32 [quiescent, cycles_run])``; the input state is not modified.
    ``trace`` (int32 ``[>= n_cycles, 2]``) gets rows ``0 .. cycles_run -
    1``."""
    n_cycles = cfg.chunk if n_cycles is None else n_cycles
    # no autograd bookkeeping in the thousands of tiny ops a cycle; the
    # leaves the cycles made are cloned out as ordinary tensors, which
    # callers may update in place
    with torch.inference_mode():
        if trace is None:
            st, q, ran = frozen_cycles(cfg, app, st, n_cycles)
        else:
            st, q, ran, rows = frozen_cycles(cfg, app, st, n_cycles, True)
    if trace is not None:
        trace[:ran] = rows
    st = st._replace(**{k: v.clone() for k, v in st._asdict().items()
                        if v.is_inference()})
    return st, torch.tensor([int(q), ran], dtype=torch.int32,
                            device=st.aq.device)


def tile_step_ref(cfg: EngineConfig, app: DiffusionApp, st: MachineState,
                  tile, gquiet: torch.Tensor, rec: torch.Tensor,
                  trace: torch.Tensor | None = None):
    """The plain version of one tile step (``ops.cca_tile_step``): a
    ``cycle_body`` of the tile (``core.state.Tile``) unless the grid was
    quiescent at entry (``gquiet``; a tile quiescent alone does not
    freeze), then the record, the tile's cycle and counters, the
    quiescence of its owned cells after the cycle and the cycles run, into
    ``rec``, and given ``trace`` (int32 ``[1, 2]``) the cycle's ``(active,
    in_flight)`` counts of its owned cells (zeros for a frozen step).
    Returns the new state."""
    frozen = bool(gquiet)
    row = torch.zeros(2, dtype=torch.int32)
    with torch.inference_mode():
        if not frozen:
            st, (active_a, popped, _) = cycle_body(cfg, app, st, tile)
            if trace is not None:
                own = tile.own_mask(*st.aq_n.shape, st.aq_n.device)
                flight = st.ch_n.sum(dim=(2, 3)) + st.pk_n
                row = torch.stack([
                    owned(active_a | popped, own).sum(dtype=torch.int32),
                    flight[own].sum(dtype=torch.int32)])
        q = frozen or bool(quiescent(st, tile))
    st = st._replace(**{k: v.clone() for k, v in st._asdict().items()
                        if v.is_inference()})
    rec.copy_(torch.stack([st.cycle, st.stat_hops, st.stat_exec,
                           st.stat_stall, st.stat_allocs,
                           torch.tensor(int(q)), torch.tensor(int(not frozen)),
                           torch.tensor(0)]).to(rec))
    if trace is not None:
        trace[0] = row
    return st
