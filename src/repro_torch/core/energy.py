"""Energy/time estimation (paper Table 2): the port's own copy of the
JAX package's host-side cost model (``repro/core/energy.py``).

The paper reuses the cost model of its ref [4] for a 590 mm^2, 1 GHz,
32x32-CC chip.  The exact constants aren't in the paper text; the
per-event constants are calibrated so that the 50K-vertex Edge-sampling
ingestion run (~1.02M inserted edges, ~22 us, 1355 uJ in Table 2) is
matched to within ~10% on the engine's event counts.  Energies and times
from it are the modelled chip's, not the GPU's that simulates it.
"""
from __future__ import annotations

import dataclasses

CLOCK_HZ = 1e9


@dataclasses.dataclass(frozen=True)
class EnergyModel:
    pj_per_hop: float = 40.0       # one message, one mesh link
    pj_per_action: float = 150.0   # action execute (one compute op)
    pj_per_alloc: float = 300.0    # ghost allocation (memory mgmt)
    pj_per_inject: float = 60.0    # IO cell -> CC transfer

    def estimate_uj(self, *, hops: int, execs: int, allocs: int,
                    injects: int) -> float:
        pj = (hops * self.pj_per_hop + execs * self.pj_per_action
              + allocs * self.pj_per_alloc + injects * self.pj_per_inject)
        return pj / 1e6

    @staticmethod
    def cycles_to_us(cycles: int) -> float:
        return cycles / CLOCK_HZ * 1e6


DEFAULT = EnergyModel()
