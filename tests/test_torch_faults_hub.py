"""The 8x8 hub stream of the JAX package's ``tests/test_resilience.py``
(lanes=2, telemetry on) under its plans, chunk by chunk against the JAX
engine on the CPU, with the helpers of ``tests/test_torch_faults_chunks.py``:
every leaf after every chunk of the faulty run and of the repair pass.
This file: drop, dup and corrupt together, and ``widest`` at
``rhizome_cap=2`` under drop.  ``..._hub2.py``: two blackouts, dups alone.
``..._hub3.py``: drop and corrupt over three increments.
"""
from repro_torch.launch.paper_experiments import hub_stream
from repro_torch.resilience import (FLT_BLACKOUT, FLT_CORRUPT, FLT_DROP,
                                    FLT_DUP)

from test_torch_faults_chunks import (one_torch_thread,  # noqa: F401
                                      run_stream, weighted_increments)

KW = dict(height=8, width=8, n_vertices=256, edge_cap=8, ghost_slots=24,
          queue_cap=32, chan_cap=16, chunk=64, lanes=2, max_cycles=200_000,
          telemetry=True)                 # tests/test_resilience.py::_cfg


def test_hub_drop_dup_corrupt_chunk_by_chunk():
    p, (flt,), rows = run_stream(KW, dict(seed=7, drop_rate=0.05,
                                          dup_rate=0.03, corrupt_rate=0.02),
                                 [hub_stream()])
    assert flt[FLT_DROP] and flt[FLT_DUP] and flt[FLT_CORRUPT] and rows


def test_widest_rhizome_cap2_drop_chunk_by_chunk():
    """A max-monotone repair: ``widest`` combines its roots with max and
    skips its own neutral 0."""
    kw = dict(height=8, width=8, n_vertices=64, edge_cap=4, ghost_slots=32,
              queue_cap=48, chan_cap=16, futq_cap=4, io_stream_cap=2048,
              chunk=64, rhizome_cap=2, lanes=2)
    p, flts, rows = run_stream(kw, dict(seed=2, drop_rate=0.08),
                               weighted_increments(), app="widest",
                               seed_val=1e9)
    assert sum(f[FLT_DROP] for f in flts) > 0 and rows
