"""The 8x8 hub stream of the JAX package's ``tests/test_resilience.py``
(lanes=2, telemetry on) under its plans, chunk by chunk against the JAX
engine on the CPU, with the helpers of ``tests/test_torch_faults_chunks.py``:
every leaf after every chunk of the faulty run and of the repair pass.
This file: two blackouts (a lossless delay: nothing to repair), and dups
alone (idempotent: nothing to repair).
"""
from repro_torch.launch.paper_experiments import hub_stream
from repro_torch.resilience import (FLT_BLACKOUT, FLT_CORRUPT, FLT_DROP,
                                    FLT_DUP)

from test_torch_faults_chunks import (one_torch_thread,  # noqa: F401
                                      run_stream)

KW = dict(height=8, width=8, n_vertices=256, edge_cap=8, ghost_slots=24,
          queue_cap=32, chan_cap=16, chunk=64, lanes=2, max_cycles=200_000,
          telemetry=True)                 # tests/test_resilience.py::_cfg


def test_hub_blackouts_chunk_by_chunk():
    p, (flt,), rows = run_stream(KW, dict(
        seed=7, blackouts=((0, 1, 2, 0, 64), (0, 2, 2, 0, 64))),
        [hub_stream()])
    assert flt[FLT_BLACKOUT] > 0 and flt[FLT_DROP] == flt[FLT_CORRUPT] == 0
    assert not rows


def test_hub_dups_chunk_by_chunk():
    p, (flt,), rows = run_stream(KW, dict(seed=11, dup_rate=0.08),
                                 [hub_stream()])
    assert flt[FLT_DUP] > 0 and flt[FLT_DROP] == flt[FLT_CORRUPT] == 0
    assert not rows
