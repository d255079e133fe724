"""The 8x8 hub stream of the JAX package's ``tests/test_resilience.py``
(lanes=2, telemetry on) under its plans, chunk by chunk against the JAX
engine on the CPU, with the helpers of ``tests/test_torch_faults_chunks.py``:
every leaf after every chunk of the faulty run and of the repair pass.
This file: drop and corrupt over three increments of one growing
graph.
"""
from repro_torch.launch.paper_experiments import hub_stream
from repro_torch.resilience import FLT_CORRUPT, FLT_DROP

from test_torch_faults_chunks import (one_torch_thread,  # noqa: F401
                                      run_stream)

KW = dict(height=8, width=8, n_vertices=256, edge_cap=8, ghost_slots=24,
          queue_cap=32, chan_cap=16, chunk=64, lanes=2, max_cycles=200_000,
          telemetry=True)                 # tests/test_resilience.py::_cfg


def test_hub_three_increments_drop_corrupt_chunk_by_chunk():
    edges = hub_stream()
    p, flts, rows = run_stream(
        KW, dict(seed=3, drop_rate=0.04, corrupt_rate=0.02),
        [edges[:150], edges[150:300], edges[300:]])
    assert sum(f[FLT_DROP] + f[FLT_CORRUPT] for f in flts) > 0
    assert len(rows) >= 2
