"""The ingest guard on the CPU (DESIGN §9): ``tests/test_resilience.py``'s
hub stream on its ``_cfg`` with ``ingest_guard=True`` and
``io_stream_cap=32``, through both drivers (the device loop and the
traced loop), each against the live JAX engine's same driver: every
budget the guard sets, in order, the increment's counters and every leaf
of the final state, and BFS equal to the oracle.  As in the JAX engine,
the device loop limits its spill reloads and the traced loop does not,
so the two drivers may differ from each other.
"""
import numpy as np
import pytest

from repro.core import EngineConfig as JConfig
from repro.core import StreamingEngine as JEngine
from repro_torch.core import EngineConfig, StreamingEngine
from repro_torch.core.reference import bfs_levels
from repro_torch.core.state import state_to_numpy
from repro_torch.launch import paper_experiments as pe
from repro_torch.launch.paper_experiments import hub_stream

from test_torch_faults_chunks import one_torch_thread  # noqa: F401

KW = dict(height=8, width=8, n_vertices=256, edge_cap=8, ghost_slots=24,
          queue_cap=32, chan_cap=16, chunk=64, lanes=2, max_cycles=200_000,
          telemetry=True, ingest_guard=True, io_stream_cap=32)


def guarded_run(eng, edges, traced):
    eng.seed(0, 0.0)
    traj = pe.guard_budgets(eng)
    r = eng.run_increment(edges, collect_traces=traced)
    return traj, [r.cycles, r.hops, r.execs, r.stalls, r.allocs]


@pytest.mark.parametrize("traced", [False, True], ids=["device", "traced"])
def test_guarded_hub_stream_equals_jax(traced):
    edges = hub_stream()
    jeng = JEngine(JConfig(**KW), "bfs")
    want_traj, want = guarded_run(jeng, edges, traced)
    eng = StreamingEngine(EngineConfig(**KW), "bfs", device="cpu")
    traj, got = guarded_run(eng, edges, traced)
    assert (traj, got) == (want_traj, want)
    assert traj == [128]                # 256 admissible, halved once
    st = state_to_numpy(eng.state)
    for k, v in jeng.state._asdict().items():
        a, b = st[k], np.asarray(v)
        if a.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        np.testing.assert_array_equal(a, b, err_msg=k)
    np.testing.assert_array_equal(eng.values(),
                                  bfs_levels(256, edges[:, :2], 0))
