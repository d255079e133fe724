"""The hub stream of ``tests/test_lanes.py`` on the port's plain version,
on the CPU, at ``lanes=2`` (one data lane beside the escape lane): it
completes at ``queue_cap`` 20, where ``lanes=1`` livelocks
(``tests/test_torch_lanes.py``), with the values of the oracle.
``lanes=4``, every leaf against the JAX engine chunk by chunk:
``tests/test_torch_lanes_hub.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import EngineConfig, StreamingEngine
from repro_torch.core.reference import bfs_levels
from repro_torch.graph.streams import hub_edges

ONE = np.float32(1.0).view(np.int32)
HUB = dict(height=8, width=8, n_vertices=128, edge_cap=4, ghost_slots=48,
           queue_cap=20, chan_cap=16, futq_cap=4, io_stream_cap=2048,
           chunk=64)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain version runs thousands of tiny ops per cycle: one
    intra-op thread is faster, and leaves the cores to the other test
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_hub_lanes2_completes_with_the_oracles_values():
    e = hub_edges(128, 0, 200, seed=3)
    edges = np.concatenate([e, np.full((len(e), 1), ONE, np.int64)],
                           1).astype(np.int32)
    eng = StreamingEngine(EngineConfig(lanes=2, **HUB), "bfs", device="cpu")
    eng.seed(0, 0.0)
    r = eng.run_increment(edges, max_cycles=500_000)
    assert r.cycles > 0 and r.stalls > 0
    np.testing.assert_array_equal(eng.values(128), bfs_levels(128, edges, 0))
