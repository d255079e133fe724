"""The resilience contracts of ``tests/test_resilience.py`` on the port's
engine against the JAX engine, on both drivers, with the helpers of
``tests/test_torch_faults_engine.py`` (see there): drop and corrupt over
three increments of one growing graph, each repaired, the values exact at
the end.
"""
import numpy as np
import pytest

from repro_torch.core.reference import bfs_levels
from repro_torch.launch import paper_experiments as pe
from repro_torch.resilience import FLT_CORRUPT, FLT_DROP

from test_torch_faults_engine import (one_torch_thread,  # noqa: F401
                                      replay, traced)


def exact(eng):
    edges = pe.hub_stream()
    np.testing.assert_array_equal(eng.values(),
                                  bfs_levels(256, edges[:, :2], 0))


@pytest.mark.parametrize("driver", ["device", "traced"])
def test_faulty_multi_increment_stream(driver):
    name = "hub drop/corrupt, three increments"
    eng = replay(name) if driver == "device" else traced(name)[0]
    assert eng.stream_pos == 3
    exact(eng)
