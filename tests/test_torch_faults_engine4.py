"""The resilience contracts of ``tests/test_resilience.py`` on the port's
engine against the JAX engine, on both drivers, with the helpers of
``tests/test_torch_faults_engine.py`` (see there): duplicates alone are
idempotent: delivered twice, nothing lost, the values exact without a
repair; and the ci fault smoke's row, 943 cycles with the JAX engine's
``flt``.
"""
import numpy as np
import pytest

from repro_torch.core.reference import bfs_levels
from repro_torch.launch import paper_experiments as pe
from repro_torch.resilience import FLT_DROP, FLT_DUP

from test_torch_faults_engine import (one_torch_thread,  # noqa: F401
                                      replay, traced)


def exact(eng):
    edges = pe.hub_stream()
    np.testing.assert_array_equal(eng.values(),
                                  bfs_levels(256, edges[:, :2], 0))


@pytest.mark.parametrize("driver", ["device", "traced"])
def test_duplicates_are_idempotent(driver):
    name = "hub dups"
    eng = replay(name) if driver == "device" else traced(name)[0]
    flt = eng.state.flt.tolist()
    assert flt[FLT_DUP] > 0 and flt[FLT_DROP] == 0
    exact(eng)


def test_ci_fault_smoke_replays_the_fingerprint():
    """943 cycles over three increments, each with the JAX engine's
    ``flt`` ([119, 50, 54, 54], [488, 203, 209, 0], [247, 124, 109, 0]),
    frames (8, 9, 8) and final state."""
    assert replay("fault_smoke ci").total_cycles == 943
