"""The resilience contracts of ``tests/test_resilience.py`` on the port's
engine against the JAX engine, on both drivers, with the helpers of
``tests/test_torch_faults_engine.py`` (see there): the faulty hub stream
(drop, dup and corrupt) loses messages and still ends exact; the traced
loop's repair tail adds no trace row.
"""
import numpy as np
import pytest

from repro_torch.core.reference import bfs_levels
from repro_torch.launch import paper_experiments as pe
from repro_torch.resilience import FLT_CORRUPT, FLT_DROP, FLT_DUP

from test_torch_faults_engine import (one_torch_thread,  # noqa: F401
                                      replay, traced)


def exact(eng):
    edges = pe.hub_stream()
    np.testing.assert_array_equal(eng.values(),
                                  bfs_levels(256, edges[:, :2], 0))


@pytest.mark.parametrize("driver", ["device", "traced"])
def test_faulty_hub_stream_converges_exact(driver):
    name = "hub drop/dup/corrupt"
    if driver == "device":
        eng = replay(name)
    else:
        eng, (r,), _ = traced(name)
        # the repair tail's cycles count, its trace rows do not exist
        assert 0 < len(r.active_per_cycle) < r.cycles
    flt = eng.state.flt.tolist()
    assert flt[FLT_DROP] > 0 and flt[FLT_DUP] > 0 and flt[FLT_CORRUPT] > 0
    exact(eng)
