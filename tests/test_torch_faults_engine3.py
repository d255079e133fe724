"""The resilience contracts of ``tests/test_resilience.py`` on the port's
engine against the JAX engine, on both drivers, with the helpers of
``tests/test_torch_faults_engine.py`` (see there): a blackout is a
lossless delay: messages wait on the dead links, none is lost, nothing is
repaired, the values are exact; and the pinned 8x8 stream's row (lanes=1,
drop and corrupt) on the device loop.
"""
import numpy as np
import pytest

from repro_torch.core.reference import bfs_levels
from repro_torch.launch import paper_experiments as pe
from repro_torch.resilience import FLT_BLACKOUT, FLT_CORRUPT, FLT_DROP

from test_torch_faults_engine import (one_torch_thread,  # noqa: F401
                                      replay, traced)


def exact(eng):
    edges = pe.hub_stream()
    np.testing.assert_array_equal(eng.values(),
                                  bfs_levels(256, edges[:, :2], 0))


@pytest.mark.parametrize("driver", ["device", "traced"])
def test_blackout_is_a_lossless_delay(driver):
    name = "hub blackouts"
    if driver == "device":
        eng = replay(name)
    else:
        eng, (r,), _ = traced(name)
        assert len(r.active_per_cycle) == r.cycles    # no repair tail
        assert r.execs == int(eng.state.stat_exec)
    flt = eng.state.flt.tolist()
    assert flt[FLT_BLACKOUT] > 0 and flt[FLT_DROP] == flt[FLT_CORRUPT] == 0
    exact(eng)


def test_pinned_lanes1_drop_corrupt_replays_the_fingerprint():
    eng = replay("pinned lanes=1 drop/corrupt")
    assert eng.state.flt.tolist()[FLT_DROP] > 0
