"""The resilience contracts of the JAX package's ``tests/test_resilience.py``
on the port's engine (CPU), on the same stream and plans, on both drivers:
the device loop replays ``src/repro_torch/data/fault_fingerprint.json``
(the JAX engine's device loop, recorded by
``tools/record_torch_fingerprint.py --faults``: every increment's cycles,
four counters, ``flt``, frame count and the digest of every leaf of its
final state), and the traced host loop (``collect_traces=True``) runs
beside the JAX engine's in the same process, every increment's
``IncrementResult`` (the trace rows included), its ``flt`` and the final
state's every leaf equal.  This file: a zero-rate plan is the engine
without faults, but for the seals.  ``..._engine2.py``: the faulty hub
stream (drop, dup and corrupt) loses messages and still ends exact, and
the traced loop's repair tail adds no trace row.  ``..._engine3.py``: a
blackout is a lossless delay; the pinned stream's row.
``..._engine4.py``: duplicates are idempotent; the ci fault smoke's row.
``..._engine5.py``: faults and repair over three increments.  The other
files use this one's helpers.
"""
import json
import pathlib

import numpy as np
import pytest
import torch

from repro.core import EngineConfig as JConfig
from repro.core import StreamingEngine as JEngine
from repro.resilience import FaultPlan as JPlan
from repro_torch.core import EngineConfig, StreamingEngine
from repro_torch.core.state import state_to_numpy
from repro_torch.launch import paper_experiments as pe

ROOT = pathlib.Path(__file__).resolve().parents[1]
FP = json.loads((ROOT / "src" / "repro_torch" / "data"
                 / "fault_fingerprint.json").read_text())
PINNED_SPEC = json.loads((ROOT / "tests" / "data"
                          / "pre_lanes_reference.json").read_text())["spec"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def row(name):
    return next(r for r in FP["streams"] if r["name"] == name)


def replay(name):
    """The port's device loop on fingerprint row ``name``, every
    increment equal to the JAX engine's record.  Returns the engine."""
    rec = row(name)
    got, eng = pe.fault_replay(rec, PINNED_SPEC, device="cpu")
    assert len(got["increments"]) == len(rec["increments"])
    for i, (a, b) in enumerate(zip(got["increments"], rec["increments"])):
        assert a == b, (name, i)
    return eng


def assert_same_state(st, jst):
    got = state_to_numpy(st)
    for k, v in jst._asdict().items():
        a, b = got[k], np.asarray(v)
        if a.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        np.testing.assert_array_equal(a, b, err_msg=k)


def traced(name):
    """Fingerprint row ``name``'s config, plan and stream through both
    engines' traced loops, every increment's result (trace rows
    included), ``flt`` and the final state compared.  Returns the port's
    engine, its results and the stream's edges."""
    rec = row(name)
    plan = dict(rec["plan"], blackouts=tuple(
        tuple(b) for b in rec["plan"]["blackouts"]))
    kw = {k: v for k, v in rec["cfg"].items()
          if k in EngineConfig.__dataclass_fields__}
    jeng = JEngine(JConfig(**kw, faults=JPlan(**plan)), "bfs")
    eng = StreamingEngine(EngineConfig(**kw, faults=pe.FaultPlan(**plan)),
                          "bfs", device="cpu")
    for e in (jeng, eng):
        e.seed(0, 0.0)
    edges = pe.hub_stream()
    res = []
    for i, (lo, hi) in enumerate(rec["splits"]):
        jr = jeng.run_increment(edges[lo:hi], collect_traces=True)
        r = eng.run_increment(edges[lo:hi], collect_traces=True)
        for k in ("cycles", "hops", "execs", "stalls", "allocs"):
            assert getattr(r, k) == getattr(jr, k), (i, k)
        assert len(r.frames) == len(jr.frames), i
        np.testing.assert_array_equal(r.active_per_cycle,
                                      jr.active_per_cycle)
        np.testing.assert_array_equal(r.in_flight_per_cycle,
                                      jr.in_flight_per_cycle)
        np.testing.assert_array_equal(eng.state.flt.numpy(),
                                      np.asarray(jeng.state.flt))
        res.append(r)
    assert_same_state(eng.state, jeng.state)
    return eng, res, edges


def test_zero_rate_plan_replays_the_fingerprint_as_the_engine_without_faults():
    """The device loop: the JAX engine's results under the plan, and the
    cycles, counters and values of the engine without a plan."""
    eng = replay("hub zero-rate")
    assert eng.state.flt.sum() == 0
    e0 = StreamingEngine(EngineConfig(**{
        k: v for k, v in row("hub zero-rate")["cfg"].items()
        if k in EngineConfig.__dataclass_fields__}), "bfs", device="cpu")
    e0.seed(0, 0.0)
    r0 = e0.run_increment(pe.hub_stream())
    want = row("hub zero-rate")["increments"][0]
    assert [getattr(r0, k) for k in ("cycles", "hops", "execs", "stalls",
                                     "allocs")] == \
        [want[k] for k in ("cycles", "hops", "execs", "stalls", "allocs")]
    assert torch.equal(eng.state.vals, e0.state.vals)


def test_zero_rate_plan_traced_matches_jax():
    eng, _, _ = traced("hub zero-rate")
    assert eng.state.flt.sum() == 0
