"""Livelock recovery on the CPU (DESIGN §9): ``paper_experiments.
recovery_smoke``, the lanes=1 hub wedge of ``tests/test_resilience.py``
(``_wedge_cfg``, the degree-200 hub stream) under
``RecoveryPolicy(max_attempts=2)``, held to the JAX engine's run of the
same smoke recorded in ``src/repro_torch/data/resilience_fingerprint.json``
(``tools/record_torch_fingerprint.py --resilience``): the recovery log
entry by entry, the flight recorder's wedge report included, the
increment's counters and the digest of every leaf it ends in.
"""
import json
import pathlib

from repro_torch.launch import paper_experiments as pe

from test_torch_faults_chunks import one_torch_thread  # noqa: F401

FP = json.loads((pathlib.Path(pe.__file__).parents[1] / "data"
                 / "resilience_fingerprint.json").read_text())


def _row(kind):
    return next(r for r in FP["streams"] if r["kind"] == kind)


def test_recovery_smoke_equals_the_jax_engine():
    got = pe.recovery_smoke("cpu")
    want = _row("recovery")
    assert got["status"] == "recovered" and got["escalated_lanes"] == 2
    assert got["wedge_cycle"] == 704 == want["log"][0]["cycle"]
    assert len(got["log"]) == len(want["log"]) == 1
    for a, b in zip(got["log"], want["log"]):
        assert a == b
    assert {k: got[k] for k in ("cycles", "hops", "execs", "stalls",
                                "allocs")} == \
        {k: want[k] for k in ("cycles", "hops", "execs", "stalls", "allocs")}
    bad = sorted(k for k in want["state"] if got["state"][k] !=
                 want["state"][k])
    assert not bad, f"leaves differ from the JAX engine's: {bad}"
