"""Replays of ``src/repro_torch/data/resilience_fingerprint.json`` (the
JAX engine, ``tools/record_torch_fingerprint.py --resilience``) on the
CPU, through ``paper_experiments.resilience_replay`` as on the card: the
guarded hub stream at ``io_stream_cap=8`` in two increments, where the
budget falls to ``io_cells`` within the first, through both drivers,
each equal to the JAX engine's same driver (budgets, counters, every
leaf's digest); ``kill_resume_smoke("ci")``'s totals and final leaves; and the checkpoint cadence sweep (``profile_resilience``) running
the same cycles at every cadence.
"""
import json
import pathlib

from repro_torch.launch import paper_experiments as pe

from test_torch_faults_chunks import one_torch_thread  # noqa: F401

FP = json.loads((pathlib.Path(pe.__file__).parents[1] / "data"
                 / "resilience_fingerprint.json").read_text())


def _row(name):
    return next(r for r in FP["streams"] if r["name"] == name)


def test_guarded_two_increments_replay():
    rec = _row("guarded hub io_stream_cap=8, two increments")
    got = pe.resilience_replay(rec, "cpu")["drivers"]
    for driver, rows in rec["drivers"].items():
        for i, (a, b) in enumerate(zip(got[driver], rows)):
            assert {k: v for k, v in a.items() if k != "state"} == \
                {k: v for k, v in b.items() if k != "state"}, (driver, i)
            bad = sorted(k for k in b["state"]
                         if a["state"][k] != b["state"][k])
            assert not bad, f"{driver} {i}: leaves differ: {bad}"
    assert min(rec["drivers"]["device"][0]["budgets"]) == 8   # io_cells


def test_kill_resume_smoke_ci_replay():
    got = pe.kill_resume_smoke("ci", "cpu")
    want = _row("kill_resume ci")
    assert got["totals"] == want["totals"] == dict(
        hops=41157, execs=7868, stalls=14, allocs=109)
    assert (got["resumed_at"], got["total_cycles"]) == (
        want["resumed_at"], want["total_cycles"])
    assert got["state"] == want["state"]


def test_profile_resilience_cadences(tmp_path):
    rec = pe.profile_resilience("ci", "cpu", cadences=(0, 1, 2),
                                ckpt_dir=tmp_path)
    runs = rec["runs"]
    assert [r["every"] for r in runs] == [0, 1, 2]
    assert [[s["step"] for s in r["saves"]] for r in runs] == \
        [[], [1, 2, 3], [1, 3]]
    assert all(s["bytes"] > 0 and s["write_s"] >= 0 for r in runs
               for s in r["saves"])
    assert all(r["wall_s"] is None for r in runs)   # walls on the card only
    assert not list(tmp_path.iterdir())             # removed after each run
