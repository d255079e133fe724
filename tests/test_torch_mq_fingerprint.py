"""Rows of ``src/repro_torch/data/mq_fingerprint.json`` (recorded from the
JAX engine by ``tools/record_torch_fingerprint.py --mq``) replayed by the
port alone on the CPU, no JAX at test time: the Q=1 session on the pinned
stream, the mid-stream admit / retire / recycle sequence (a composite
rebuilt into another slot app) and the Q=3 parity config, every recorded
field: each increment's counters, qchg / qlast, lifecycle and leaf
digests, each slot's values, the receipt.  MIX8 has a file of its own
(``test_torch_mq_mix8.py``); ``chip_smoke.py`` phase 37 replays every
row on the card."""
import json
import pathlib

import pytest
import torch

from repro_torch.launch.serve_bench import mq_replay

ROOT = pathlib.Path(__file__).resolve().parents[1]
FP = json.loads((ROOT / "src" / "repro_torch" / "data"
                 / "mq_fingerprint.json").read_text())
PINNED = json.loads((ROOT / "tests" / "data"
                     / "pre_lanes_reference.json").read_text())


def run(kind):
    return next(r for r in FP["runs"] if r["kind"] == kind)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("kind", ["q1", "admit", "q3"])
def test_fingerprint_row_replays(kind):
    rec = run(kind)
    got = mq_replay(rec, device="cpu", pinned=PINNED)
    assert sorted(got) == sorted(rec)
    for k in rec:
        assert got[k] == rec[k], k


def test_fingerprint_records_what_the_issue_pins():
    """The recorded runs carry ``results/bench_serve.json``'s numbers and
    the paper-config batch's outcome the card replays."""
    serve = run("serve")
    assert serve["record"] == json.loads(
        (ROOT / "results" / "bench_serve.json").read_text())
    assert [b["cycles"] for b in serve["beats"]] == [785, 1410, 766, 0]
    assert sum(s["cycles"] for s in serve["serial"]) == 6692
    paper = run("paper_q8")
    assert paper["outcome"] == "quiescent" and paper["sources"][0] == 0
    assert len(set(paper["sources"])) == 8
    from repro_torch.launch.serve_bench import batch_sources
    assert batch_sources(paper["size"][0]) == paper["sources"]
