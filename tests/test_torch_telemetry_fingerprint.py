"""The port on the CPU replays
``src/repro_torch/data/telemetry_fingerprint.json`` (the JAX engine with
``telemetry=True``, recorded by
``tools/record_torch_fingerprint.py --telemetry``) exactly, for the
streams that are quick on the CPU: the pinned 8x8 stream, ``bench_engine``'s
ci stream (its heatmap included) and the 8x8 hub livelock (its full text,
wedge report included): each increment's counters, frame count,
``dropped``, ``FrameLog.totals()`` and the final frame's plane digests.
``chip_smoke.py`` replays every stream on the card.
"""
import json
import pathlib

import pytest
import torch

from repro_torch.launch import paper_experiments as pe

ROOT = pathlib.Path(__file__).resolve().parents[1]
FP = json.loads((ROOT / "src" / "repro_torch" / "data"
                 / "telemetry_fingerprint.json").read_text())
REF = json.loads((ROOT / "tests" / "data"
                  / "pre_lanes_reference.json").read_text())


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("kind", ["pinned", "engine", "hub"])
def test_cpu_replays_the_telemetry_fingerprint(kind):
    want = next(r for r in FP["streams"] if r["kind"] == kind)
    assert want["cfg"]["telemetry"]
    got, _ = pe.telemetry_replay(want, FP["max_cycles"], REF["spec"],
                                 device="cpu")
    for k in ("increments", "livelock", "heatmap"):
        assert got.get(k) == want.get(k), k
