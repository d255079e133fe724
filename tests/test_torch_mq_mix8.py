"""``tests/test_mq.py``'s MIX8 batch (Q = 8: bfs, sssp, cc, widest and
reliable tenants over one weighted symmetric stream) replayed by the port
alone on the CPU against its row of ``src/repro_torch/data/
mq_fingerprint.json``, no JAX at test time: each increment's counters,
qchg / qlast, lifecycle and leaf digests, each slot's values and the
receipts; and the min-trio and widest slots against the port's oracles."""
import json
import pathlib

import numpy as np
import torch

from repro_torch.core.reference import bfs_levels, cc_labels, sssp_dists
from repro_torch.launch.serve_bench import mq_replay, weighted_stream

ROOT = pathlib.Path(__file__).resolve().parents[1]
FP = json.loads((ROOT / "src" / "repro_torch" / "data"
                 / "mq_fingerprint.json").read_text())


def _widest(n, edges, source):
    cap = np.zeros(n, np.float64)
    cap[source] = 1e9
    w = edges[:, 2].astype(np.int32).view(np.float32).astype(np.float64)
    while True:
        new = cap.copy()
        np.maximum.at(new, edges[:, 1], np.minimum(cap[edges[:, 0]], w))
        if np.array_equal(new, cap):
            return cap.astype(np.float32)
        cap = new


def test_mix8_replays_and_meets_the_oracles():
    rec = next(r for r in FP["runs"] if r["kind"] == "mix8")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        got = mq_replay(rec, device="cpu")
    finally:
        torch.set_num_threads(n)
    for k in rec:
        assert got[k] == rec[k], k
    vals = [np.float32(v["values"]) for v in got["final"]["values"]]
    edges = np.concatenate(weighted_stream(**rec["stream"]))
    w = edges[:, 2].astype(np.int32).view(np.float32)
    np.testing.assert_array_equal(vals[0], bfs_levels(128, edges, 0))
    np.testing.assert_allclose(vals[2], sssp_dists(128, edges, w, 3),
                               rtol=1e-5)
    np.testing.assert_array_equal(vals[4], cc_labels(128, edges))
    np.testing.assert_array_equal(vals[5], _widest(128, edges, 5))
    assert all(r["latency_cycles"] > 0 for r in got["receipts"])
