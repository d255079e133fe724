"""The fault instances of both CUDA cycle kernels on the card, against the
plain version: under a ``FaultPlan`` every state leaf (``flt`` and the
seal words included) and the launch record equal the plain version's
after every chunk, on the cluster kernel and forced onto the one-block
kernel, with telemetry on and off: the pinned 8x8 stream under drop, dup
and corrupt, the hub stream of ``tests/test_resilience.py`` under two
blackouts, and the rhizome hub stream's repair pass (``OP_REPAIR`` to
secondary roots, under the plan's safe twin); and the engine on the card
replaying the rows of ``src/repro_torch/data/fault_fingerprint.json`` that
the CPU tests replay.

A CUDA kernel has no CPU mode, so these tests carry the ``gpu`` marker
and skip (from a fixture) where there is no card; ``chip_smoke.py``
(phases 27-30) runs the same comparisons at the main path's shapes.
"""
import dataclasses
import json
import pathlib

import pytest
import torch

from repro_torch.core import BFS, EngineConfig, StreamingEngine
from repro_torch.core.ingest import load_stream
from repro_torch.graph.streams import StreamSpec, make_stream
from repro_torch.kernels.cca_cycle import ops
from repro_torch.kernels.cca_cycle.ref import cca_cycle_chunk_ref
from repro_torch.launch import paper_experiments as pe
from repro_torch.resilience import FaultPlan

pytestmark = pytest.mark.gpu
ROOT = pathlib.Path(__file__).resolve().parents[1]
PINNED = json.loads((ROOT / "tests" / "data"
                     / "pre_lanes_reference.json").read_text())
FP = json.loads((ROOT / "src" / "repro_torch" / "data"
                 / "fault_fingerprint.json").read_text())
RESET = ("stat_hops", "stat_exec", "stat_stall", "stat_allocs", "tm_cell",
         "tm_lane", "tm_hiw", "flt")
HUB_KW = dict(height=8, width=8, n_vertices=256, edge_cap=8, ghost_slots=24,
              queue_cap=32, chan_cap=16, chunk=64, lanes=2)
RHIZOME_KW = dict(height=8, width=8, n_vertices=64, edge_cap=4,
                  ghost_slots=32, queue_cap=96, chan_cap=16, futq_cap=8,
                  io_stream_cap=2048, chunk=128, rhizome_cap=4)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU "
                    "mode (chip_smoke.py runs these comparisons there)")
    return torch.device("cuda")


def clone(st):
    return st._replace(**{k: v.clone() for k, v in st._asdict().items()})


def assert_same(a, b, where):
    for k in a._fields:
        x, y = getattr(a, k), getattr(b, k)
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y), f"leaf {k} {where}"


def chunks(cfg, st, incs, max_chunks=40):
    """Both kernels against the plain version chunk by chunk from ``st``
    over ``incs`` (``None``: nothing to load); returns the last state."""
    n = 0
    for e in incs:
        if e is not None:
            st, _ = load_stream(cfg, st, e)
        st = st._replace(**{k: torch.zeros_like(getattr(st, k))
                            for k in RESET})
        q = False
        while not q and n < max_chunks:
            want, rec = cca_cycle_chunk_ref(cfg, BFS, st)
            for path in ("cluster", "block"):
                got, r = ops.cca_cycle_chunk(cfg, BFS, clone(st), path=path)
                assert torch.equal(r, rec), (path, n)
                assert_same(got, want, f"{path} chunk {n}")
            st, q, n = want, bool(rec[0]), n + 1
    return st


@pytest.mark.parametrize("telemetry", [False, True])
def test_pinned_drop_dup_corrupt(card, telemetry):
    cfg = EngineConfig(**PINNED["cfg"], telemetry=telemetry,
                       faults=FaultPlan(seed=5, drop_rate=0.05,
                                        dup_rate=0.03, corrupt_rate=0.02))
    eng = StreamingEngine(cfg, "bfs")
    eng.seed(0, 0.0)
    st = chunks(cfg, eng.state, make_stream(StreamSpec(**PINNED["spec"])))
    assert st.flt[:3].min() > 0


@pytest.mark.parametrize("telemetry", [False, True])
def test_hub_blackouts(card, telemetry):
    cfg = EngineConfig(**HUB_KW, telemetry=telemetry, faults=FaultPlan(
        seed=7, blackouts=((0, 1, 2, 0, 64), (0, 2, 2, 0, 64))))
    eng = StreamingEngine(cfg, "bfs")
    eng.seed(0, 0.0)
    st = chunks(cfg, eng.state, [pe.hub_stream()], max_chunks=4)
    assert int(st.flt[3]) > 0


@pytest.mark.parametrize("telemetry", [False, True])
def test_rhizome_repair_pass(card, telemetry):
    cfg = EngineConfig(**RHIZOME_KW, telemetry=telemetry,
                       faults=FaultPlan(seed=3, drop_rate=0.05))
    eng = StreamingEngine(cfg, "bfs")
    eng.seed(0, 0.0)
    eng.state, spill = load_stream(cfg, eng.state, pe.hub_stream(64, 40))
    eng._passes(cfg, spill, 200_000, [])
    rows = eng._repair_entries()
    assert (rows[:, 1] < -1).any()          # rows for roots k >= 1
    safe = dataclasses.replace(cfg, faults=cfg.faults.safe())
    st, _ = load_stream(safe, eng.state, rows)
    chunks(safe, st, [None])


@pytest.mark.parametrize("name", ["fault_smoke ci", "hub drop/dup/corrupt",
                                  "pinned lanes=1 drop/corrupt"])
def test_engine_replays_the_fault_fingerprint(card, name):
    rec = next(r for r in FP["streams"] if r["name"] == name)
    got, _ = pe.fault_replay(rec, PINNED["spec"])
    assert got["increments"] == rec["increments"]
