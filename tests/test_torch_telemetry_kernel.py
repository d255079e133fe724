"""The telemetry instances of both CUDA cycle kernels on the card, against
the plain version: with ``telemetry=True`` every state leaf, the three
planes included, and the launch record equal the plain version's after
every chunk, on the cluster kernel and forced onto the one-block kernel,
on the pinned 8x8 stream, the 8x8 hub stream at ``lanes`` 1 (up to its
livelock) and 4 (parking), the rhizome hub stream at ``rhizome_cap=4``
and ``widest`` at ``rhizome_cap=2``, ``lanes=2``; the engine's frame log
on the card equal to the CPU's, and the hub livelock's error text too.

A CUDA kernel has no CPU mode, so these tests carry the ``gpu`` marker
and skip (from a fixture) where there is no card; ``chip_smoke.py`` runs
the same comparisons at the main path's shapes.
"""
import json
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.core import EngineConfig, LivelockError, StreamingEngine
from repro_torch.core.ingest import load_stream
from repro_torch.graph.streams import StreamSpec, hub_edges, make_stream
from repro_torch.kernels.cca_cycle import ops
from repro_torch.kernels.cca_cycle.ref import cca_cycle_chunk_ref

pytestmark = pytest.mark.gpu
PINNED = json.loads((pathlib.Path(__file__).parent / "data"
                     / "pre_lanes_reference.json").read_text())
ONE = np.float32(1.0).view(np.int32)
HUB_KW = dict(height=8, width=8, n_vertices=128, edge_cap=4, ghost_slots=48,
              queue_cap=20, chan_cap=16, futq_cap=4, io_stream_cap=2048,
              chunk=64)
RHIZOME_KW = dict(height=8, width=8, n_vertices=64, edge_cap=4,
                  ghost_slots=32, queue_cap=96, chan_cap=16, futq_cap=8,
                  io_stream_cap=2048, chunk=128, rhizome_cap=4)
MAX_APP_KW = dict(height=8, width=8, n_vertices=64, edge_cap=4,
                  ghost_slots=32, queue_cap=48, chan_cap=16, futq_cap=4,
                  io_stream_cap=2048, chunk=64, rhizome_cap=2, lanes=2)
RESET = ("stat_hops", "stat_exec", "stat_stall", "stat_allocs", "tm_cell",
         "tm_lane", "tm_hiw")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU "
                    "mode (chip_smoke.py runs these comparisons there)")
    return torch.device("cuda")


def hub_stream(n=128, degree=200, seed=3):
    e = hub_edges(n, 0, degree, seed=seed)
    return np.concatenate([e, np.full((len(e), 1), ONE, np.int64)],
                          1).astype(np.int32)


def weighted_increments(seed=1, n=64, m=320):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, m), rng.integers(0, n, m)
    w = (1.0 - rng.random(m)).astype(np.float32)
    e = np.stack([src, dst, w.view(np.int32)], 1).astype(np.int32)
    return [e[: m // 2], e[m // 2:]]


def clone(st):
    return st._replace(**{k: v.clone() for k, v in st._asdict().items()})


def assert_same(a, b, where):
    for k in a._fields:
        x, y = getattr(a, k), getattr(b, k)
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y), f"leaf {k} {where}"


CASES = {
    "pinned": (PINNED["cfg"], "bfs", 0.0,
               lambda: make_stream(StreamSpec(**PINNED["spec"])), 100),
    "hub lanes=1": (dict(HUB_KW, lanes=1), "bfs", 0.0,
                    lambda: [hub_stream()], 12),
    "hub lanes=4": (dict(HUB_KW, lanes=4), "bfs", 0.0,
                    lambda: [hub_stream()], 16),
    "rhizome_cap=4": (RHIZOME_KW, "bfs", 0.0,
                      lambda: [hub_stream(64, 40, 3)], 100),
    "widest": (MAX_APP_KW, "widest", 1e9, weighted_increments, 100),
}


@pytest.mark.parametrize("path", ["cluster", "block"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_telemetry_instances_match_plain_chunk_by_chunk(card, case, path):
    kw, app, seed, incs, max_chunks = CASES[case]
    cfg = EngineConfig(**kw, telemetry=True)
    eng = StreamingEngine(cfg, app)
    eng.seed(0, seed)
    st, n = eng.state, 0
    before = dict(ops.path_launches)
    for e in incs():
        st, _ = load_stream(cfg, st, e)
        st = st._replace(**{k: torch.zeros_like(getattr(st, k))
                            for k in RESET})
        while n < max_chunks:
            sk, qk = ops.cca_cycle_chunk(cfg, eng.app, clone(st), path=path)
            sr, qr = cca_cycle_chunk_ref(cfg, eng.app, st)
            n += 1
            assert torch.equal(qk, qr)
            assert_same(sk, sr, f"chunk {n}")
            st = sr
            if qr[0]:
                break
    assert ops.path_launches[path] - before[path] == n
    assert int(st.tm_cell.sum()) > 0


@pytest.mark.parametrize("traced", [False, True])
def test_engine_frames_on_the_card_equal_the_cpu(card, traced):
    kw = dict(PINNED["cfg"], telemetry=True, frame_ring=2)
    logs = []
    for dev in ("cuda", "cpu"):
        eng = StreamingEngine(EngineConfig(**kw), "bfs", device=dev)
        eng.seed(0, 0.0)
        logs.append([eng.run_increment(e, collect_traces=traced).frames
                     for e in make_stream(StreamSpec(**PINNED["spec"]))])
    for a, b in zip(*logs):
        assert (len(a), a.dropped) == (len(b), b.dropped)
        for k in ("cell", "lane", "hiw", "aq_n", "pk_n", "ch_n", "scal"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))


def test_hub_livelock_report_on_the_card_equals_the_cpu(card):
    errs = []
    for dev in ("cuda", "cpu"):
        eng = StreamingEngine(EngineConfig(**HUB_KW, lanes=1, telemetry=True,
                                           frame_ring=16), "bfs", device=dev)
        eng.seed(0, 0.0)
        with pytest.raises(LivelockError) as ei:
            eng.run_increment(hub_stream())
        errs.append(ei.value)
    assert (errs[0].cycle, errs[0].chunk) == (errs[1].cycle, errs[1].chunk)
    assert str(errs[0]) == str(errs[1]) and "flight recorder" in str(errs[0])
