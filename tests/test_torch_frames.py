"""The port's frame ring and ``FrameLog`` on the CPU against the JAX
engine's, on both drivers (the device loop of ``run_increment`` and the
traced host loop of ``collect_traces=True``), with ``telemetry=True``:
the same number of frames, ``dropped`` and every field of every frame,
increment by increment, on the pinned 8x8 stream at ``frame_ring`` 16
and 2 (the ring wraps), on an empty increment (a pass quiescent on
entry: one frame on the device loop, two on the traced loop) and on
``bench_engine``'s ci stream, whose first increment ends exactly on a
chunk boundary (256 cycles in chunks of 64).  Every increment's final
frame reconciles with its counters.  With telemetry off ``frames`` is
None and the old fingerprint replays.
"""
import json
import pathlib

import numpy as np
import pytest
import torch

from repro.core import EngineConfig as JConfig
from repro.core import StreamingEngine as JEngine
from repro_torch.core import EngineConfig, StreamingEngine
from repro_torch.core.state import TM_EXEC, TM_HOP, TM_IO
from repro_torch.graph.streams import StreamSpec, make_stream
from repro_torch.obs import FS_CYCLE, FrameLog

REF = json.loads((pathlib.Path(__file__).parent / "data"
                  / "pre_lanes_reference.json").read_text())
# benchmarks/engine_throughput.py: ENGINE_SCALES["ci"] and _cfg
ENGINE_CI = dict(height=8, width=8, n_vertices=256, edge_cap=8,
                 ghost_slots=64, queue_cap=64, chan_cap=16, futq_cap=8,
                 io_stream_cap=2 ** 18, chunk=64)
ENGINE_SPEC = dict(n_vertices=256, n_edges=2048, increments=2,
                   sampling="edge", seed=3)
FIELDS = ("cell", "lane", "hiw", "aq_n", "pk_n", "ch_n", "scal")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def both(kw, incs, traced):
    """Each increment of ``incs`` through both engines; yields the pair of
    results and the increment."""
    jeng = JEngine(JConfig(**kw), "bfs")
    eng = StreamingEngine(EngineConfig(**kw), "bfs", device="cpu")
    jeng.seed(0, 0.0)
    eng.seed(0, 0.0)
    for e in incs:
        yield (eng.run_increment(e, max_cycles=500_000,
                                 collect_traces=traced),
               jeng.run_increment(e, max_cycles=500_000,
                                  collect_traces=traced), e)


def assert_same_log(got, want, where=""):
    assert isinstance(got, FrameLog)
    assert (len(got), got.dropped) == (len(want), want.dropped), where
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k),
                                      err_msg=f"{k} {where}")


def assert_reconciles(r, edges):
    t, last = r.frames.totals(), r.frames.last()
    assert t["quiescent"] and t["backlog"] == 0 and t["in_flight"] == 0
    assert (t["hops"], t["execs"], t["stalls"], t["allocs"]) == \
        (r.hops, r.execs, r.stalls, r.allocs)
    assert int(last["cell"][..., TM_HOP].sum()) == r.hops
    assert int(last["cell"][..., TM_EXEC].sum()) == r.execs
    assert int(last["cell"][..., TM_IO].sum()) == len(edges)


@pytest.mark.parametrize("traced", [False, True], ids=["device", "traced"])
@pytest.mark.parametrize("ring", [16, 2])
def test_pinned_frames_equal_jax(ring, traced):
    kw = dict(REF["cfg"], telemetry=True, frame_ring=ring)
    n = []
    for i, (r, jr, e) in enumerate(both(
            kw, make_stream(StreamSpec(**REF["spec"])), traced)):
        assert (r.cycles, r.hops, r.execs) == (jr.cycles, jr.hops, jr.execs)
        assert_same_log(r.frames, jr.frames, f"increment {i}")
        assert_reconciles(r, e)
        n.append(len(r.frames) + r.frames.dropped)
    if ring == 2:
        assert r.frames.dropped > 0
        d = r.frames.deltas()
        assert d["cell"].shape[0] == len(r.frames) - 1
        assert (d["cell"] >= 0).all() and (d["scal"][:, FS_CYCLE] > 0).all()
    # the device loop: a baseline and a frame a chunk of 48, 112, 116
    # cycles; the traced loop stores one frame more after a quiescent
    # chunk end (none here)
    assert n == [2, 3, 3]


@pytest.mark.parametrize("traced", [False, True], ids=["device", "traced"])
def test_empty_increment_frames_equal_jax(traced):
    """A pass quiescent on entry: JAX's device loop runs no chunk (one
    frame), its traced loop one frozen chunk (two frames)."""
    kw = dict(REF["cfg"], telemetry=True, frame_ring=16)
    incs = [make_stream(StreamSpec(**REF["spec"]))[0],
            np.zeros((0, 3), np.int32)]
    for r, jr, e in both(kw, incs, traced):
        assert_same_log(r.frames, jr.frames)
        assert_reconciles(r, e)
    assert r.cycles == 0 and len(r.frames) == (2 if traced else 1)


@pytest.mark.parametrize("traced", [False, True], ids=["device", "traced"])
def test_chunk_boundary_frames_equal_jax(traced):
    """``bench_engine``'s ci stream: 256 cycles, a multiple of the chunk,
    then 208; the traced loop stores JAX's frame of the frozen chunk."""
    kw = dict(ENGINE_CI, telemetry=True)
    cycles = []
    for i, (r, jr, e) in enumerate(both(
            kw, make_stream(StreamSpec(**ENGINE_SPEC)), traced)):
        assert_same_log(r.frames, jr.frames, f"increment {i}")
        assert_reconciles(r, e)
        cycles.append((r.cycles, len(r.frames)))
    assert cycles == [(256, 6 if traced else 5), (208, 5)]


def test_telemetry_off_replays_the_fingerprint_without_frames():
    eng = StreamingEngine(EngineConfig(**REF["cfg"], telemetry=False),
                          "bfs", device="cpu")
    eng.seed(0, 0.0)
    rows = []
    for e in make_stream(StreamSpec(**REF["spec"])):
        r = eng.run_increment(e, max_cycles=500_000)
        assert r.frames is None
        rows.append(dict(cycles=r.cycles, hops=r.hops, execs=r.execs,
                         stalls=r.stalls, allocs=r.allocs))
    assert rows == REF["backends"]["jnp"]["increments"]
    np.testing.assert_array_equal(eng.values(128),
                                  np.float32(REF["backends"]["jnp"]["values"]))
