"""Engine parity on the CPU: the port's ``StreamingEngine(device="cpu")``
replays the JAX engine's pinned BFS fingerprint exactly, and detects a
livelock at the same cycle and chunk as the JAX engine, in the same
state.
"""
import json
import pathlib

import numpy as np
import pytest
import torch

from repro.core import EngineConfig as JConfig
from repro.core import StreamingEngine as JEngine
from repro.core.engine import LivelockError as JLivelockError
from repro_torch.core import EngineConfig, LivelockError, StreamingEngine
from repro_torch.core.state import state_to_numpy
from repro_torch.graph.streams import StreamSpec, make_stream

PINNED = json.loads((pathlib.Path(__file__).parent / "data"
                     / "pre_lanes_reference.json").read_text())


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain version runs thousands of tiny ops per cycle: one
    intra-op thread is faster, and leaves the cores to the other test
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_pinned_fingerprint_replayed():
    """Per-increment cycles, hops, execs, stalls, allocs and all 128
    BFS values of ``tests/data/pre_lanes_reference.json``."""
    eng = StreamingEngine(EngineConfig(**PINNED["cfg"]), "bfs", device="cpu")
    eng.seed(0, 0.0)
    rows = []
    for e in make_stream(StreamSpec(**PINNED["spec"])):
        r = eng.run_increment(e, max_cycles=500_000)
        rows.append(dict(cycles=r.cycles, hops=r.hops, execs=r.execs,
                         stalls=r.stalls, allocs=r.allocs))
    want = PINNED["backends"]["jnp"]
    assert rows == want["increments"]
    assert eng.total_cycles == want["total_cycles"]
    np.testing.assert_array_equal(eng.values(128),
                                  np.float32(want["values"]))


def test_livelock_parity_with_jax():
    """The undersized buffers of ``tests/test_cycle_kernel.py``'s livelock
    test: both engines raise at the same cycle and chunk, and hold the
    same state when they do."""
    kw = dict(height=8, width=8, n_vertices=64, edge_cap=2, ghost_slots=48,
              queue_cap=8, chan_cap=2, futq_cap=2, io_stream_cap=2048,
              chunk=64)
    incs = make_stream(StreamSpec(n_vertices=64, n_edges=400, increments=2,
                                  seed=21))
    jeng = JEngine(JConfig(**kw), "bfs")
    jeng.seed(0, 0.0)
    with pytest.raises(JLivelockError) as jerr:
        for e in incs:
            jeng.run_increment(e, max_cycles=500_000)
    eng = StreamingEngine(EngineConfig(**kw), "bfs", device="cpu")
    eng.seed(0, 0.0)
    with pytest.raises(LivelockError, match="livelock") as err:
        for e in incs:
            eng.run_increment(e, max_cycles=500_000)
    assert (err.value.cycle, err.value.chunk) == \
        (jerr.value.cycle, jerr.value.chunk)
    assert eng.stream_pos == jeng.stream_pos == 1
    got = state_to_numpy(eng.state)
    for k, v in jeng.state._asdict().items():
        a, b = got[k], np.asarray(v)
        if a.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        np.testing.assert_array_equal(a, b, err_msg=k)
