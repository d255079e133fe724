"""The livelock error of the port equals the JAX engine's, text and all,
on ``bench_lanes``' ci ``lanes=1`` row (``benchmarks/paper_experiments.py``:
8x8, 256 vertices, R-MAT, seed 2, queue_cap 48, chan_cap 32), which
livelocks in increment 2 at cycle 4,608, with telemetry on: the port
continues from the JAX engine's state after increment 1 (carried over by
``state_from_numpy``) and raises at the same cycle and chunk with the same
message and wedge report.
"""
import numpy as np
import pytest
import torch

from repro.core import EngineConfig as JConfig
from repro.core import StreamingEngine as JEngine
from repro.core.engine import LivelockError as JLivelockError
from repro.graph.streams import StreamSpec, make_stream
from repro_torch.core import EngineConfig, LivelockError, StreamingEngine
from repro_torch.core.state import state_from_numpy

SKEW_CI_LANES1 = dict(height=8, width=8, n_vertices=256, edge_cap=8,
                      ghost_slots=64, queue_cap=48, chan_cap=32, futq_cap=8,
                      io_stream_cap=2 ** 20, chunk=512, lanes=1,
                      telemetry=True)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_ci_skew_lanes1_livelock_message_equals_jax():
    incs = make_stream(StreamSpec(n_vertices=256, n_edges=4096,
                                  increments=4, kind="rmat", seed=2))
    jeng = JEngine(JConfig(**SKEW_CI_LANES1), "bfs")
    jeng.seed(0, 0.0)
    for e in incs[:2]:
        jeng.run_increment(e, max_cycles=4_000_000)
    eng = StreamingEngine(EngineConfig(**SKEW_CI_LANES1), "bfs",
                          device="cpu")
    eng.state = state_from_numpy(eng.cfg, {
        k: np.asarray(v) for k, v in jeng.state._asdict().items()},
        device="cpu")
    with pytest.raises(JLivelockError) as jei:
        jeng.run_increment(incs[2], max_cycles=4_000_000)
    with pytest.raises(LivelockError) as ei:
        eng.run_increment(incs[2], max_cycles=4_000_000)
    err, jerr = ei.value, jei.value
    assert (err.cycle, err.chunk) == (jerr.cycle, jerr.chunk) == (4608, 9)
    assert str(err) == str(jerr)
    assert "flight recorder" in str(err)
