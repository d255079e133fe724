"""Kill-and-resume across the packages on the CPU (DESIGN §9): the hub
stream of ``tests/test_resilience.py`` (``_hub_stream``, ``_cfg``: 8x8,
lanes=2, telemetry on) in three increments, checkpointed (async) before
the first two and at the boundary after them; the engine dropped; a new
one restored from that checkpoint replays the last increment.  Every
leaf, the totals and ``total_cycles`` must equal the JAX engine's
uninterrupted run, whichever package wrote the checkpoint and whichever
restored it.
"""
import numpy as np
import pytest

from repro.core import EngineConfig as JConfig
from repro.core import StreamingEngine as JEngine
from repro.train.checkpoint import Checkpointer as JCheckpointer
from repro_torch.core import EngineConfig, StreamingEngine
from repro_torch.core.state import state_to_numpy
from repro_torch.launch.paper_experiments import hub_stream
from repro_torch.train import Checkpointer

from test_torch_faults_chunks import one_torch_thread  # noqa: F401

KW = dict(height=8, width=8, n_vertices=256, edge_cap=8, ghost_slots=24,
          queue_cap=32, chan_cap=16, chunk=64, lanes=2, max_cycles=200_000,
          telemetry=True)
SPLITS = ((0, 100), (100, 200), (200, None))


def _incs():
    e = hub_stream()
    return [e[lo:hi] for lo, hi in SPLITS]


def _boundary(eng, ck):
    """Run the first two increments with an async checkpoint before each,
    then publish the boundary after them (step 2)."""
    for e in _incs()[:2]:
        eng.run_increment(e, ckpt=ck)
    eng.checkpoint(ck)
    ck.wait()


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX engine's checkpoint at the boundary, and its uninterrupted
    run's final state, totals and cycles."""
    d = tmp_path_factory.mktemp("jax_ckpt")
    eng = JEngine(JConfig(**KW), "bfs")
    eng.seed(0, 0.0)
    _boundary(eng, JCheckpointer(d))
    eng.run_increment(_incs()[2])
    return d, ({k: np.asarray(v) for k, v in eng.state._asdict().items()},
               dict(eng.totals), eng.total_cycles)


@pytest.fixture(scope="module")
def port_ckpt(tmp_path_factory):
    d = tmp_path_factory.mktemp("port_ckpt")
    eng = StreamingEngine(EngineConfig(**KW), "bfs", device="cpu")
    eng.seed(0, 0.0)
    _boundary(eng, Checkpointer(d))
    return d


def _resume(writer, reader, jax_run, port_ckpt):
    d = jax_run[0] if writer == "jax" else port_ckpt
    if reader == "port":
        eng = StreamingEngine.restore(EngineConfig(**KW), "bfs",
                                      Checkpointer(d), device="cpu")
        assert eng.stream_pos == 2
        eng.run_increment(_incs()[2])
        return state_to_numpy(eng.state), eng.totals, eng.total_cycles
    eng = JEngine.restore(JConfig(**KW), "bfs", JCheckpointer(d))
    assert eng.stream_pos == 2
    eng.run_increment(_incs()[2])
    return ({k: np.asarray(v) for k, v in eng.state._asdict().items()},
            eng.totals, eng.total_cycles)


@pytest.mark.parametrize("writer,reader", [
    ("port", "port"), ("jax", "port"), ("port", "jax")],
    ids=["port-to-port", "jax-to-port", "port-to-jax"])
def test_kill_and_resume_bit_exact(writer, reader, jax_run, port_ckpt):
    got, totals, cycles = _resume(writer, reader, jax_run, port_ckpt)
    want, want_totals, want_cycles = jax_run[1]
    assert (totals, cycles) == (want_totals, want_cycles)
    for k, v in want.items():
        a, b = got[k], v
        if a.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        np.testing.assert_array_equal(
            a, b, err_msg=f"state leaf '{k}' diverged across {writer} -> "
                          f"{reader} kill-and-resume")
