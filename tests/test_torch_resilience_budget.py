"""Recovery that runs out of budget, and the ``n_io_cells`` knob, against
the live JAX engine on the CPU (DESIGN §9): a policy that relieves nothing
(``RecoveryPolicy(max_attempts=1, lanes_step=0)``) on the lanes=1 hub
wedge of ``tests/test_resilience.py`` wedges twice and re-raises with the
attempt log, the same log and message as the JAX engine's, and leaves
``total_cycles`` and ``totals`` untouched; ``n_io_cells`` other than the
width, which the port refuses, fails in the JAX engine's ``io_stage``.
"""
import numpy as np
import pytest

from repro.core import EngineConfig as JConfig
from repro.core import StreamingEngine as JEngine
from repro.core.engine import LivelockError as JLivelockError
from repro.resilience import RecoveryPolicy as JPolicy
from repro_torch.core import LivelockError, StreamingEngine
from repro_torch.launch.paper_experiments import hub_stream, wedge_config
from repro_torch.resilience import RecoveryPolicy

from test_torch_faults_chunks import one_torch_thread  # noqa: F401

WEDGE_KW = dict(height=8, width=8, n_vertices=128, edge_cap=4,
                ghost_slots=48, queue_cap=20, chan_cap=16, futq_cap=4,
                chunk=64, lanes=1, max_cycles=200_000, telemetry=True)


def test_recovery_budget_exhausted_reraises_like_jax():
    edges = hub_stream(128, 200)
    policy = dict(max_attempts=1, lanes_step=0, queue_cap_step=0)
    jeng = JEngine(JConfig(**WEDGE_KW), "bfs")
    jeng.seed(0, 0.0)
    with pytest.raises(JLivelockError) as jerr:
        jeng.run_increment(edges, recover=JPolicy(**policy))
    eng = StreamingEngine(wedge_config(), "bfs", device="cpu")
    eng.seed(0, 0.0)
    with pytest.raises(LivelockError,
                       match="recovery budget exhausted") as err:
        eng.run_increment(edges, recover=RecoveryPolicy(**policy))
    assert [e["attempt"] for e in eng.recovery_log] == [0, 1]
    assert eng.recovery_log == jeng.recovery_log
    assert str(err.value) == str(jerr.value)
    assert (err.value.cycle, err.value.chunk) == (jerr.value.cycle,
                                                  jerr.value.chunk)
    assert len(err.value.frames) == len(jerr.value.frames)
    # a failed attempt counts nowhere; the stream did not advance
    assert (eng.total_cycles, eng.stream_pos) == (0, 0)
    assert eng.totals == dict(hops=0, execs=0, stalls=0, allocs=0)
    assert eng.cfg.lanes == 1


@pytest.mark.parametrize("n_io", [4, 12])
def test_jax_engine_fails_on_n_io_cells_off_the_width(n_io):
    """The reference has no behaviour to port here: its ``io_stage``
    delivers ``[n_io_cells]``-shaped messages into the ``[width]``-shaped
    row-0 queues and fails on the first chunk; the port refuses the knob
    in ``validate`` instead (``tests/test_torch_resilience.py``)."""
    cfg = JConfig(height=8, width=8, n_vertices=256, edge_cap=8,
                  ghost_slots=24, queue_cap=32, chan_cap=16, chunk=64,
                  lanes=2, max_cycles=200_000, n_io_cells=n_io)
    eng = JEngine(cfg, "bfs")
    eng.seed(0, 0.0)
    with pytest.raises(TypeError, match="incompatible shapes"):
        eng.run_increment(hub_stream()[:64])
    with pytest.raises(NotImplementedError, match="n_io_cells"):
        wedge_config(n_io_cells=n_io, lanes=2).validate()
    assert np.asarray(eng.state.io_n).shape == (n_io,)
