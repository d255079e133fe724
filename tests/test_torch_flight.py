"""The livelock flight recorder of the port on the CPU against the JAX
engine's, on the 8x8 hub stream of ``tests/test_obs.py`` at ``lanes=1``
(the §4.2 hub deadlock): ``LivelockError`` at the same cycle (704) and
chunk (11) on both drivers, its frame log equal frame by frame, the same
wedged cells and lanes, and ``str(err)`` the same text (the JAX engine's
sizing advice, lane advice included, then the wedge report) with
telemetry on; with it off, the same text and ``frames`` None.
"""
import numpy as np
import pytest
import torch

from repro.core import EngineConfig as JConfig
from repro.core import StreamingEngine as JEngine
from repro.core.engine import LivelockError as JLivelockError
from repro.graph.streams import hub_edges
from repro.obs import wedged_cells as j_wedged_cells
from repro.obs import wedged_lanes as j_wedged_lanes
from repro_torch.core import EngineConfig, LivelockError, StreamingEngine
from repro_torch.obs import FrameLog, wedged_cells, wedged_lanes

ONE = np.float32(1.0).view(np.int32)
HUB_KW = dict(height=8, width=8, n_vertices=128, edge_cap=4, ghost_slots=48,
              queue_cap=20, chan_cap=16, futq_cap=4, io_stream_cap=2048,
              chunk=64, lanes=1)          # tests/test_obs.py::_hub_cfg
FIELDS = ("cell", "lane", "hiw", "aq_n", "pk_n", "ch_n", "scal")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def hub_stream(n=128, degree=200, seed=3):
    e = hub_edges(n, 0, degree, seed=seed)
    return np.concatenate([e, np.full((len(e), 1), ONE, np.int64)],
                          1).astype(np.int32)


def livelocks(kw, traced):
    """The hub stream through both engines: ``(port error, JAX error,
    port config)``."""
    eng = StreamingEngine(EngineConfig(**kw), "bfs", device="cpu")
    jeng = JEngine(JConfig(**kw), "bfs")
    errs = []
    for e, exc in ((eng, LivelockError), (jeng, JLivelockError)):
        e.seed(0, 0.0)
        with pytest.raises(exc) as ei:
            e.run_increment(hub_stream(), max_cycles=500_000,
                            collect_traces=traced)
        errs.append(ei.value)
    return errs[0], errs[1], eng.cfg


@pytest.mark.parametrize("traced", [False, True], ids=["device", "traced"])
def test_hub_livelock_report_equals_jax(traced):
    err, jerr, cfg = livelocks(dict(HUB_KW, telemetry=True, frame_ring=16),
                               traced)
    assert isinstance(err, RuntimeError) and "livelock" in str(err)
    assert (err.cycle, err.chunk) == (jerr.cycle, jerr.chunk) == (704, 11)
    assert isinstance(err.frames, FrameLog)
    assert (len(err.frames), err.frames.dropped) == \
        (len(jerr.frames), jerr.frames.dropped) == (12, 0)
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(err.frames, k),
                                      getattr(jerr.frames, k), err_msg=k)
    cells = wedged_cells(cfg, err.frames)
    assert cells == j_wedged_cells(cfg, jerr.frames)
    assert wedged_lanes(cfg, err.frames) == j_wedged_lanes(cfg, jerr.frames)
    assert len(cells) == 8 and (0, 0) in [d["cell"] for d in cells]
    assert str(err) == str(jerr)
    assert str(err).splitlines()[1].startswith(
        "flight recorder: trailing 9 of 12 frames (512 cycles) — 8 wedged "
        "cell(s), 7 wedged lane(s)")


def test_hub_livelock_without_telemetry_equals_jax():
    err, jerr, _ = livelocks(HUB_KW, False)
    assert err.frames is None and jerr.frames is None
    assert (err.cycle, err.chunk) == (jerr.cycle, jerr.chunk)
    assert str(err) == str(jerr)
    assert "Enable virtual lanes (lanes>=2, currently 1)" in str(err)
