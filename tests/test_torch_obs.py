"""The port's copies of ``repro.obs`` (``frames.FrameLog``, ``flight``,
``export``, ``metrics``) held equal to the originals on the same frame
logs, and the exporters of a port run equal to those of the JAX engine's
run of the same stream: ``FrameLog`` reductions (``totals``, ``last``,
``deltas`` with and without dropped frames, ``from_rings``), the wedge
analysis and its report, ``chrome_trace``, ``congestion_heatmap`` and
``engine_rates``; and ``bench_engine``'s ci heatmap against the
committed ``results/profile/heatmap_jnp.json``, every field but
``cycles``, which the live JAX engine gives as 208 (the file's 464 comes
from an older version of the JAX frame code).
"""
import json
import pathlib

import numpy as np
import pytest
import torch

from repro.core import EngineConfig as JConfig
from repro.core import StreamingEngine as JEngine
from repro.graph.streams import hub_edges
from repro.obs import FrameLog as JFrameLog
from repro.obs import chrome_trace as j_chrome_trace
from repro.obs import congestion_heatmap as j_congestion_heatmap
from repro.obs import engine_rates as j_engine_rates
from repro.obs import render_wedge_report as j_render_wedge_report
from repro.obs import wedged_cells as j_wedged_cells
from repro.obs import wedged_lanes as j_wedged_lanes
from repro.obs.export import STAGE_NAMES as J_STAGE_NAMES
from repro.obs.flight import WEDGE_WINDOW as J_WEDGE_WINDOW
from repro_torch.core import EngineConfig, StreamingEngine
from repro_torch.graph.streams import StreamSpec, make_stream
from repro_torch.launch import paper_experiments as pe
from repro_torch.obs import (FrameLog, chrome_trace, congestion_heatmap,
                             engine_rates, init_ring, render_wedge_report,
                             ring_store, wedged_cells, wedged_lanes,
                             write_chrome_trace, write_heatmap)
from repro_torch.obs.export import STAGE_NAMES
from repro_torch.obs.flight import WEDGE_WINDOW

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF = json.loads((ROOT / "tests" / "data"
                  / "pre_lanes_reference.json").read_text())
ONE = np.float32(1.0).view(np.int32)
FIELDS = ("cell", "lane", "hiw", "aq_n", "pk_n", "ch_n", "scal")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_logs():
    """JAX frame logs: the pinned stream's increments at ``frame_ring`` 16
    and 2 (the ring wraps), and the hub livelock's."""
    logs = []
    for ring in (16, 2):
        eng = JEngine(JConfig(**REF["cfg"], telemetry=True,
                              frame_ring=ring), "bfs")
        eng.seed(0, 0.0)
        for e in make_stream(StreamSpec(**REF["spec"])):
            logs.append((eng.cfg, eng.run_increment(e).frames))
    cfg = JConfig(height=8, width=8, n_vertices=128, edge_cap=4,
                  ghost_slots=48, queue_cap=20, chan_cap=16, futq_cap=4,
                  io_stream_cap=2048, chunk=64, lanes=1, telemetry=True,
                  frame_ring=16)
    eng = JEngine(cfg, "bfs")
    eng.seed(0, 0.0)
    e = hub_edges(128, 0, 200, seed=3)
    try:
        eng.run_increment(np.concatenate(
            [e, np.full((len(e), 1), ONE, np.int64)], 1).astype(np.int32))
    except RuntimeError as err:
        logs.append((cfg, err.frames))
    assert len(logs) == 7 and any(f.dropped for _, f in logs)
    return logs


def port_log(jlog) -> FrameLog:
    return FrameLog(**{k: getattr(jlog, k).copy() for k in FIELDS},
                    dropped=jlog.dropped)


def port_cfg(jcfg) -> EngineConfig:
    return EngineConfig(**{k: getattr(jcfg, k)
                           for k in EngineConfig.__dataclass_fields__})


def same(a, b):
    """Equal nested dicts / lists / arrays / scalars."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            same(x, y)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b and type(a) is type(b), (a, b)


def test_constants_equal_the_originals():
    assert STAGE_NAMES == J_STAGE_NAMES and WEDGE_WINDOW == J_WEDGE_WINDOW


def test_framelog_reductions_equal_the_original(jax_logs):
    for _, jlog in jax_logs:
        log = port_log(jlog)
        assert len(log) == len(jlog)
        same(log.totals(), jlog.totals())
        same(log.last(), jlog.last())
        same(log.deltas(), jlog.deltas())


def test_from_rings_equals_the_original(jax_logs):
    """Rings of the port (written by ``ring_store``, read back with
    ``host``) and the JAX engine's unroll to the same log, wrapped or
    not."""
    jcfg, jlog = jax_logs[1]
    for F in (2, 3, 16):
        cfg = port_cfg(jcfg)
        cfg = EngineConfig(**{**cfg.__dict__, "frame_ring": F})
        ring = init_ring(cfg, "cpu")
        for i in range(len(jlog)):
            ring = ring_store(ring, torch.cat([
                torch.from_numpy(getattr(jlog, k)[i]).reshape(-1)
                for k in FIELDS]))
        log = FrameLog.from_rings([ring.host()])
        want = JFrameLog.from_rings([type("R", (), dict(
            n=ring.n, **{k: getattr(ring, k).numpy() for k in FIELDS}))])
        assert log.dropped == want.dropped == max(0, len(jlog) - F)
        for k in FIELDS:
            np.testing.assert_array_equal(getattr(log, k), getattr(want, k))


def test_flight_recorder_equals_the_original(jax_logs):
    for jcfg, jlog in jax_logs:
        cfg, log = port_cfg(jcfg), port_log(jlog)
        same(wedged_cells(cfg, log), j_wedged_cells(jcfg, jlog))
        same(wedged_lanes(cfg, log), j_wedged_lanes(jcfg, jlog))
        assert render_wedge_report(cfg, log) == \
            j_render_wedge_report(jcfg, jlog)
    assert wedged_cells(cfg, log)        # the hub livelock's


def test_exporters_and_rates_equal_the_originals(jax_logs, tmp_path):
    for jcfg, jlog in jax_logs:
        cfg, log = port_cfg(jcfg), port_log(jlog)
        same(chrome_trace(cfg, log), j_chrome_trace(jcfg, jlog))
        same(congestion_heatmap(cfg, log), j_congestion_heatmap(jcfg, jlog))
        same(engine_rates(log), j_engine_rates(jlog))
    p = write_heatmap(tmp_path / "h" / "heat.json", cfg, log)
    assert json.loads(pathlib.Path(p).read_text()) == \
        json.loads(json.dumps(j_congestion_heatmap(jcfg, jlog)))
    p = write_chrome_trace(tmp_path / "trace.json", cfg, log)
    assert json.loads(pathlib.Path(p).read_text())["traceEvents"]


def test_a_port_run_exports_what_the_jax_run_does():
    """The pinned stream's first increment through both engines: the
    trace, the heatmap and the rates of their frame logs are equal."""
    kw = dict(REF["cfg"], telemetry=True, frame_ring=16)
    e = make_stream(StreamSpec(**REF["spec"]))[0]
    eng = StreamingEngine(EngineConfig(**kw), "bfs", device="cpu")
    jeng = JEngine(JConfig(**kw), "bfs")
    eng.seed(0, 0.0)
    jeng.seed(0, 0.0)
    log, jlog = eng.run_increment(e).frames, jeng.run_increment(e).frames
    same(chrome_trace(eng.cfg, log), j_chrome_trace(jeng.cfg, jlog))
    same(congestion_heatmap(eng.cfg, log),
         j_congestion_heatmap(jeng.cfg, jlog))
    same(engine_rates(log), j_engine_rates(jlog))


def test_bench_engine_profile_matches_the_committed_heatmap(tmp_path):
    """``bench_engine("ci", profile=True)`` on the CPU: the heatmap equals
    ``results/profile/heatmap_jnp.json`` in every field but ``cycles``
    (208, the live JAX engine's), the frame totals reconcile with the
    plain run's counters, and the dumps land where the caller says."""
    out = pe.bench_engine("ci", device="cpu", profile=True,
                          profile_dir=tmp_path)
    prof = out["profile"]
    heat = json.loads(pathlib.Path(prof["heatmap"]).read_text())
    want = json.loads((ROOT / "results" / "profile"
                       / "heatmap_jnp.json").read_text())
    assert heat["cycles"] == 208 and want["cycles"] == 464
    assert {k: v for k, v in heat.items() if k != "cycles"} == \
        {k: v for k, v in want.items() if k != "cycles"}
    assert prof["frames"] == 5 and prof["dropped"] == 0
    assert prof["rates"]["cycles"] == out["cycles"] == 208
    assert pathlib.Path(prof["trace"]).parent == tmp_path
