"""The skew and lanes benchmarks of ``repro_torch.launch.paper_experiments``
on the CPU: at a tiny scale ``bench_skew`` and ``bench_lanes`` give the
rows of the JAX package's ``benchmarks/paper_experiments.py`` on the same
R-MAT stream and configs, and the row runner beneath them reports a
livelock as the JAX engine raises it.
"""
import json
import pathlib

import pytest
import torch

from repro.core import EngineConfig as JConfig
from repro.core import StreamingEngine as JEngine
from repro.core.engine import LivelockError as JLivelockError
from repro_torch.core import EngineConfig
from repro_torch.graph.streams import StreamSpec, make_stream
from repro_torch.launch import paper_experiments as pe

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain version runs thousands of tiny ops per cycle: one
    intra-op thread is faster, and leaves the cores to the other test
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SKEW_TINY = dict(height=4, width=4, n_vertices=32, n_edges=128)


@pytest.fixture
def jax_skew(monkeypatch):
    """The JAX package's experiment module with the tiny skew scale."""
    monkeypatch.syspath_prepend(str(ROOT))
    import benchmarks.paper_experiments as jpe
    monkeypatch.setitem(jpe.SKEW_SCALES, "tiny", SKEW_TINY)
    return jpe


def test_bench_skew_rows_equal_jax(jax_skew):
    """A serial-chain row and a rhizome row of ``bench_skew`` on a tiny
    R-MAT stream: every key of each row (cycles, hops, stalls, degrees,
    rhizome and ghost counts) equal to the JAX package's."""
    want = jax_skew.bench_skew("tiny", rhizome_caps=(1, 2))
    got = pe.bench_skew(SKEW_TINY, rhizome_caps=(1, 2), device="cpu")
    assert got == want
    assert got[1]["rhizomes"] > 0


def test_bench_lanes_rows_equal_jax(jax_skew, tmp_path):
    """A ``lanes=2`` row of ``bench_lanes`` and its oversized-queue
    ``lanes=1`` baseline: statuses, cycles and stalls equal to the JAX
    package's; the port writes its JSON only where it is told to."""
    want = jax_skew.bench_lanes("tiny", lanes_list=(2,),
                                out_json=str(tmp_path / "jax.json"))
    out = tmp_path / "build" / "lanes.json"
    got = pe.bench_lanes(SKEW_TINY, lanes_list=(2,), out_json=str(out),
                         device="cpu")
    assert got == want
    assert [r["status"] for r in got[0]] + [got[1]["status"]] == ["ok"] * 2
    assert json.loads(out.read_text())[f"lanes_{SKEW_TINY}"]["rows"] == \
        got[0]


def test_skew_row_reports_a_livelock_as_jax_raises_it(monkeypatch):
    """The row runner beneath both benchmarks turns ``LivelockError`` into
    a ``livelock`` row with the increment, cycle, chunk and counters at
    which the JAX engine raises on the same config and stream (the
    undersized buffers of ``tests/test_torch_engine.py``)."""
    kw = dict(height=8, width=8, n_vertices=64, edge_cap=2, ghost_slots=48,
              queue_cap=8, chan_cap=2, futq_cap=2, io_stream_cap=2048,
              chunk=64)
    incs = tuple(make_stream(StreamSpec(n_vertices=64, n_edges=400,
                                        increments=2, seed=21)))
    monkeypatch.setattr(pe, "skew_config", lambda *a: EngineConfig(**kw))
    monkeypatch.setattr(pe, "skew_increments", lambda scale: incs)
    row, _ = pe.skew_row("ci", device="cpu")
    jeng = JEngine(JConfig(**kw), "bfs")
    jeng.seed(0, 0.0)
    done = []
    with pytest.raises(JLivelockError) as err:
        for e in incs:
            done.append(jeng.run_increment(e, max_cycles=pe.SKEW_MAX_CYCLES))
    st = jeng.state
    assert row["status"] == "livelock"
    assert row["livelock"] == dict(
        increment=len(done), cycle=err.value.cycle, chunk=err.value.chunk,
        hops=int(st.stat_hops), execs=int(st.stat_exec),
        stalls=int(st.stat_stall), allocs=int(st.stat_allocs))
    assert [r["cycles"] for r in row["increments"]] == \
        [r.cycles for r in done]
