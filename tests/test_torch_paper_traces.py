"""Per-cycle activity traces on the CPU: the port's
``run_increment(collect_traces=True)`` equals the JAX engine's traced host
loop cycle by cycle (active cells, messages in flight) for every app,
gives the same totals and state as the untraced run, and detects a
livelock at the same cycle and chunk; the plain chunk's trace rows are
``cycle_step``'s stats, and the wrapper checks the trace tensor.
"""
import numpy as np
import pytest
import torch

from repro.core import EngineConfig as JConfig
from repro.core import StreamingEngine as JEngine
from repro.core.engine import LivelockError as JLivelockError
from repro_torch.core import (APPS, EngineConfig, LivelockError,
                              StreamingEngine, cycle_step)
from repro_torch.core.ingest import load_stream
from repro_torch.core.state import state_to_numpy
from repro_torch.graph.streams import StreamSpec, make_stream
from repro_torch.kernels.cca_cycle import ops
from repro_torch.kernels.cca_cycle.ref import frozen_cycles

# tests/test_cycle_kernel.py's small_cfg and the stream of its
# test_collect_traces_equivalence
SMALL = dict(height=8, width=8, n_vertices=128, edge_cap=4, ghost_slots=32,
             queue_cap=32, chan_cap=8, futq_cap=8, io_stream_cap=2048,
             chunk=64)
SPEC = dict(n_vertices=128, n_edges=768, increments=3, seed=11)
LIVELOCK = dict(height=8, width=8, n_vertices=64, edge_cap=2, ghost_slots=48,
                queue_cap=8, chan_cap=2, futq_cap=2, io_stream_cap=2048,
                chunk=64)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain version runs thousands of tiny ops per cycle: one
    intra-op thread is faster, and leaves the cores to the other test
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def seeded(eng, app):
    if app == "cc":
        for v in range(eng.cfg.n_vertices):   # every vertex its own label
            eng.seed(v, float(v))
    elif app != "ingest_only":
        eng.seed(0, 0.0)
    return eng


def assert_same_state(got, jst):
    got = state_to_numpy(got)
    for k, v in jst._asdict().items():
        a, b = got[k], np.asarray(v)
        if a.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        np.testing.assert_array_equal(a, b, err_msg=k)


def totals(r):
    return (r.cycles, r.hops, r.execs, r.stalls, r.allocs)


@pytest.mark.parametrize("app", ["bfs", "sssp", "cc", "ingest_only"])
def test_traces_match_jax_cycle_by_cycle(app):
    incs = make_stream(StreamSpec(**SPEC))
    jeng = seeded(JEngine(JConfig(**SMALL), app), app)
    eng = seeded(StreamingEngine(EngineConfig(**SMALL), app, device="cpu"),
                 app)
    for i, e in enumerate(incs):
        jr = jeng.run_increment(e, max_cycles=500_000, collect_traces=True)
        r = eng.run_increment(e, max_cycles=500_000, collect_traces=True)
        assert totals(r) == totals(jr), i
        assert len(r.active_per_cycle) == r.cycles
        for name in ("active_per_cycle", "in_flight_per_cycle"):
            got, want = getattr(r, name), np.asarray(getattr(jr, name))
            assert got.dtype == np.int32
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"{name}, increment {i}")
    assert_same_state(eng.state, jeng.state)
    np.testing.assert_array_equal(eng.values(), jeng.values())


def test_traces_match_jax_when_a_chunk_ends_quiescent():
    """An increment that reaches quiescence on a chunk's last cycle: JAX
    runs one more chunk that freezes at once; the port runs none and
    counts the same."""
    incs = make_stream(StreamSpec(**SPEC))
    probe = seeded(StreamingEngine(EngineConfig(**SMALL), "bfs",
                                   device="cpu"), "bfs")
    first = probe.run_increment(incs[0], max_cycles=500_000).cycles
    kw = dict(SMALL, chunk=first)
    jeng = seeded(JEngine(JConfig(**kw), "bfs"), "bfs")
    eng = seeded(StreamingEngine(EngineConfig(**kw), "bfs", device="cpu"),
                 "bfs")
    launches = ops.launches
    for e in incs[:2]:
        jr = jeng.run_increment(e, max_cycles=500_000, collect_traces=True)
        r = eng.run_increment(e, max_cycles=500_000, collect_traces=True)
        assert totals(r) == totals(jr)
        np.testing.assert_array_equal(r.active_per_cycle,
                                      np.asarray(jr.active_per_cycle))
        np.testing.assert_array_equal(r.in_flight_per_cycle,
                                      np.asarray(jr.in_flight_per_cycle))
    assert ops.launches == launches     # the CPU launches no kernel
    assert_same_state(eng.state, jeng.state)


def test_traced_and_untraced_give_equal_totals_and_states():
    incs = make_stream(StreamSpec(**SPEC))
    runs = {}
    for traced in (False, True):
        eng = seeded(StreamingEngine(EngineConfig(**SMALL), "bfs",
                                     device="cpu"), "bfs")
        rs = [eng.run_increment(e, max_cycles=500_000,
                                collect_traces=traced) for e in incs]
        runs[traced] = (eng, rs)
    (fast, rf), (slow, rt) = runs[False], runs[True]
    for a, b in zip(rf, rt):
        assert totals(a) == totals(b)
        assert a.active_per_cycle.shape == a.in_flight_per_cycle.shape == (0,)
        assert a.active_per_cycle.dtype == np.int32
        assert len(b.active_per_cycle) == len(b.in_flight_per_cycle) \
            == b.cycles
        assert a.frames is None and b.frames is None
    assert fast.totals == slow.totals
    assert fast.total_cycles == slow.total_cycles
    for k in fast.state._fields:
        assert torch.equal(getattr(fast.state, k), getattr(slow.state, k)), k


def test_traced_livelock_raises_where_jax_does():
    incs = make_stream(StreamSpec(n_vertices=64, n_edges=400, increments=2,
                                  seed=21))
    jeng = seeded(JEngine(JConfig(**LIVELOCK), "bfs"), "bfs")
    with pytest.raises(JLivelockError) as jerr:
        for e in incs:
            jeng.run_increment(e, max_cycles=500_000, collect_traces=True)
    eng = seeded(StreamingEngine(EngineConfig(**LIVELOCK), "bfs",
                                 device="cpu"), "bfs")
    with pytest.raises(LivelockError, match="livelock") as err:
        for e in incs:
            eng.run_increment(e, max_cycles=500_000, collect_traces=True)
    assert (err.value.cycle, err.value.chunk) == \
        (jerr.value.cycle, jerr.value.chunk)
    assert eng.stream_pos == jeng.stream_pos
    assert_same_state(eng.state, jeng.state)


@pytest.fixture(scope="module")
def mid_stream():
    """``(engine, state)`` of each app, its second increment loaded onto
    the state after the first ran to quiescence (made once a module)."""
    made = {}

    def get(app="bfs"):
        if app not in made:
            eng = seeded(StreamingEngine(EngineConfig(**SMALL), app,
                                         device="cpu"), app)
            incs = make_stream(StreamSpec(**SPEC))
            eng.run_increment(incs[0], max_cycles=500_000)
            st, spill = load_stream(eng.cfg, eng.state, incs[1])
            assert len(spill) == 0
            made[app] = (eng, st)
        return made[app]
    return get


@pytest.mark.parametrize("app", ["bfs", "ingest_only"])
def test_frozen_cycles_trace_rows_are_cycle_step_stats(app, mid_stream):
    eng, st = mid_stream(app)
    n = 40
    got_st, q, ran, rows = frozen_cycles(eng.cfg, eng.app, st, n, trace=True)
    assert (ran, q) == (n, False)
    assert rows.dtype == torch.int32 and rows.shape == (n, 2)
    s = st
    for t in range(n):
        s, stats = cycle_step(eng.cfg, eng.app, s)
        assert rows[t].tolist() == [int(stats.active), int(stats.in_flight)]
        assert not bool(stats.quiescent)
    for k in st._fields:
        assert torch.equal(getattr(s, k), getattr(got_st, k)), k
    # the untraced call returns the same state and no rows
    plain = frozen_cycles(eng.cfg, eng.app, st, n)
    assert len(plain) == 3 and plain[2] == n
    assert torch.equal(plain[0].vals, got_st.vals)


def test_wrapper_fills_the_trace_rows_it_ran(mid_stream):
    eng, st = mid_stream()
    # run to quiescence in one long chunk: rows past the last cycle stay
    trace = torch.full((5000, 2), -7, dtype=torch.int32)
    st2, qr = ops.cca_cycle_chunk(eng.cfg, eng.app, st, 5000, trace=trace)
    q, ran = qr.tolist()
    assert q == 1 and 0 < ran < 5000
    _, _, ran2, rows = frozen_cycles(eng.cfg, eng.app, st, 5000, trace=True)
    assert ran2 == ran
    assert torch.equal(trace[:ran], rows)
    assert (trace[ran:] == -7).all()
    # the last row is the quiescent state's: nothing in flight
    assert int(trace[ran - 1, 1]) == 0


@pytest.mark.parametrize("bad", ["dtype", "shape", "rows", "strided",
                                 "device"])
def test_wrapper_checks_the_trace_tensor(bad, mid_stream):
    eng, st = mid_stream()
    n = 8
    trace = {"dtype": torch.zeros((n, 2), dtype=torch.int64),
             "shape": torch.zeros((n, 3), dtype=torch.int32),
             "rows": torch.zeros((n + 1, 2), dtype=torch.int32),
             "strided": torch.zeros((2, n), dtype=torch.int32).t(),
             "device": torch.zeros((n, 2), dtype=torch.int32,
                                   device="meta")}[bad]
    with pytest.raises(ValueError, match="trace"):
        ops.cca_cycle_chunk(eng.cfg, eng.app, st, n, trace=trace)


def test_apps_table_holds_the_four_ported_apps():
    """The four min-monotone apps keep their kernel codes; the
    max-monotone widest and reliable follow them."""
    assert {k: a.code for k, a in APPS.items()} == \
        {"bfs": 0, "sssp": 1, "cc": 2, "ingest_only": 3, "widest": 4,
         "reliable": 5}
