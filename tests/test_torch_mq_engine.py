"""The query-batched engine end to end against the live JAX engine (jnp
backend) on the CPU: ``tests/test_mq.py``'s Q=3 parity config, every leaf
and the counters after each increment and each slot's values; the Q=1
``MQSession`` replaying ``tests/data/pre_lanes_reference.json``; a
``StreamingEngine`` built from a composite app, its per-increment
``qchg`` reset and ``values(combine=)``, and a checkpoint of it restored
by the other package."""
import dataclasses
import json
import pathlib
import tempfile

import numpy as np
import pytest
import torch

from repro.core.config import EngineConfig as JConfig
from repro.core.engine import StreamingEngine as JEngine
from repro.mq.app import batch_app as j_batch_app
from repro.mq.session import MQSession as JSession
from repro.train.checkpoint import Checkpointer as JCheckpointer
from repro_torch.core import EngineConfig, StreamingEngine
from repro_torch.core.apps import APPS
from repro_torch.core.state import state_to_numpy
from repro_torch.graph.streams import StreamSpec, make_stream
from repro_torch.launch.serve_bench import weighted_stream
from repro_torch.mq import MQSession, QuerySlot, batch_app
from repro_torch.train import Checkpointer

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF = json.loads((ROOT / "tests" / "data"
                  / "pre_lanes_reference.json").read_text())
Q3_KW = dict(height=4, width=4, n_vertices=64, edge_cap=8, ghost_slots=32,
             queue_cap=64, chan_cap=32, futq_cap=8, io_stream_cap=1024,
             lanes=4, chunk=64)
MIX3 = (("bfs", 0), ("sssp", 3), ("widest", 5))


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_state(st, jst, where):
    got = state_to_numpy(st)
    for k, v in jst._asdict().items():
        np.testing.assert_array_equal(got[k], np.asarray(v),
                                      err_msg=f"{where}: leaf {k}")


def test_q3_parity_config_matches_jax():
    """``test_megakernel_parity_q3``'s config and stream: the port's
    session equals the JAX engine's on every leaf, the counters and each
    slot's values after every increment, and in each tenant's
    lifecycle."""
    incs = weighted_stream(64, 120, 2, 9)
    jses = JSession(JConfig(backend="jnp", **Q3_KW), qbatch=3,
                    apps=[a for a, _ in MIX3])
    ses = MQSession(EngineConfig(**Q3_KW), qbatch=3,
                    apps=[a for a, _ in MIX3], device="cpu")
    for q, (app, src) in enumerate(MIX3):
        jses.admit(app, src, slot=q)
        ses.admit(app, src, slot=q)
    _same_state(ses.eng.state, jses.eng.state, "admitted")
    for i, e in enumerate(incs + [np.zeros((0, 3), np.int32)]):
        jr, r = jses.run_increment(e), ses.run_increment(e)
        assert (r.cycles, r.hops, r.execs, r.stalls, r.allocs) == (
            jr.cycles, jr.hops, jr.execs, jr.stalls, jr.allocs), i
        _same_state(ses.eng.state, jses.eng.state, f"increment {i}")
        for q in range(3):
            np.testing.assert_array_equal(ses.values(q), jses.values(q))
        assert [(s.state, s.settle_cycle) for s in ses.slots] == \
            [(s.state, s.settle_cycle) for s in jses.slots]
    assert ses.settled_slots() == [0, 1, 2]
    assert [ses.retire(q) for q in range(3)] == \
        [jses.retire(q) for q in range(3)]


def test_q1_session_replays_pinned_reference():
    """At qbatch = 1 the session is the classic engine: the pinned
    fingerprint's counters and values exactly, and the slot settles at
    the first quiet boundary."""
    ses = MQSession(EngineConfig(**REF["cfg"]), qbatch=1, device="cpu")
    assert ses.composite is APPS["bfs"]
    ses.eng.seed(0, 0.0)
    ses.slots[0] = QuerySlot(app=APPS["bfs"], source=0, state="active")
    rows = []
    for e in make_stream(StreamSpec(**REF["spec"])):
        r = ses.run_increment(e, max_cycles=500_000)
        rows.append(dict(cycles=r.cycles, hops=r.hops, execs=r.execs,
                         stalls=r.stalls, allocs=r.allocs))
    want = REF["backends"]["jnp"]
    assert rows == want["increments"]
    np.testing.assert_array_equal(ses.values(0, 128),
                                  np.float32(want["values"]))
    assert ses.slots[0].state == "active"
    ses.run_increment(np.zeros((0, 3), np.int32))
    assert ses.settled_slots() == [0]


def test_engine_takes_a_composite_app_and_crosses_packages():
    """``StreamingEngine(cfg, batch_app(...))`` sets n_vals and qbatch,
    resets ``qchg`` each increment (``qlast`` persists), reads a slot
    with the combine it is given, and its checkpoint restores in the JAX
    engine (and back) with every leaf equal."""
    cfg = EngineConfig(**dict(Q3_KW, chunk=32))
    app = batch_app(["bfs", "widest"])
    eng = StreamingEngine(cfg, app, device="cpu")
    assert (eng.cfg.qbatch, eng.cfg.n_vals, eng.cfg.msg_words) == (2, 2, 6)
    eng.seed(0, 0.0, val_idx=0)
    eng.seed(5, 1e9, val_idx=1)
    incs = weighted_stream(64, 80, 2, 4)
    eng.run_increment(incs[0])
    last = eng.state.qlast.clone()
    assert (eng.state.qchg > 0).all()
    eng.run_increment(np.zeros((0, 3), np.int32))
    assert (eng.state.qchg == 0).all()
    assert torch.equal(eng.state.qlast, last)
    np.testing.assert_array_equal(eng.values(val_idx=1),
                                  eng.values(val_idx=1, combine=np.maximum))
    assert (eng.values(val_idx=0, combine=np.maximum)
            >= eng.values(val_idx=0)).all()
    with pytest.raises(NotImplementedError, match="pagerank"):
        StreamingEngine(cfg, dataclasses.replace(APPS["bfs"],
                                                 name="pagerank"),
                        device="cpu")
    japp = j_batch_app(["bfs", "widest"])
    with tempfile.TemporaryDirectory() as d:
        eng.checkpoint(Checkpointer(d))
        jeng = JEngine.restore(JConfig(backend="jnp", **dict(Q3_KW,
                                                              chunk=32)),
                               japp, JCheckpointer(d))
        _same_state(eng.state, jeng.state, "JAX restore")
        jeng.run_increment(incs[1])
        eng.run_increment(incs[1])
        _same_state(eng.state, jeng.state, "after the restore")
    with tempfile.TemporaryDirectory() as d:
        jeng.checkpoint(JCheckpointer(d))
        back = StreamingEngine.restore(cfg, app, Checkpointer(d),
                                       device="cpu")
        _same_state(back.state, jeng.state, "port restore")
