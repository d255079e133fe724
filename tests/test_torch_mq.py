"""The query-batched pieces of the port (``repro_torch.mq``, DESIGN §10)
against the JAX package, on the CPU: the ``[Q]`` message helpers, the
composite apps of ``batch_app``, ``staging_stage`` and ``phase0_stage`` at
Q = 3 on mid-stream 4x4 states (rhizome roots, ghosts and deferred
inserts included) bit for bit, the config's rules for ``qbatch``, the
FrontDesk's ``tm_hiw`` gate and its latency report, and ``bench_serve``'s
record from the receipts of ``src/repro_torch/data/mq_fingerprint.json``
equal to ``results/bench_serve.json``.  The gpu-marked test holds the
cycle kernels' query-batched instances against the plain version on the
card and skips here.
"""
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.config import EngineConfig as JConfig
from repro.core import exec_stage as jx
from repro.core import msg as jmsg
from repro.core.state import MachineState as JState
from repro.mq.app import batch_app as j_batch_app
from repro_torch.core import msg as tmsg
from repro_torch.core import exec_stage as tx
from repro_torch.core.config import EngineConfig
from repro_torch.core.engine import _rc
from repro_torch.core.ingest import load_stream
from repro_torch.core.state import TM_HW_AQ, state_to_numpy
from repro_torch.kernels.cca_cycle.ref import cca_cycle_chunk_ref
from repro_torch.launch import serve_bench as sb
from repro_torch.mq import FrontDesk, MQSession, batch_app

ROOT = pathlib.Path(__file__).resolve().parents[1]
FP = json.loads((ROOT / "src" / "repro_torch" / "data"
                 / "mq_fingerprint.json").read_text())
MIX3 = (("bfs", 0), ("sssp", 3), ("widest", 5))
# edge_cap 2 and rhizome_cap 2 on 32 vertices: ghosts, set-futures,
# deferred inserts and the rhizome link protocol all run
STAGE_KW = dict(height=4, width=4, n_vertices=32, edge_cap=2,
                ghost_slots=24, queue_cap=32, chan_cap=16, futq_cap=4,
                io_stream_cap=512, lanes=2, rhizome_cap=2, chunk=16)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_msg_helpers_match_jax():
    rng = np.random.default_rng(0)
    for q in (1, 2, 3, 8, 32):
        assert tmsg.msg_words(q) == jmsg.msg_words(q) == 5 + q - 1
        a1 = rng.integers(-2**31, 2**31, (4, 5), dtype=np.int64).astype(
            np.int32)
        a1[0, :2] = 0
        np.testing.assert_array_equal(
            tmsg.qsel_mask(torch.from_numpy(a1), q).numpy(),
            np.asarray(jmsg.qsel_mask(jnp.asarray(a1), q)))
        bits = rng.integers(-2**31, 2**31, (4, 5, q), dtype=np.int64
                            ).astype(np.int32)
        op = rng.integers(0, 8, (4, 5)).astype(np.int32)
        dst = rng.integers(0, 999, (4, 5)).astype(np.int32)
        got = tmsg.make_qmsg(torch.from_numpy(op), torch.from_numpy(dst),
                             torch.from_numpy(bits), torch.from_numpy(a1))
        want = np.asarray(jmsg.make_qmsg(jnp.asarray(op), jnp.asarray(dst),
                                         jnp.asarray(bits),
                                         jnp.asarray(a1)))
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            tmsg.msg_qvals(got, q).numpy(),
            np.asarray(jmsg.msg_qvals(jnp.asarray(want), q)))
        m5 = torch.from_numpy(want[..., :5].copy())
        np.testing.assert_array_equal(
            tmsg.pad_msg(m5, tmsg.msg_words(q)).numpy(),
            np.asarray(jmsg.pad_msg(jnp.asarray(want[..., :5]),
                                    jmsg.msg_words(q))))


@pytest.mark.parametrize("names", [
    ("bfs", "sssp", "cc", "widest", "reliable", "ingest_only", "bfs"),
    ("widest", "bfs"), ("sssp",)])
def test_batch_app_matches_jax(names):
    """Each composite function equals the JAX composite's bit for bit on
    random vectors (unreached values, ties and edge weights included)."""
    got, want = batch_app(names), j_batch_app(names)
    if len(names) == 1:
        assert got.qbatch == 1 and got.name == names[0]
        return
    assert got.qbatch == got.n_vals == want.qbatch == len(names)
    assert got.init_val == want.init_val
    assert got.fwd_neutral == want.fwd_neutral
    assert [a.name for a in got.slot_apps] == list(names)
    rng = np.random.default_rng(1)
    shape = (6, 5, len(names))
    v = rng.choice(np.float32([0.0, 0.5, 1.0, 2.25, 7.0, 1e9]), shape)
    inc = np.where(rng.random(shape) < 0.3, v,
                   rng.random(shape, np.float32) * 8).astype(np.float32)
    w = (0.1 + 0.9 * rng.random(shape[:-1])).astype(np.float32)
    tv, ti, tw = (torch.from_numpy(a) for a in (v, inc, w))
    jv, ji, jw = (jnp.asarray(a) for a in (v, inc, w))
    nv, ch = got.relax(tv, ti)
    jnv, jch = want.relax(jv, ji)
    np.testing.assert_array_equal(nv.numpy().view(np.int32),
                                  np.asarray(jnv).view(np.int32))
    np.testing.assert_array_equal(ch.numpy(), np.asarray(jch))
    np.testing.assert_array_equal(
        got.edge_value(tv, tw).numpy().view(np.int32),
        np.asarray(want.edge_value(jv, jw)).view(np.int32))
    np.testing.assert_array_equal(got.propagate_on_insert(tv).numpy(),
                                  np.asarray(want.propagate_on_insert(jv)))
    np.testing.assert_array_equal(
        got.fwd_merge(tv, ti).numpy().view(np.int32),
        np.asarray(want.fwd_merge(jv, ji)).view(np.int32))


def _to_jax(st):
    return JState(**{k: jnp.asarray(v)
                     for k, v in state_to_numpy(st).items()})


def _assert_same(st, jst, where):
    got = state_to_numpy(st)
    for k, v in jst._asdict().items():
        np.testing.assert_array_equal(got[k], np.asarray(v),
                                      err_msg=f"{where}: leaf {k}")


def _stage_states():
    """Mid-stream states of the Q=3 session on ``STAGE_KW``: each
    increment's first cycle and after 6, 20 and 45 cycles."""
    ses = MQSession(EngineConfig(**STAGE_KW), qbatch=3,
                    apps=[a for a, _ in MIX3], device="cpu")
    for q, (app, src) in enumerate(MIX3):
        ses.admit(app, src, slot=q)
    cfg, app, st = ses.eng.cfg, ses.eng.app, ses.eng.state
    out = []
    for e in sb.weighted_stream(32, 64, 2, 3):
        st, _ = load_stream(cfg, st, e)
        for k in (1, 5, 14, 25):
            st, _ = cca_cycle_chunk_ref(cfg, app, st, k)
            out.append(st)
    return cfg, app, out


def test_stages_match_jax_at_q3():
    cfg, app, states = _stage_states()
    jcfg = JConfig(**{k: getattr(cfg, k) for k in STAGE_KW},
                   qbatch=3, n_vals=3)
    japp = j_batch_app([a for a, _ in MIX3])
    rows, cols = _rc(cfg, "cpu")
    jrows, jcols = jnp.asarray(rows.numpy()), jnp.asarray(cols.numpy())
    seen = np.zeros(8, int)
    for i, st in enumerate(states):
        busy0 = st.cvalid.clone()
        seen += np.bincount(st.cmsg[..., 0].flatten().numpy(), minlength=8)
        jst = _to_jax(st)
        st1, act = tx.staging_stage(cfg, app, st, rows, cols)
        jst1, jact = jx.staging_stage(jcfg, japp, jst, jrows, jcols)
        np.testing.assert_array_equal(act.numpy(), np.asarray(jact))
        _assert_same(st1, jst1, f"staging, state {i}")
        st2, pop = tx.phase0_stage(cfg, app, st1, rows, cols, busy0)
        jst2, jpop = jx.phase0_stage(jcfg, japp, jst1, jrows, jcols,
                                     jnp.asarray(busy0.numpy()))
        np.testing.assert_array_equal(pop.numpy(), np.asarray(jpop))
        _assert_same(st2, jst2, f"phase 0, state {i}")
    # the states reach the app-like and the protocol handlers
    assert (seen[[1, 2, 3, 4]] > 0).all(), seen


def test_query_batched_state_layout():
    cfg = EngineConfig(height=4, width=4, n_vertices=16, ghost_slots=8,
                       qbatch=4, n_vals=4)
    cfg.validate()
    app = batch_app(["bfs", "widest", "cc", "reliable"])
    ses = MQSession(cfg, qbatch=4, apps=["bfs", "widest", "cc", "reliable"],
                    device="cpu")
    st = ses.eng.state
    assert st.aq.shape[-1] == st.cmsg.shape[-1] == 8
    assert tuple(st.fwd_val.shape) == (4, 4, cfg.slots, 4)
    assert tuple(st.cemit.shape) == (4, 4, 4)
    assert tuple(st.qchg.shape) == tuple(st.qlast.shape) == (4,)
    np.testing.assert_array_equal(st.vals[0, 0, 0].numpy(),
                                  np.float32(app.init_val))
    np.testing.assert_array_equal(st.fwd_val[0, 0, 0].numpy(),
                                  np.float32(app.fwd_neutral))


def test_frontdesk_gate_defers_and_reports():
    """An action-queue hi-water at the ceiling closes the gate: the
    pending requests wait and each counts a deferral; under it the gate
    opens and FrontDesk admits into free slots."""
    cfg = EngineConfig(height=4, width=4, n_vertices=32, ghost_slots=8,
                       queue_cap=32, chan_cap=8, lanes=2, telemetry=True)
    ses = MQSession(cfg, qbatch=2, apps=["bfs", "sssp"], device="cpu")
    fd = FrontDesk(ses)
    fd.submit("bfs", 0)
    fd.submit("sssp", 3)
    ceiling = cfg.queue_cap - cfg.aq_reserve - cfg.sys_reserve
    ses.eng.state.tm_hiw[1, 2, TM_HW_AQ] = int(np.ceil(0.75 * ceiling))
    assert not fd.admission_open()
    assert fd.pump() == [] and fd.deferrals == 2 and len(fd.pending) == 2
    ses.eng.state.tm_hiw[1, 2, TM_HW_AQ] = int(np.ceil(0.75 * ceiling)) - 1
    assert fd.admission_open()
    assert fd.pump() == [0, 1] and not fd.pending
    assert [s.state for s in ses.slots] == ["active", "active"]
    fd.step(sb.weighted_stream(32, 40, 1, 2)[0])
    fd.drain()
    rep = fd.latency_report()
    lat = [r["latency_cycles"] for r in fd.receipts]
    assert rep["served"] == 2 and rep["deferrals"] == 2
    assert rep["n"] == 2 and rep["max"] == max(lat) > 0


def test_serve_record_from_fingerprint_receipts():
    """``bench_serve``'s record, built by the port from the JAX engine's
    receipts and serial cycles at ci scale, is ``results/bench_serve.json``
    (2,961 batch cycles against 6,692, all exact, 0 deferrals); the
    FrontDesk's latency report over those receipts is its summary."""
    run = next(r for r in FP["runs"] if r["kind"] == "serve")
    want = json.loads((ROOT / "results" / "bench_serve.json").read_text())
    rec = run["record"]
    got = sb.serve_record("ci", rec["receipts"],
                          [s["cycles"] for s in run["serial"]],
                          [s["exact"] for s in run["serial"]],
                          sum(b["cycles"] for b in run["beats"]),
                          rec["deferrals"])
    assert json.loads(json.dumps(got)) == want
    assert (want["batch_cycles"], want["serial_cycles_total"],
            want["deferrals"]) == (2961, 6692, 0)
    fd = FrontDesk.__new__(FrontDesk)
    fd.receipts, fd.deferrals = rec["receipts"], 0
    rep = fd.latency_report()
    assert {k: rep[k] for k in want["latency"]} == want["latency"]
    assert rep["served"] == 8
    # the port's copies of the mix and the preset
    from benchmarks.serve_bench import QUERY_MIX, SCALES
    assert sb.QUERY_MIX == QUERY_MIX and sb.SCALES == SCALES


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU "
                    "mode (chip_smoke.py phase 36 runs these comparisons)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["cluster", "block"])
def test_query_instances_match_plain(card, path):
    """The Q=3 session's chunks on the card equal the plain version on
    every leaf (qchg / qlast included) and the launch record, on the
    cluster kernel and forced onto the one-block kernel."""
    from repro_torch.kernels.cca_cycle import ops
    cfg, app, states = _stage_states()
    for st in states:
        dev = st._replace(**{k: v.to(card) for k, v in st._asdict().items()})
        got, grec = ops.cca_cycle_chunk(cfg, app, dev, 16, path=path)
        want, wrec = cca_cycle_chunk_ref(cfg, app, st, 16)
        assert grec.tolist() == wrec.tolist()
        a, b = state_to_numpy(got), state_to_numpy(want)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
