"""Durable state, recovery and the ingest guard of the port (DESIGN §9),
against the JAX package on the CPU: the checkpointer's format and its
failure modes, ``config_fingerprint`` across the packages,
``RecoveryPolicy.escalate``, ``migrate_state``'s boundary check, the
ingest guard's AIMD steps and the config checks.  The streams run in
``tests/test_torch_resilience_*.py``: kill-and-resume and checkpoints
crossing the packages (``_resume``), recovery (``_recover``, ``_budget``)
and the guarded hub stream (``_guard``, ``_guard2``).  The configs are
``tests/test_resilience.py``'s ``_cfg`` and ``_wedge_cfg``.
"""
import dataclasses
import json
import zipfile

import jax
import numpy as np
import pytest
import torch

from repro.core import EngineConfig as JConfig
from repro.core import StreamingEngine as JEngine
from repro.resilience import FaultPlan as JPlan
from repro.resilience import RecoveryPolicy as JPolicy
from repro.resilience import config_fingerprint as j_fingerprint
from repro.train.checkpoint import Checkpointer as JCheckpointer
from repro.train.checkpoint import _flatten_with_names as j_flatten
from repro_torch.core import EngineConfig, StreamingEngine
from repro_torch.core.apps import APPS
from repro_torch.core.ingest import load_stream
from repro_torch.core.state import state_to_numpy
from repro_torch.launch.paper_experiments import hub_stream, wedge_config
from repro_torch.resilience import (FaultPlan, RecoveryPolicy,
                                    assert_boundary, boundary_snapshot,
                                    config_fingerprint, migrate_state)
from repro_torch.resilience.recover import STORAGE_LEAVES
from repro_torch.train import Checkpointer
from repro_torch.train.checkpoint import _flatten_with_names

# tests/test_resilience.py::_cfg, without its backend
HUB_KW = dict(height=8, width=8, n_vertices=256, edge_cap=8, ghost_slots=24,
              queue_cap=32, chan_cap=16, chunk=64, lanes=2,
              max_cycles=200_000, telemetry=True)


def _cfg(**kw):
    return EngineConfig(**dict(HUB_KW, **kw))


def _engine(cfg=None, edges=None):
    eng = StreamingEngine(cfg or _cfg(), "bfs", device="cpu")
    eng.seed(0, 0.0)
    if edges is not None:
        eng.state, spill = load_stream(eng.cfg, eng.state, edges)
        assert not len(spill)
    return eng


# ------------------------------ checkpointer ------------------------------

def test_flatten_names_and_order_match_jax():
    tree = {"b": {"z": np.zeros(2), "a": [np.ones(1), np.arange(3)]},
            "a": np.int32(4), "c": (np.zeros((2, 2)),)}
    names, leaves, _ = j_flatten(tree)
    got = _flatten_with_names(tree)
    assert [n for n, _ in got] == names
    for (_, a), b in zip(got, leaves):
        np.testing.assert_array_equal(a, b)


def test_state_leaves_cross_formats_bit_for_bit(tmp_path):
    """A port state saved by the port's checkpointer reads back through
    the JAX checkpointer with every leaf's dtype, shape (0-d scalars as
    ``()``, bool as bool) and bits, and the manifests agree on names,
    keys, shapes, dtypes and checksums."""
    eng = _engine(_cfg(faults=FaultPlan(seed=1, drop_rate=0.02)),
                  hub_stream()[:40])
    host = state_to_numpy(eng.state)
    Checkpointer(tmp_path / "pt").save(3, eng.state._asdict())
    JCheckpointer(tmp_path / "jx").save(3, host)
    tree, extra, step = JCheckpointer(tmp_path / "pt").restore(
        jax.tree.map(np.zeros_like, host))
    assert step == 3 and extra == {}
    for k, v in host.items():
        assert tree[k].dtype == v.dtype and tree[k].shape == v.shape, k
        np.testing.assert_array_equal(tree[k], v, err_msg=k)

    def leaves(d):
        m = json.loads((tmp_path / d / "step_3" / "manifest.json")
                       .read_text())
        return m["leaves"], m["shards"]
    assert leaves("pt") == leaves("jx")


def test_save_async_snapshots_before_returning(tmp_path):
    """The state updated in place right after ``save_async`` returns (a
    load into ``io_edges``, a value write) restores as it was saved."""
    eng = _engine(edges=hub_stream()[:40])
    saved = {k: v.copy() for k, v in state_to_numpy(eng.state).items()}
    ck = Checkpointer(tmp_path)
    eng.checkpoint(ck, block=False)
    eng.state, _ = load_stream(eng.cfg, eng.state, hub_stream()[40:120])
    eng.state.vals.fill_(7.0)
    eng.state.io_edges.fill_(-3)
    ck.wait()
    tree, _, _ = ck.restore(saved)
    for k, v in saved.items():
        np.testing.assert_array_equal(tree[k], v, err_msg=k)


def test_save_async_under_thread_switching(tmp_path):
    """Back-to-back async saves of a tree updated in place after each
    returns, with the interpreter switching threads every microsecond:
    every step restores the values it was saved with, and the writer
    thread is gone after ``wait()``."""
    import sys
    import threading
    interval = sys.getswitchinterval()
    x, flags = torch.zeros(64, 1024, dtype=torch.int32), torch.zeros(
        5, dtype=torch.bool)
    ck = Checkpointer(tmp_path, keep=24)
    sys.setswitchinterval(1e-6)
    try:
        for step in range(24):
            x.fill_(step)
            flags[step % 5] = True
            ck.save_async(step, {"x": x, "flags": flags},
                          extra={"step": step})
            x.fill_(-1)
            flags.zero_()
        done = threading.Thread(target=ck.wait)
        done.start()
        done.join(timeout=60)
        assert not done.is_alive() and ck._thread is None
    finally:
        sys.setswitchinterval(interval)
    assert sorted(ck.all_steps()) == list(range(24))
    for step in range(24):
        tree, extra, _ = ck.restore({"x": None, "flags": None}, step=step)
        assert extra == {"step": step}
        assert (tree["x"] == step).all()
        assert tree["flags"].tolist() == [k == step % 5 for k in range(5)]


def test_tampered_shard_is_caught(tmp_path):
    eng = _engine(edges=hub_stream()[:40])
    ck = Checkpointer(tmp_path)
    eng.checkpoint(ck)
    shard = next((tmp_path / "step_0").glob("shard_*.npz"))
    blob = bytearray(shard.read_bytes())
    blob[len(blob) // 2] ^= 0xFF
    shard.write_bytes(bytes(blob))
    with pytest.raises((IOError, ValueError, zipfile.BadZipFile)):
        StreamingEngine.restore(_cfg(), "bfs", Checkpointer(tmp_path),
                                device="cpu")


def test_checksum_mismatch_names_the_leaf(tmp_path):
    ck = Checkpointer(tmp_path)
    ck.save(0, {"x": torch.arange(4), "y": torch.ones(3, dtype=torch.bool)})
    m = tmp_path / "step_0" / "manifest.json"
    man = json.loads(m.read_text())
    man["leaves"][0]["sum"] = "0" * 16
    m.write_text(json.dumps(man))
    like = {"x": None, "y": None}
    with pytest.raises(IOError, match="checksum mismatch for x @ step 0"):
        ck.restore(like)
    tree, _, _ = ck.restore(like, verify=False)
    assert tree["y"].dtype == np.bool_ and tree["x"].tolist() == [0, 1, 2, 3]


def test_async_error_surfaces_once(tmp_path):
    ck = Checkpointer(tmp_path / "ck")
    ck.dir = tmp_path / "ck" / "not_a_dir" / "sub"
    (tmp_path / "ck" / "not_a_dir").write_text("file, not dir")
    ck.save_async(0, dict(x=torch.arange(4)))
    with pytest.raises(RuntimeError, match="async checkpoint save failed"):
        ck.wait()
    ck.wait()                  # consumed: not raised a second time


def test_stale_tmp_reclaimed_and_keep(tmp_path):
    stale = tmp_path / "step_5.tmp"
    stale.mkdir(parents=True)
    (stale / "shard_0.npz").write_bytes(b"garbage")
    ck = Checkpointer(tmp_path, keep=2)
    assert not stale.exists() and ck.all_steps() == []
    for step in range(4):
        ck.save(step, {"x": np.full(3, step)})
    assert sorted(ck.all_steps()) == [2, 3] and ck.latest_step() == 3
    assert ck.last["step"] == 3 and ck.last["bytes"] == 24
    with pytest.raises(FileNotFoundError):
        Checkpointer(tmp_path / "empty").restore({"x": None})


# ------------------------ fingerprint and restore checks ------------------------

@pytest.mark.parametrize("kw", [
    dict(), dict(telemetry=True, frame_ring=16),
    dict(telemetry=True, ingest_guard=True, lanes=3, queue_cap=40),
    dict(faults="plan")], ids=["default", "telemetry", "guard", "faults"])
def test_config_fingerprint_equal_across_packages(kw):
    plan = dict(seed=7, drop_rate=0.04, dup_rate=0.02, corrupt_rate=0.02,
                blackouts=((0, 1, 2, 0, 512), (3, 3, 0, 10, 20)))
    jkw, pkw = dict(kw), dict(kw)
    if kw.get("faults"):
        jkw["faults"], pkw["faults"] = JPlan(**plan), FaultPlan(**plan)
    for backend in ("jnp", "pallas"):
        want = j_fingerprint(JConfig(**jkw, backend=backend))
        assert config_fingerprint(EngineConfig(**pkw), backend) == want
    assert config_fingerprint(EngineConfig(**pkw)) == \
        j_fingerprint(JConfig(**jkw))


def test_restore_refuses_another_config_or_app(tmp_path):
    eng = _engine(_cfg(faults=FaultPlan(seed=1, drop_rate=0.02)))
    ck = Checkpointer(tmp_path)
    eng.checkpoint(ck)
    with pytest.raises(ValueError, match="config"):
        StreamingEngine.restore(_cfg(), "bfs", ck, device="cpu")
    with pytest.raises(ValueError, match="app 'bfs' != engine app 'sssp'"):
        StreamingEngine.restore(eng.cfg, "sssp", ck, device="cpu")
    # strict=False lets a post-mortem look, but the layout must still fit
    with pytest.raises(ValueError, match="leaf 'flt'"):
        StreamingEngine.restore(_cfg(), "bfs", ck, strict=False,
                                device="cpu")


def test_jax_restores_a_port_checkpoint_strictly_under_jnp(tmp_path):
    eng = _engine(edges=hub_stream()[:40])
    eng.stream_pos, eng.total_cycles = 4, 123
    eng.totals.update(hops=5, execs=6)
    ck = Checkpointer(tmp_path)
    eng.checkpoint(ck)
    jcfg = JConfig(**HUB_KW, backend="jnp")
    res = JEngine.restore(jcfg, "bfs", JCheckpointer(tmp_path))
    assert (res.stream_pos, res.total_cycles) == (4, 123)
    assert res.totals == eng.totals
    got = state_to_numpy(eng.state)
    for k, v in res.state._asdict().items():
        np.testing.assert_array_equal(np.asarray(v), got[k], err_msg=k)
    with pytest.raises(ValueError, match="config"):
        JEngine.restore(dataclasses.replace(jcfg, backend="pallas"), "bfs",
                        JCheckpointer(tmp_path))


# ------------------------------- recovery -------------------------------

def test_escalate_matches_jax():
    jcfg = JConfig(**dict(
        height=8, width=8, n_vertices=128, edge_cap=4, ghost_slots=48,
        queue_cap=20, chan_cap=16, futq_cap=4, chunk=64, lanes=1,
        max_cycles=200_000, telemetry=True))
    cfg = wedge_config()
    for policy in (dict(lanes_step=1, queue_cap_step=4), dict(),
                   dict(lanes_step=0, queue_cap_step=8)):
        for k in (1, 2):
            got = RecoveryPolicy(**policy).escalate(cfg, k)
            want = JPolicy(**policy).escalate(jcfg, k)
            assert (got.lanes, got.queue_cap) == (want.lanes, want.queue_cap)
            assert config_fingerprint(got) == j_fingerprint(want)
    c2 = RecoveryPolicy(lanes_step=1, queue_cap_step=4).escalate(cfg, 2)
    assert c2.lanes == 3 and c2.queue_cap == 28
    assert config_fingerprint(c2) != config_fingerprint(cfg)
    with pytest.raises(ValueError, match="lanes"):
        RecoveryPolicy(lanes_step=-1).escalate(cfg, 1)


def test_migrate_state_refuses_a_mid_increment_state():
    eng = _engine(edges=hub_stream()[:8])
    with pytest.raises(ValueError, match="not an increment boundary"):
        migrate_state(eng.cfg, APPS["bfs"], eng.state)
    with pytest.raises(ValueError, match="io stream"):
        assert_boundary(eng.state)


def test_migrate_state_matches_jax():
    """A boundary (every queue empty, durable storage set) migrated into
    lanes=3, queue_cap=40: the same state as the JAX package's
    ``migrate_state``, on every leaf, and the snapshot's clones unshared
    with the live state."""
    from repro.core.apps import APPS as JAPPS
    from repro.core.state import MachineState as JState
    from repro.resilience import migrate_state as j_migrate
    rng = np.random.default_rng(0)
    eng = _engine()
    st = eng.state
    for name in STORAGE_LEAVES:
        t = getattr(st, name)
        if t.dtype == torch.bool:
            t.copy_(torch.from_numpy(rng.random(t.shape) < 0.3))
        elif t.dtype == torch.float32:
            t.copy_(torch.from_numpy(rng.random(t.shape, np.float32)))
        else:
            t.copy_(torch.from_numpy(rng.integers(-5, 99, t.shape,
                                                  dtype=np.int32)))
    st.cycle.fill_(4321)
    snap = boundary_snapshot(st)
    st.vals.fill_(-1.0)                   # the live state moves on
    new = dataclasses.replace(eng.cfg, lanes=3, queue_cap=40)
    got = state_to_numpy(migrate_state(new, APPS["bfs"], snap))
    jnew = JConfig(**dict(HUB_KW, lanes=3, queue_cap=40))
    jsnap = JState(**state_to_numpy(snap))
    want = j_migrate(jnew, JAPPS["bfs"], jsnap)
    for k, v in want._asdict().items():
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)
    assert (got["vals"] != -1.0).any()


# ------------------------------ ingest guard ------------------------------

def test_ingest_guard_aimd_steps():
    eng = StreamingEngine(_cfg(ingest_guard=True), "bfs", device="cpu")
    cap = eng.cfg.io_cells * eng.cfg.io_stream_cap
    ceiling = eng.cfg.queue_cap - eng.cfg.aq_reserve - eng.cfg.sys_reserve
    assert eng._ingest_limit() is None
    eng.state.tm_hiw[0, 0, 0] = ceiling
    eng._update_ingest_budget()
    assert eng._ingest_budget == cap // 2
    eng._update_ingest_budget()
    assert eng._ingest_budget == cap // 4
    eng.state.tm_hiw.zero_()
    eng._update_ingest_budget()
    assert eng._ingest_budget == cap // 2
    assert eng._ingest_limit() == cap // 2
    # in the band's upper half the budget holds; it never drops below
    # io_cells nor climbs above the buffers
    eng.state.tm_hiw[3, 2, 0] = ceiling // 2
    eng._update_ingest_budget()
    assert eng._ingest_budget == cap // 2
    eng.state.tm_hiw[3, 2, 0] = ceiling + 5
    for _ in range(20):
        eng._update_ingest_budget()
    assert eng._ingest_budget == eng.cfg.io_cells
    eng.state.tm_hiw.zero_()
    for _ in range(20):
        eng._update_ingest_budget()
    assert eng._ingest_budget == cap


def test_ingest_guard_requires_telemetry():
    with pytest.raises(ValueError, match="ingest_guard"):
        _cfg(ingest_guard=True, telemetry=False).validate()
    _cfg(ingest_guard=True).validate()


@pytest.mark.parametrize("n_io", [4, 12])
def test_n_io_cells_off_the_width_refused(n_io):
    with pytest.raises(NotImplementedError, match="broadcast error"):
        _cfg(n_io_cells=n_io).validate()
    for ok in (0, 8):
        _cfg(n_io_cells=ok).validate()
