"""Fault injection in the port (DESIGN §9), on the CPU, against the JAX
package: ``fault_hash16`` bit for bit, the ``FaultPlan`` thresholds,
``safe()`` and ``validate``, the message seals, the ``flt`` leaf, the
config rules, and ``hop_stage`` with faults on random states full of
traffic, each hazard alone and all together, at lanes 1 and 2, with
telemetry on and off.  Exact: integer leaves equal, float leaves equal as
bits.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import EngineConfig as JConfig
from repro.core import routing as jrouting
from repro.core.engine import _rc as j_rc
from repro.core.msg import msg_seal as j_msg_seal
from repro.core.msg import seal_msg as j_seal_msg
from repro.core.state import init_state as j_init_state
from repro.resilience import FaultPlan as JPlan
from repro.resilience import fault_hash16 as j_fault_hash16
from repro_torch.core import EngineConfig, StreamingEngine
from repro_torch.core import routing
from repro_torch.core.engine import _rc
from repro_torch.core.msg import (OP_ALLOC, OP_APP, OP_INSERT_EDGE,
                                  OP_REPAIR, OP_SET_FUTURE, make_msg,
                                  msg_seal, seal_msg)
from repro_torch.core.state import (init_state, state_from_numpy,
                                    state_to_numpy)
from repro_torch.resilience import (FLT_BLACKOUT, FLT_DROP, FLT_DUP, N_FLT,
                                    FaultPlan, fault_hash16, is_droppable)

OPS = (OP_APP, OP_APP, OP_REPAIR, OP_INSERT_EDGE, OP_ALLOC, OP_SET_FUTURE)
ALL = dict(seed=7, drop_rate=0.3, dup_rate=0.3, corrupt_rate=0.3)
PLANS = {
    "drop": dict(seed=7, drop_rate=0.4),
    "dup": dict(seed=7, dup_rate=0.4),
    "corrupt": dict(seed=7, corrupt_rate=0.4),
    "blackout": dict(seed=7, blackouts=((1, 1, 0, 0, 10 ** 6),
                                        (1, 1, 0, 5, 10 ** 6),
                                        (2, 0, 3, 0, 10 ** 6),
                                        (0, 2, 1, 10 ** 6, 1))),
    "all": dict(ALL, blackouts=((1, 2, 2, 0, 10 ** 6),)),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_same_state(st, jst, where=""):
    got = state_to_numpy(st)
    for k, v in jst._asdict().items():
        a, b = got[k], np.asarray(v)
        if a.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        np.testing.assert_array_equal(a, b, err_msg=f"{k} {where}")


def test_fault_hash16_matches_jax_bit_for_bit():
    """Several seeds (negative and past 2^32 too) and the salts 1-3;
    cycles from 0 past 2^16 up to 2^31 - 1; every link id of a 32x32
    grid (cell * 4 + dir)."""
    rng = np.random.default_rng(0)
    cycles = np.concatenate([[0, 1, 2, 65535, 65536, 65537, 2 ** 31 - 1],
                             rng.integers(0, 2 ** 31 - 1, 8)])
    links = np.arange(32 * 32 * 4, dtype=np.int32)
    for seed in (0, 1, 3, 7, 11, 123456789, -5, 2 ** 40 + 3):
        for salt in (1, 2, 3):
            for c in cycles:
                got = fault_hash16(seed, torch.tensor(int(c),
                                                      dtype=torch.int32),
                                   torch.from_numpy(links), salt)
                want = np.asarray(j_fault_hash16(seed, jnp.int32(c),
                                                 jnp.asarray(links), salt))
                np.testing.assert_array_equal(got.numpy(), want,
                                              err_msg=f"{seed} {salt} {c}")
                assert got.min() >= 0 and got.max() < 65536


def test_fault_plan_thresholds_safe_and_validate_match_jax():
    for kw in (dict(), dict(seed=3, drop_rate=0.04, dup_rate=0.02,
                            corrupt_rate=0.02),
               dict(seed=9, drop_rate=0.5, dup_rate=0.999,
                    corrupt_rate=1 / 3, blackouts=((0, 1, 2, 0, 64),),
                    max_repair_rounds=5)):
        p, jp = FaultPlan(**kw), JPlan(**kw)
        for a, b in ((p, jp), (p.safe(), jp.safe())):
            assert (a.drop_thr, a.dup_thr, a.corrupt_thr) == \
                (b.drop_thr, b.dup_thr, b.corrupt_thr)
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
    kw = dict(height=8, width=8, n_vertices=64)
    for bad in (dict(drop_rate=1.5), dict(dup_rate=-0.1),
                dict(blackouts=((9, 0, 2, 0, 4),)),
                dict(blackouts=((0, 0, 4, 0, 4),)),
                dict(blackouts=((0, 0, 1, 0, 0),)),
                dict(max_repair_rounds=0)):
        with pytest.raises(AssertionError):
            JConfig(**kw, faults=JPlan(**bad)).validate()
        with pytest.raises(ValueError):
            EngineConfig(**kw, faults=FaultPlan(**bad)).validate()
    with pytest.raises(ValueError, match="FaultPlan"):
        EngineConfig(**kw, faults=object()).validate()
    EngineConfig(**kw, faults=FaultPlan(**PLANS["all"])).validate()


def test_seals_match_jax():
    rng = np.random.default_rng(1)
    m = rng.integers(-2 ** 31, 2 ** 31, (6, 7, 5)).astype(np.int32)
    got = seal_msg(torch.from_numpy(m))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(j_seal_msg(jnp.asarray(m))))
    np.testing.assert_array_equal(msg_seal(torch.from_numpy(m)).numpy(),
                                  np.asarray(j_msg_seal(jnp.asarray(m))))
    one = make_msg(OP_APP, torch.tensor(37), -123456789)
    sealed = seal_msg(one)
    assert int(sealed[4]) == int(msg_seal(one))
    for bit in range(8, 16):           # every bit a corruption flips
        bad = sealed.clone()
        bad[2] ^= 1 << bit
        assert int(msg_seal(bad)) != int(bad[4])
    assert is_droppable(torch.tensor([OP_APP, OP_REPAIR, OP_INSERT_EDGE,
                                      OP_ALLOC])).tolist() == \
        [True, True, False, False]


@pytest.mark.parametrize("on", [False, True])
def test_flt_leaf_has_the_jax_shape(on):
    kw = dict(height=4, width=6, n_vertices=24, lanes=2)
    cfg = EngineConfig(**kw, faults=FaultPlan() if on else None)
    jcfg = JConfig(**kw, faults=JPlan() if on else None)
    st = init_state(cfg, device="cpu")
    assert tuple(st.flt.shape) == j_init_state(jcfg).flt.shape == \
        ((N_FLT,) if on else (1,))
    arrays = {k: np.asarray(v) for k, v in j_init_state(jcfg)
              ._asdict().items()}
    assert_same_state(state_from_numpy(cfg, arrays, device="cpu"),
                      j_init_state(jcfg))


def test_unported_resilience_knobs_still_raise():
    """Faults, durable state, recovery and the ingest guard are carried
    (ROADMAP.md queue 1, item 4(b), done): ``qbatch > 1`` beside a plan
    raises ``ValueError`` with the JAX engine's text, as JAX refuses it, the
    guard without its telemetry plane is refused as JAX refuses it, and
    checkpoints and the recovery policy run beside a plan."""
    import tempfile
    from repro_torch.resilience import RecoveryPolicy
    from repro_torch.train import Checkpointer
    kw = dict(height=4, width=4, n_vertices=16, ghost_slots=8)
    EngineConfig(**kw, telemetry=True, ingest_guard=True).validate()
    with pytest.raises(ValueError, match="ingest_guard"):
        EngineConfig(**kw, ingest_guard=True).validate()
    with pytest.raises(ValueError, match="faults \\+ qbatch > 1"):
        EngineConfig(**kw, faults=FaultPlan(), qbatch=2).validate()
    eng = StreamingEngine(EngineConfig(**kw, faults=FaultPlan(seed=1)),
                          "bfs", device="cpu")
    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(d)
        eng.run_increment(np.zeros((0, 3), np.int32), ckpt=ck,
                          ckpt_block=True, recover=RecoveryPolicy())
        assert ck.all_steps() == [0] and eng.stream_pos == 1
    assert eng.recovery_log == []


def random_state(lanes, telemetry, plan, seed):
    """Port and JAX states of a 4x4 grid under ``plan`` with random
    channels in every lane (application traffic mostly, sealed or
    not), pointers and queue counts, and a random machine cycle."""
    kw = dict(height=4, width=4, n_vertices=16, edge_cap=2, ghost_slots=8,
              queue_cap=16, chan_cap=8, futq_cap=2, lanes=lanes,
              telemetry=telemetry)
    cfg = EngineConfig(**kw, faults=FaultPlan(**plan))
    jcfg = JConfig(**kw, faults=JPlan(**plan))
    rng = np.random.default_rng(seed)
    a = state_to_numpy(init_state(cfg, device="cpu"))
    H, W, L, LC = 4, 4, cfg.lanes, cfg.lane_capacity
    m = np.zeros((H, W, 4, L, LC, 5), np.int32)
    m[..., 0] = rng.choice(OPS, m.shape[:-1])
    m[..., 1] = rng.integers(0, cfg.n_cells * cfg.slots, m.shape[:-1])
    m[..., 2:4] = rng.integers(-2 ** 20, 2 ** 20, m.shape[:-1] + (2,))
    m[..., 4] = np.where(rng.random(m.shape[:-1]) < 0.5,
                         np.bitwise_xor.reduce(m[..., :4], axis=-1), 0)
    a["ch"] = m
    a["ch_n"] = rng.integers(0, LC + 1, (H, W, 4, L)).astype(np.int32)
    a["ch_head"] = rng.integers(0, LC, (H, W, 4, L)).astype(np.int32)
    a["ch_rr"] = rng.integers(0, L, (H, W, 4)).astype(np.int32)
    a["aq_n"] = rng.integers(0, cfg.queue_cap + 1, (H, W)).astype(np.int32)
    a["aq_head"] = rng.integers(0, cfg.queue_cap, (H, W)).astype(np.int32)
    a["cycle"] = np.int32(rng.integers(0, 2 ** 20))
    a["flt"] = rng.integers(0, 50, N_FLT).astype(np.int32)
    jst = j_init_state(jcfg)._replace(**{k: jnp.asarray(v)
                                         for k, v in a.items()})
    return cfg, jcfg, state_from_numpy(cfg, a, device="cpu"), jst


@pytest.mark.parametrize("telemetry", [False, True])
@pytest.mark.parametrize("lanes", [1, 2])
@pytest.mark.parametrize("hazard", sorted(PLANS))
def test_hop_stage_with_faults_matches_jax(hazard, lanes, telemetry):
    """Four hop stages in a row from random states of traffic, each
    compared leaf for leaf (``flt`` and the corrupted words included) and
    on its departures, over three seeds."""
    fired = np.zeros(N_FLT, np.int64)
    for seed in range(3):
        cfg, jcfg, st, jst = random_state(lanes, telemetry, PLANS[hazard],
                                          seed)
        rows, cols = _rc(cfg, "cpu")
        jrows, jcols = j_rc(jcfg)
        f0 = st.flt.numpy().copy()
        for t in range(4):
            st, hops = routing.hop_stage(cfg, st, rows, cols)
            jst, jhops = jrouting.hop_stage(jcfg, jst, jrows, jcols)
            assert int(hops) == int(jhops), (seed, t)
            assert_same_state(st, jst, f"seed {seed} hop {t}")
            st = st._replace(cycle=st.cycle + 1)
            jst = jst._replace(cycle=jst.cycle + 1)
        fired += st.flt.numpy() - f0
    want = {"drop": [FLT_DROP], "dup": [FLT_DUP], "corrupt": [],
            "blackout": [FLT_BLACKOUT],
            "all": [FLT_DROP, FLT_DUP, FLT_BLACKOUT]}[hazard]
    assert all(fired[k] > 0 for k in want), fired
    assert all(fired[k] == 0 for k in set(range(N_FLT)) - set(want)), fired
