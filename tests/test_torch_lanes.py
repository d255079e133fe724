"""Virtual lanes in the port, on the CPU, against the JAX engine: the lane
of a message (``msg_lane``), the round-robin lane arbiter of ``hop_stage``
and the park stage (``park_stage``) on random machine states at ``lanes``
2 and 4, the arbiter's fairness bound and its skipping of a blocked lane
(``tests/test_lanes.py``), and the hub stream of ``tests/test_lanes.py``
at ``lanes=1``, where both engines raise ``LivelockError`` at the same
cycle in the same state.  Exact: integer leaves equal, float leaves equal
as bits.  ``tests/test_torch_lanes_hub.py`` runs the hub stream to its end
at ``lanes`` 2 and 4.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import EngineConfig as JConfig
from repro.core import StreamingEngine as JEngine
from repro.core import routing as jrouting
from repro.core.engine import LivelockError as JLivelockError
from repro.core.engine import _rc as j_rc
from repro.core.state import init_state as j_init_state
from repro.graph.streams import hub_edges
from repro_torch.core import EngineConfig, LivelockError, StreamingEngine
from repro_torch.core import routing
from repro_torch.core.engine import _rc
from repro_torch.core.msg import (OP_ALLOC, OP_APP, OP_INSERT_EDGE,
                                  OP_LINK_RHIZOME, OP_RHIZOME_FWD,
                                  OP_SET_FUTURE, make_msg)
from repro_torch.core.state import (init_state, state_from_numpy,
                                    state_to_numpy)

ONE = np.float32(1.0).view(np.int32)
OPS = (OP_INSERT_EDGE, OP_APP, OP_ALLOC, OP_SET_FUTURE, OP_RHIZOME_FWD,
       OP_LINK_RHIZOME)
DIR_E = 3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain version runs thousands of tiny ops per cycle: one
    intra-op thread is faster, and leaves the cores to the other test
    workers."""
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


def lane_kw(lanes, **kw):
    base = dict(height=4, width=4, n_vertices=16, edge_cap=2, ghost_slots=8,
                queue_cap=16, chan_cap=8, futq_cap=2, lanes=lanes)
    base.update(kw)
    return base


def random_state(kw, seed):
    """A state of ``kw`` with random channels (every lane), park rings,
    round-robin pointers and action-queue counts: messages of every
    opcode to random addresses of the grid."""
    cfg = EngineConfig(**kw)
    rng = np.random.default_rng(seed)
    a = state_to_numpy(init_state(cfg, device="cpu"))
    H, W, L, LC, PK = (cfg.height, cfg.width, cfg.lanes, cfg.lane_capacity,
                       cfg.park_capacity)

    def msgs(shape):
        m = np.zeros(shape + (5,), np.int32)
        m[..., 0] = rng.choice(OPS, shape)
        m[..., 1] = rng.integers(0, cfg.n_cells * cfg.slots, shape)
        m[..., 2:4] = rng.integers(-2 ** 20, 2 ** 20, shape + (2,))
        return m

    a["ch"] = msgs((H, W, 4, L, LC))
    a["ch_n"] = rng.integers(0, LC + 1, (H, W, 4, L)).astype(np.int32)
    a["ch_head"] = rng.integers(0, LC, (H, W, 4, L)).astype(np.int32)
    a["ch_rr"] = rng.integers(0, L, (H, W, 4)).astype(np.int32)
    a["pk"] = msgs((H, W, PK))
    a["pk_n"] = rng.integers(0, PK + 1, (H, W)).astype(np.int32)
    a["pk_head"] = rng.integers(0, PK, (H, W)).astype(np.int32)
    a["aq_n"] = rng.integers(0, cfg.queue_cap + 1, (H, W)).astype(np.int32)
    a["aq_head"] = rng.integers(0, cfg.queue_cap, (H, W)).astype(np.int32)
    return cfg, state_from_numpy(cfg, a, device="cpu"), \
        j_init_state(JConfig(**kw))._replace(
            **{k: jnp.asarray(a[k]) for k in ("ch", "ch_n", "ch_head",
                                              "ch_rr", "pk", "pk_n",
                                              "pk_head", "aq_n",
                                              "aq_head")})


@pytest.mark.parametrize("lanes", [1, 2, 4])
def test_msg_lane_matches_jax(lanes):
    cfg = EngineConfig(**lane_kw(lanes))
    jcfg = JConfig(**lane_kw(lanes))
    dst = np.arange(-40, 200, dtype=np.int32)
    for op in OPS:
        got = routing.msg_lane(cfg, torch.tensor(op), torch.from_numpy(dst))
        want = np.asarray(jrouting.msg_lane(jcfg, jnp.int32(op),
                                            jnp.asarray(dst)))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(op))


def test_manhattan_hops_matches_jax():
    kw = lane_kw(1, height=5, width=7, n_vertices=35)
    rows, cols = _rc(EngineConfig(**kw), "cpu")
    cells = torch.arange(35, dtype=torch.int32)
    for c in (0, 6, 17, 34):
        got = routing.manhattan_hops(EngineConfig(**kw), cells[c], rows, cols)
        want = jrouting.manhattan_hops(JConfig(**kw), jnp.int32(c),
                                       *j_rc(JConfig(**kw)))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("lanes", [2, 4])
def test_hop_and_park_stages_match_jax_on_random_states(lanes, seed):
    """The arbiter (every lane's head, the pointer, the grant) and the
    park ring's re-injection and rotation, stage by stage: hop, then park
    on its output, three cycles over."""
    kw = lane_kw(lanes)
    cfg, st, jst = random_state(kw, seed)
    jcfg = JConfig(**kw)
    rows, cols = _rc(cfg, "cpu")
    jrows, jcols = j_rc(jcfg)
    for t in range(3):
        st, hops = routing.hop_stage(cfg, st, rows, cols)
        jst, jhops = jrouting.hop_stage(jcfg, jst, jrows, jcols)
        assert int(hops) == int(jhops), t
        assert_same_state(st, jst, f"after hop {t}")
        st = routing.park_stage(cfg, st, rows, cols)
        jst = jrouting.park_stage(jcfg, jst, jrows, jcols)
        assert_same_state(st, jst, f"after park {t}")


def _put_chan(st, r, c, d, lane, msgs):
    ch, ch_n = st.ch.clone(), st.ch_n.clone()
    for i, m in enumerate(msgs):
        ch[r, c, d, lane, i] = m
    ch_n[r, c, d, lane] = len(msgs)
    return st._replace(ch=ch, ch_n=ch_n)


def test_blocked_lane_never_blocks_siblings():
    """A lane whose head cannot enter its receiver is skipped: a sibling
    lane's message takes the link in the same cycle."""
    cfg = EngineConfig(**lane_kw(4))
    st = init_state(cfg, device="cpu")
    rows, cols = _rc(cfg, "cpu")
    S = cfg.slots
    blocked = make_msg(OP_APP, torch.tensor(1 * S), 0, 0)
    st = _put_chan(st, 0, 0, DIR_E, 1, [blocked, blocked])
    aq_n = st.aq_n.clone()
    aq_n[0, 1] = cfg.queue_cap - cfg.aq_reserve - cfg.sys_reserve
    st = st._replace(aq_n=aq_n)
    st = _put_chan(st, 0, 0, DIR_E, 2, [make_msg(OP_APP, torch.tensor(2 * S),
                                                 0, 0)])
    st2, hops = routing.hop_stage(cfg, st, rows, cols)
    assert int(hops) == 1
    assert int(st2.ch_n[0, 0, DIR_E, 2]) == 0
    assert int(st2.ch_n[0, 1, DIR_E, 2]) == 1
    assert int(st2.ch_n[0, 0, DIR_E, 1]) == 2


def test_saturated_lane_starvation_bound():
    """With every lane's head admissible, each lane is granted once in
    ``lanes`` cycles: no lane starves a sibling."""
    cfg = EngineConfig(**lane_kw(4))
    st = init_state(cfg, device="cpu")
    rows, cols = _rc(cfg, "cpu")
    S = cfg.slots
    proto = make_msg(OP_SET_FUTURE, torch.tensor(1 * S + 1), 0, 0)
    appm = make_msg(OP_APP, torch.tensor(1 * S), 0, 0)
    st = _put_chan(st, 0, 0, DIR_E, 0, [proto, proto])
    for lane in (1, 2, 3):
        st = _put_chan(st, 0, 0, DIR_E, lane, [appm] * cfg.lane_capacity)
    before = st.ch_n[0, 0, DIR_E].clone()
    for _ in range(cfg.lanes):
        st, _ = routing.hop_stage(cfg, st, rows, cols)
    assert (before - st.ch_n[0, 0, DIR_E] == 1).all()


def hub_stream(n=128, degree=200, seed=3):
    e = hub_edges(n, 0, degree, seed=seed)
    return np.concatenate([e, np.full((len(e), 1), ONE, np.int64)],
                          1).astype(np.int32)


HUB = dict(height=8, width=8, n_vertices=128, edge_cap=4, ghost_slots=48,
           queue_cap=20, chan_cap=16, futq_cap=4, io_stream_cap=2048,
           chunk=64)


def test_hub_livelocks_without_lanes_as_jax_does():
    """``tests/test_lanes.py::test_hub_livelocks_without_lanes``: at
    ``lanes=1`` the hub stream wedges; both engines raise at the same cycle
    and chunk, in the same state."""
    jeng = JEngine(JConfig(lanes=1, **HUB), "bfs")
    jeng.seed(0, 0.0)
    with pytest.raises(JLivelockError) as jerr:
        jeng.run_increment(hub_stream(), max_cycles=500_000)
    eng = StreamingEngine(EngineConfig(lanes=1, **HUB), "bfs", device="cpu")
    eng.seed(0, 0.0)
    with pytest.raises(LivelockError, match="livelock") as err:
        eng.run_increment(hub_stream(), max_cycles=500_000)
    assert (err.value.cycle, err.value.chunk) == \
        (jerr.value.cycle, jerr.value.chunk)
    assert_same_state(eng.state, jeng.state)
