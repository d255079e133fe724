"""Fault injection in the port, chunk by chunk against the JAX engine on
the CPU: every state leaf (``flt``, the telemetry planes and the seal
words of every queued message included) equal after every chunk of the
faulty run, then the repair pass's sentinel rows equal, loaded, and run
chunk by chunk under the plan's safe twin to quiescence, every leaf equal
again.  The configs: the pinned 8x8 stream (``tests/data/
pre_lanes_reference.json``, lanes=1) under drop and corrupt; the 8x8 hub
stream at ``rhizome_cap=4`` under drop, whose repair rows reach secondary
roots; ``widest`` at ``rhizome_cap=2``, lanes=2 under drop, a
max-monotone repair (``tests/test_torch_faults_hub.py``).  And a JAX
state taken mid-increment with faults on, carried over with
``state_from_numpy``, running one chunk to the JAX engine's next state.
``tests/test_torch_faults_hub*.py`` run the hub stream of
``tests/test_resilience.py`` under its four plans the same way, with the
helpers of this file.  Exact: integer leaves equal, float leaves equal as
bits.
"""
import dataclasses
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import EngineConfig as JConfig
from repro.core import StreamingEngine as JEngine
from repro.core.engine import quiescent as j_quiescent
from repro.core.engine import run_to_quiescence_while
from repro.core.ingest import load_stream as j_load
from repro.resilience import FaultPlan as JPlan
from repro_torch.core import EngineConfig, StreamingEngine
from repro_torch.core.ingest import load_stream
from repro_torch.core.state import state_from_numpy, state_to_numpy
from repro_torch.graph.streams import StreamSpec, make_stream
from repro_torch.kernels.cca_cycle.ops import cca_cycle_chunk
from repro_torch.launch.paper_experiments import hub_stream
from repro_torch.resilience import FLT_CORRUPT, FLT_DROP, FaultPlan

REF = json.loads((pathlib.Path(__file__).parent / "data"
                  / "pre_lanes_reference.json").read_text())
RESET = ("stat_hops", "stat_exec", "stat_stall", "stat_allocs", "tm_cell",
         "tm_lane", "tm_hiw", "flt")


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


def weighted_increments(seed=1, n=64, m=320):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, m), rng.integers(0, n, m)
    w = (1.0 - rng.random(m)).astype(np.float32)
    e = np.stack([src, dst, w.view(np.int32)], 1).astype(np.int32)
    return [e[: m // 2], e[m // 2:]]


class Pair:
    """The JAX engine and the port's (CPU) on one config and fault plan,
    stepped chunk by chunk in lock step."""

    def __init__(self, kw, plan, app, seed_val):
        self.jeng = JEngine(JConfig(**kw, faults=JPlan(**plan)), app)
        self.eng = StreamingEngine(EngineConfig(**kw, faults=FaultPlan(
            **plan)), app, device="cpu")
        for e in (self.jeng, self.eng):
            e.seed(0, seed_val)
        self.jchunk = {}
        self.chunks = 0

    def _jchunk(self, cfg):
        if cfg not in self.jchunk:
            self.jchunk[cfg] = jax.jit(lambda s: run_to_quiescence_while(
                cfg, self.jeng.app, s, max_cycles=cfg.chunk))
        return self.jchunk[cfg]

    def load(self, edges):
        self.jeng.state, js = j_load(self.jeng.cfg, self.jeng.state, edges)
        self.eng.state, s = load_stream(self.eng.cfg, self.eng.state, edges)
        assert len(s) == len(js) == 0

    def fresh(self):
        self.jeng.state = self.jeng.state._replace(**{
            k: jnp.zeros_like(getattr(self.jeng.state, k)) for k in RESET})
        self.eng.state = self.eng.state._replace(**{
            k: torch.zeros_like(getattr(self.eng.state, k)) for k in RESET})

    def run(self, safe=False, where=""):
        """Chunks to quiescence under the plan (or its safe twin), every
        leaf compared after each."""
        jcfg, cfg = self.jeng.cfg, self.eng.cfg
        if safe:
            jcfg = dataclasses.replace(jcfg, faults=jcfg.faults.safe())
            cfg = dataclasses.replace(cfg, faults=cfg.faults.safe())
        jchunk = self._jchunk(jcfg)
        for _ in range(400):
            self.jeng.state = jchunk(self.jeng.state)
            self.eng.state, qr = cca_cycle_chunk(cfg, self.eng.app,
                                                 self.eng.state)
            self.chunks += 1
            assert_same_state(self.eng.state, self.jeng.state,
                              f"{where} chunk {self.chunks}")
            assert bool(qr[0]) == bool(j_quiescent(self.jeng.state))
            if qr[0]:
                return
        raise AssertionError(f"{where}: no quiescence in 400 chunks")

    def repair(self, where=""):
        """The repair pass's rows from both engines, equal; loaded and run
        under the safe twin.  Returns the rows."""
        rows = self.eng._repair_entries()
        np.testing.assert_array_equal(rows, self.jeng._repair_entries())
        self.load(rows)
        self.run(safe=True, where=f"{where} repair")
        return rows


def run_stream(kw, plan, incs, app="bfs", seed_val=0.0):
    """The faulty stream increment by increment: the faulty chunks, then
    (where the loss detector fires, as the engine's) the repair's.
    Returns the pair, the flt of each increment and the repair rows."""
    p = Pair(kw, plan, app, seed_val)
    flts, rows = [], []
    for i, e in enumerate(incs):
        p.load(e)
        p.fresh()
        p.run(where=f"increment {i}")
        assert p.eng._loss_count() == p.jeng._loss_count()
        flts.append(p.eng.state.flt.tolist())
        if p.eng._loss_count():
            rows.append(p.repair(f"increment {i}"))
    return p, flts, rows


def test_pinned_lanes1_drop_corrupt_chunk_by_chunk():
    plan = dict(seed=5, drop_rate=0.05, corrupt_rate=0.03)
    p, flts, rows = run_stream(dict(REF["cfg"], telemetry=True), plan,
                               make_stream(StreamSpec(**REF["spec"])))
    assert sum(f[FLT_DROP] for f in flts) > 0
    assert sum(f[FLT_CORRUPT] for f in flts) > 0
    assert len(rows) >= 2


def test_rhizome_cap4_drop_repairs_secondary_roots_chunk_by_chunk():
    kw = dict(height=8, width=8, n_vertices=64, edge_cap=4, ghost_slots=32,
              queue_cap=96, chan_cap=16, futq_cap=8, io_stream_cap=2048,
              chunk=128, rhizome_cap=4, telemetry=True)
    p, flts, rows = run_stream(kw, dict(seed=3, drop_rate=0.05),
                               [hub_stream(64, 40)])
    assert flts[0][FLT_DROP] > 0
    assert (rows[0][:, 1] < -1).any()          # rows for roots k >= 1


def test_jax_state_carried_across_runs_the_next_chunk():
    """A JAX state taken mid-increment under a plan with every hazard,
    carried over with ``state_from_numpy``, runs one chunk on the port's
    plain version to the JAX engine's next state."""
    kw = dict(height=8, width=8, n_vertices=256, edge_cap=8, ghost_slots=24,
              queue_cap=32, chan_cap=16, chunk=64, lanes=2, telemetry=True)
    plan = dict(seed=7, drop_rate=0.05, dup_rate=0.03, corrupt_rate=0.02,
                blackouts=((0, 1, 2, 0, 256),))
    jeng = JEngine(JConfig(**kw, faults=JPlan(**plan)), "bfs")
    jeng.seed(0, 0.0)
    jst, _ = j_load(jeng.cfg, jeng.state, hub_stream(256, 120))
    jchunk = jax.jit(lambda s: run_to_quiescence_while(
        jeng.cfg, jeng.app, s, max_cycles=jeng.cfg.chunk))
    for _ in range(3):
        jst = jchunk(jst)
    assert np.asarray(jst.flt)[:3].min() > 0
    cfg = EngineConfig(**kw, faults=FaultPlan(**plan))
    st = state_from_numpy(cfg, {k: np.asarray(v) for k, v in
                                jst._asdict().items()}, device="cpu")
    st, _ = cca_cycle_chunk(cfg, StreamingEngine(cfg, "bfs",
                                                 device="cpu").app, st)
    assert_same_state(st, jchunk(jst), "the chunk after the carried state")
