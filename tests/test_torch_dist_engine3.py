"""The sharded ``StreamingEngine`` on the device loop with telemetry and
faults, over local tiles and over gloo, and its recovery (CPU).

The first two increments of the pinned stream's row of
``src/repro_torch/data/fault_fingerprint.json`` (the JAX engine's run
recorded: each increment's cycles, counters, ``flt``, frame count and the
digest of every leaf it ends in; the second loses messages and repairs),
run by the engine sharded over a (2, 1) mesh of ``LocalTiles``
(``dist.cca.shard_state``, the port's ``device_put``), every frame also
the unsharded engine's; and at the same time by two gloo processes
(``ProcessGroupTiles``), every increment's record equal on both ranks,
rank 0 alone writing the checkpoint.

A ``recover=`` escalation of a sharded engine (a lanes=1 hub wedge on a
4x4 grid, relieved at lanes=2) equals the unsharded engine's: the
recovery log with the flight recorder's wedge report, the relieved
config, the increment's counters and every leaf, and its state is sharded
again over the same mesh.
"""
import dataclasses
import inspect
import json
import pathlib
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.core import EngineConfig, StreamingEngine
from repro_torch.core.reference import bfs_levels
from repro_torch.core.state import state_to_numpy
from repro_torch.dist import cca
from repro_torch.graph.streams import StreamSpec, make_stream
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.paper_experiments import (MAX_CYCLES, hub_stream,
                                                  wedge_config)
from repro_torch.obs.frames import state_digests
from repro_torch.resilience import RecoveryPolicy
from repro_torch.resilience.faults import FaultPlan
from repro_torch.train import Checkpointer

from test_torch_dist_gloo import ranks

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def fault_replay(root):
    """The pinned stream's row: ``(config under its plan, its first two
    increments, their records)``."""
    fp = json.loads((root / "src/repro_torch/data/fault_fingerprint.json")
                    .read_text())
    spec = json.loads((root / "tests/data/pre_lanes_reference.json")
                      .read_text())["spec"]
    rec = next(r for r in fp["streams"]
               if r["name"] == "pinned lanes=1 drop/corrupt")
    plan = dict(rec["plan"], blackouts=tuple(
        tuple(b) for b in rec["plan"]["blackouts"]))
    cfg = EngineConfig(**dict(
        {k: v for k, v in rec["cfg"].items()
         if k in EngineConfig.__dataclass_fields__ and k != "faults"},
        faults=FaultPlan(**plan)))
    return cfg, make_stream(StreamSpec(**spec))[:2], rec["increments"]


def record(r, st):
    """An increment's record as the fingerprint keeps it."""
    return dict(cycles=r.cycles, hops=r.hops, execs=r.execs,
                stalls=r.stalls, allocs=r.allocs, flt=st.flt.tolist(),
                frames=len(r.frames),
                state=state_digests(state_to_numpy(st)))


# a rank runs the same replay (the two functions above, their source)
RANK = textwrap.dedent("""
    import json, pathlib, sys
    import torch
    from repro_torch.core import EngineConfig, StreamingEngine
    from repro_torch.core.state import state_to_numpy
    from repro_torch.dist import cca
    from repro_torch.dist.ctx import Mesh
    from repro_torch.dist.transport import ProcessGroupTiles
    from repro_torch.graph.streams import StreamSpec, make_stream
    from repro_torch.launch.paper_experiments import MAX_CYCLES
    from repro_torch.obs.frames import state_digests
    from repro_torch.resilience.faults import FaultPlan
    from repro_torch.train import Checkpointer
""") + inspect.getsource(fault_replay) + inspect.getsource(record) + \
    textwrap.dedent("""
    rank, world, init, root, ck = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    cfg, incs, want = fault_replay(pathlib.Path(root))
    tr = ProcessGroupTiles.connect(init, rank, world, backend="gloo",
                                   timeout_s=60)
    try:
        eng = StreamingEngine(cfg, "bfs", device="cpu")
        eng.seed(0, 0.0)
        eng.state = cca.shard_state(eng.cfg, eng.state,
                                    Mesh((world, 1), ("data", "model"), tr))
        assert eng.state.ranks == (rank,)
        for i, (e, w) in enumerate(zip(incs, want)):
            r = eng.run_increment(e, max_cycles=MAX_CYCLES)
            assert record(r, cca.gather_state(eng.state)) == w, (rank, i)
        eng.checkpoint(Checkpointer(ck))
    finally:
        ProcessGroupTiles.close()
    print("RANK_OK", rank)
""")


def test_sharded_device_loop_with_faults_replays_the_jax_engine(tmp_path):
    cfg, incs, want = fault_replay(ROOT)
    assert cfg.telemetry and cfg.faults.drop_thr and cfg.faults.corrupt_thr
    assert sum(want[1]["flt"]) > 0
    with ranks(RANK, 2, tmp_path, str(ROOT), str(tmp_path / "ck")):
        eng, one = (StreamingEngine(cfg, "bfs", device="cpu") for _ in "ab")
        for e in (eng, one):
            e.seed(0, 0.0)
        eng.state = cca.shard_state(eng.cfg, eng.state,
                                    make_host_mesh(2, 1, device="cpu"))
        for i, (e, w) in enumerate(zip(incs, want)):
            r = eng.run_increment(e, max_cycles=MAX_CYCLES)
            assert record(r, cca.gather_state(eng.state)) == w, \
                f"increment {i}"
            # every frame: the unsharded engine's, whose frames the
            # telemetry and fault fingerprints hold to the JAX engine's
            r1 = one.run_increment(e, max_cycles=MAX_CYCLES)
            for k in ("cell", "lane", "hiw", "aq_n", "pk_n", "ch_n",
                      "scal"):
                np.testing.assert_array_equal(getattr(r.frames, k),
                                              getattr(r1.frames, k),
                                              err_msg=f"{i}: frames {k}")
    assert Checkpointer(tmp_path / "ck").latest_step() == 2


def test_recovery_of_a_sharded_engine_is_the_unsharded_one():
    cfg = dataclasses.replace(wedge_config(), height=4, width=4,
                              n_vertices=32, chunk=8, queue_cap=10,
                              ghost_slots=16)
    edges = hub_stream(32, 20)
    mesh = make_host_mesh(2, 1, device="cpu")
    runs = []
    for shard in (False, True):
        eng = StreamingEngine(cfg, "bfs", device="cpu")
        eng.seed(0, 0.0)
        if shard:
            eng.state = cca.shard_state(eng.cfg, eng.state, mesh)
        r = eng.run_increment(edges, recover=RecoveryPolicy(max_attempts=2))
        runs.append((eng, r))
    (one, r1), (sh, r2) = runs
    assert one.cfg.lanes == sh.cfg.lanes == 2
    assert len(sh.recovery_log) == 1
    assert sh.recovery_log == one.recovery_log
    assert "wedged cell" in sh.recovery_log[0]["wedge"]
    for k in ("cycles", "hops", "execs", "stalls", "allocs"):
        assert getattr(r1, k) == getattr(r2, k), k
    assert isinstance(sh.state, cca.ShardedState) and sh.state.mesh is mesh
    assert sh.state.cfg == sh.cfg
    got = state_to_numpy(cca.gather_state(sh.state))
    for k, v in state_to_numpy(one.state).items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    np.testing.assert_array_equal(sh.values(), bfs_levels(32, edges[:, :2],
                                                          0))
