"""The sharded machine chunk by chunk against the JAX engine's
single-device run, and the sharded restore (CPU).

``tests/test_dist_cca_parity.py``'s parity config (8x8, 64 vertices, 160
edges, chunk 32) with telemetry and a fault plan (drops, duplicates and
corruptions often enough to cross the tile boundaries, and blackouts on
two boundary links), tiled over a (4, 2) mesh of ``LocalTiles`` to
quiescence: after every traced ``dist.cca.run_chunk`` every leaf of the
gathered state equals, as bits, the JAX engine's after its ``run_chunk``
(telemetry planes and ``flt`` included), the trace rows equal its
per-cycle stats, and the frame of the tiles (``dist.cca.snapshot``) the
port's frame of the JAX state.  The same check of a query batch:
``tests/test_torch_dist_engine2.py``.

The counterpart of ``tests/test_resilience.py::
test_restore_sharded_on_fake_mesh``: a checkpoint the JAX engine wrote
after the lanes=2 hub stream's first 250 edges, restored by
``StreamingEngine.restore(shardings=(mesh, cca_state_shardings(mesh,
...)))`` onto a 4x2 mesh of ``LocalTiles``, is the JAX engine's state on
every leaf, and finishes the stream with values equal to the JAX
engine's and to the oracle.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import EngineConfig as JConfig
from repro.core import StreamingEngine as JEngine
from repro.core.engine import run_chunk as j_run_chunk
from repro.core.ingest import load_stream as j_load
from repro.graph.streams import hub_edges
from repro.resilience import FaultPlan as JPlan
from repro.train.checkpoint import Checkpointer as JCheckpointer
from repro_torch.core import EngineConfig, StreamingEngine
from repro_torch.core.ingest import load_stream
from repro_torch.core.reference import bfs_levels
from repro_torch.core.state import (init_state, state_from_numpy,
                                    state_to_numpy)
from repro_torch.dist import cca
from repro_torch.dist.sharding import cca_state_shardings
from repro_torch.launch.dist_bench import scale_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.obs import frames as obs_frames
from repro_torch.resilience.faults import FaultPlan
from repro_torch.train import Checkpointer

MAX_CHUNKS = 6
# the S link out of (3, 3) crosses the (4, 2) mesh's row cut (rows 3 | 4),
# the E link out of (5, 3) its column cut (columns 3 | 4)
PLAN = dict(seed=3, drop_rate=0.05, dup_rate=0.05, corrupt_rate=0.05,
            blackouts=((3, 3, 1, 0, 40), (5, 3, 3, 10, 30)))
HUB_KW = dict(height=8, width=8, n_vertices=256, edge_cap=8,
              ghost_slots=24, queue_cap=32, chan_cap=16, chunk=64, lanes=2,
              max_cycles=200000)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def parity_configs(port_app, jax_app, plan=None):
    """``(port config, port app, JAX config, JAX app, edges)``: the parity
    config with telemetry, and ``plan`` (``FaultPlan`` fields)."""
    cfg, edges = scale_config("ci")
    cfg = dataclasses.replace(cfg, telemetry=True)
    jkw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    if plan is not None:
        cfg = dataclasses.replace(cfg, faults=FaultPlan(**plan))
        jkw["faults"] = JPlan(**plan)
    return cfg, port_app, JConfig(**jkw), jax_app, edges


def seed(eng, seeds=((0, 0.0, 0),)):
    for vid, value, q in seeds[:eng.cfg.qbatch]:
        eng.seed(vid, value, val_idx=q)


def jax_chunks(jcfg, japp, edges, seeds, max_chunks):
    """The JAX engine's state (numpy) and per-cycle stats after each of
    its first ``max_chunks`` chunks, or to quiescence."""
    jeng = JEngine(jcfg, japp)
    seed(jeng, seeds)
    st, spill = j_load(jeng.cfg, jeng.state, edges)
    assert len(spill) == 0
    out = []
    for _ in range(max_chunks):
        st, stats = j_run_chunk(jeng.cfg, jeng.app,
                                jax.tree.map(jnp.copy, st))
        out.append(({k: np.asarray(v) for k, v in st._asdict().items()},
                    np.stack([np.asarray(stats.active),
                              np.asarray(stats.in_flight)], 1)))
        if np.asarray(stats.quiescent).any():
            break
    return out


def bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def sharded_chunks_equal(cfg, app, edges, seeds, want, tag):
    """The port's state seeded and loaded as ``jax_chunks``', tiled over
    (4, 2), chunk by chunk against ``want``: every leaf as bits, the trace
    rows and the frame.  Returns the last launch record."""
    eng = StreamingEngine(cfg, app, device="cpu")
    seed(eng, seeds)
    st, spill = load_stream(eng.cfg, eng.state, edges)
    assert len(spill) == 0
    sst = cca.shard_state(eng.cfg, st, make_host_mesh(4, 2, device="cpu"))
    trace = torch.zeros((eng.cfg.chunk, 2), dtype=torch.int32)
    for k, (w, stats) in enumerate(want):
        sst, rec = cca.run_chunk(eng.cfg, eng.app, sst, trace=trace)
        got = state_to_numpy(cca.gather_state(sst))
        for name, a in w.items():
            np.testing.assert_array_equal(
                bits(got[name]), bits(a),
                err_msg=f"{tag} chunk {k}: leaf {name!r}")
        ran = int(rec[1])
        assert ran == int(w["cycle"]) - (int(want[k - 1][0]["cycle"])
                                         if k else 0)
        np.testing.assert_array_equal(trace[:ran].numpy(), stats[:ran],
                                      err_msg=f"{tag} chunk {k}: trace")
        frame = cca.snapshot(eng.cfg, sst, rec[0])
        assert torch.equal(frame, obs_frames.snapshot(
            eng.cfg, state_from_numpy(eng.cfg, w, device="cpu"), rec[0]))
    return rec


def test_sharded_faults_and_telemetry_equal_jax_chunk_by_chunk():
    cfg, app, jcfg, japp, edges = parity_configs("bfs", "bfs", PLAN)
    want = jax_chunks(jcfg, japp, edges, ((0, 0.0, 0),), MAX_CHUNKS)
    rec = sharded_chunks_equal(cfg, app, edges, ((0, 0.0, 0),), want,
                               "telemetry+faults")
    assert bool(rec[0]), "not quiescent"
    last = want[-1][0]
    assert (last["tm_cell"].sum(axis=(0, 1)) > 0).any()
    assert (last["flt"] > 0).all(), "a hazard never fired"


def test_restore_sharded_on_a_mesh_of_local_tiles(tmp_path):
    one = np.float32(1.0).view(np.int32)
    e = hub_edges(256, 0, 120, seed=3)
    edges = np.concatenate([e, np.full((len(e), 1), one, np.int64)],
                           1).astype(np.int32)
    jeng = JEngine(JConfig(**HUB_KW), "bfs")
    jeng.seed(0, 0.0)
    jeng.run_increment(edges[:250])
    jeng.checkpoint(JCheckpointer(tmp_path))

    cfg = EngineConfig(**HUB_KW)
    mesh = make_host_mesh(4, 2, device="cpu")
    sh = cca_state_shardings(mesh, init_state(cfg, device="meta"))
    assert sh.vals == ("data", "model", None, None)
    res = StreamingEngine.restore(cfg, "bfs", Checkpointer(tmp_path),
                                  shardings=(mesh, sh))
    assert isinstance(res.state, cca.ShardedState)
    assert res.state.grid == cca.Grid(8, 8, 4, 2)
    got = state_to_numpy(cca.gather_state(res.state))
    for k, v in jeng.state._asdict().items():
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)
    assert res.stream_pos == jeng.stream_pos == 1
    res.run_increment(edges[250:])
    jeng.run_increment(edges[250:])
    np.testing.assert_array_equal(res.values(), np.asarray(jeng.values()))
    np.testing.assert_array_equal(res.values(),
                                  bfs_levels(256, edges[:, :2], 0))
    with pytest.raises(ValueError, match="cca_state_shardings"):
        StreamingEngine.restore(cfg, "bfs", Checkpointer(tmp_path),
                                shardings=(mesh, sh._replace(vals=())))
