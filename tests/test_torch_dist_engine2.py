"""A query batch on the sharded machine against the JAX engine's
single-device run, chunk by chunk and over whole increments, and the
sharded engine's checkpoint (CPU).

A batch of three apps (``StreamingEngine(cfg, batch_app(...))``) with
telemetry on ``tests/test_dist_cca_parity.py``'s parity config.  Tiled
over a (4, 2) mesh of ``LocalTiles``, its first ``Q_CHUNKS`` chunks: after
every traced ``dist.cca.run_chunk`` every leaf of the gathered state
(``qchg`` and ``qlast`` included) equals, as bits, the JAX engine's after
its ``run_chunk``, with the trace rows and the frame
(``test_torch_dist_engine.sharded_chunks_equal``).  Through the
``StreamingEngine`` sharded over (2, 1) (``dist.cca.shard_state``, the
port's ``device_put``) on the traced loop (``collect_traces=True``), in two
increments beside the JAX engine: each increment's cycles, counters,
trace rows and every frame, and at the end every leaf and ``values()`` of
each slot.  Both JAX references share one compile of its ``run_chunk``
(the same config and app).  The sharded engine's checkpoint is the
unsharded one's, file for file, and the JAX engine restores it.
"""
import json

import numpy as np
import pytest
import torch

from repro.core.engine import StreamingEngine as JEngine
from repro.mq import batch_app as j_batch_app
from repro.train.checkpoint import Checkpointer as JCheckpointer
from repro_torch.core import StreamingEngine
from repro_torch.core.state import state_to_numpy
from repro_torch.dist import cca
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.mq import batch_app
from repro_torch.train import Checkpointer

from test_torch_dist_engine import (jax_chunks, parity_configs,
                                    sharded_chunks_equal)

MQ = ("bfs", "sssp", "cc")
SEEDS = ((0, 0.0, 0), (5, 0.0, 1), (9, 0.0, 2))   # (vertex, value, slot)
# every slot has changed and settled by the second chunk (of four to
# quiescence); the whole increments below run to quiescence
Q_CHUNKS = 2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def configs():
    """``(port config, port app, JAX config, JAX app, edges)``, one JAX
    app object for both references (the key of its compile)."""
    return parity_configs(batch_app(MQ), j_batch_app(MQ))


def test_sharded_query_batch_equals_jax_chunk_by_chunk(configs):
    cfg, app, jcfg, japp, edges = configs
    want = jax_chunks(jcfg, japp, edges, SEEDS, Q_CHUNKS)
    assert len(want) == Q_CHUNKS
    sharded_chunks_equal(cfg, app, edges, SEEDS, want, "qbatch+telemetry")
    last = want[-1][0]
    assert (last["tm_cell"].sum(axis=(0, 1)) > 0).any()
    assert (last["qchg"] > 0).all() and (last["qlast"] > 0).all()


@pytest.fixture(scope="module")
def batch(configs):
    """Both engines after two traced increments of the batch, and their
    results."""
    cfg, app, jcfg, japp, edges = configs
    eng = StreamingEngine(cfg, app, device="cpu")
    jeng = JEngine(jcfg, japp)
    for e in (eng, jeng):
        for vid, value, q in SEEDS:
            e.seed(vid, value, val_idx=q)
    eng.state = cca.shard_state(eng.cfg, eng.state,
                                make_host_mesh(2, 1, device="cpu"))
    res = [(eng.run_increment(e, collect_traces=True),
            jeng.run_increment(e, collect_traces=True))
           for e in np.array_split(edges, 2)]
    return eng, jeng, res


def test_sharded_traced_batch_equals_jax_increment_by_increment(batch):
    eng, jeng, res = batch
    for i, (r, j) in enumerate(res):
        for k in ("cycles", "hops", "execs", "stalls", "allocs"):
            assert getattr(r, k) == getattr(j, k), (i, k)
        assert len(r.active_per_cycle) == r.cycles
        np.testing.assert_array_equal(r.active_per_cycle,
                                      np.asarray(j.active_per_cycle))
        np.testing.assert_array_equal(r.in_flight_per_cycle,
                                      np.asarray(j.in_flight_per_cycle))
        assert len(r.frames) == len(j.frames) and r.frames.dropped == \
            j.frames.dropped
        for k in ("cell", "lane", "hiw", "aq_n", "pk_n", "ch_n", "scal"):
            np.testing.assert_array_equal(getattr(r.frames, k),
                                          np.asarray(getattr(j.frames, k)),
                                          err_msg=f"{i}: frames {k}")
    got = state_to_numpy(cca.gather_state(eng.state))
    for k, v in jeng.state._asdict().items():
        a, b = got[k], np.asarray(v)
        if a.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert (got["qchg"] > 0).all()
    assert eng.total_cycles == jeng.total_cycles
    assert eng.totals == jeng.totals
    for q in range(len(MQ)):
        np.testing.assert_array_equal(eng.values(val_idx=q),
                                      np.asarray(jeng.values(val_idx=q)))


def test_sharded_checkpoint_is_the_unsharded_one(batch, tmp_path):
    """The same files as the unsharded engine's, byte for byte (the
    manifest but its time), which the JAX engine restores into its own
    state."""
    eng, jeng, _ = batch
    eng.checkpoint(Checkpointer(tmp_path / "sharded"))
    one = StreamingEngine(eng.cfg, eng.app, device="cpu")
    one.state = cca.gather_state(eng.state)
    one.stream_pos, one.total_cycles = eng.stream_pos, eng.total_cycles
    one.totals = dict(eng.totals)
    one.checkpoint(Checkpointer(tmp_path / "whole"))
    files = sorted(p.name for p in (tmp_path / "whole" / "step_2").iterdir())
    assert files == sorted(p.name for p in
                           (tmp_path / "sharded" / "step_2").iterdir())
    for name in files:
        a, b = ((tmp_path / d / "step_2" / name).read_bytes()
                for d in ("sharded", "whole"))
        if name == "manifest.json":     # all but the time it was written
            a, b = ({k: v for k, v in json.loads(x).items() if k != "time"}
                    for x in (a, b))
        assert a == b, name
    restored = JEngine.restore(jeng.cfg, jeng.app,
                               JCheckpointer(tmp_path / "sharded"))
    for k, v in jeng.state._asdict().items():
        np.testing.assert_array_equal(np.asarray(getattr(restored.state, k)),
                                      np.asarray(v), err_msg=k)
    assert restored.stream_pos == 2
