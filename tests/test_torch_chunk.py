"""Chunk parity: the port's cycle chunk (``cca_cycle_chunk`` on a CPU
state, i.e. the plain version) equals the JAX package's Pallas cycle
megakernel (``cca_cycle_chunk(..., interpret=True)``) chunk by chunk to
quiescence, on every state leaf and on the ``[quiescent, cycles_run]``
counters.  Same setup as ``tests/test_cycle_kernel.py``'s kernel-vs-ref
test; tolerance is exact (float32 leaves equal as bits).
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import EngineConfig as JConfig
from repro.core import StreamingEngine as JEngine
from repro.core.apps import BFS as J_BFS
from repro.core.ingest import load_stream as j_load
from repro.kernels.cca_cycle.ops import cca_cycle_chunk as j_chunk
from repro_torch.core import EngineConfig, StreamingEngine
from repro_torch.core.reference import bfs_levels
from repro_torch.core.state import state_from_numpy, state_to_numpy
from repro_torch.kernels.cca_cycle.ops import cca_cycle_chunk

ONE = np.float32(1.0).view(np.int32)
CFG = dict(height=8, width=8, n_vertices=64, edge_cap=4, ghost_slots=16,
           queue_cap=32, chan_cap=8, futq_cap=8, io_stream_cap=256, chunk=32)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain version runs thousands of tiny ops per cycle: one
    intra-op thread is faster, and leaves the cores to the other test
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_chunks_match_jax_megakernel():
    rng = np.random.default_rng(0)
    E = 160
    edges = np.stack([rng.integers(0, 64, E), rng.integers(0, 64, E),
                      np.full(E, ONE)], 1).astype(np.int32)
    jeng = JEngine(JConfig(**CFG), "bfs")
    jeng.seed(0, 0.0)
    jcfg = jeng.cfg
    jst, spill = j_load(jcfg, jeng.state, edges)
    assert len(spill) == 0
    fk = jax.jit(lambda s: j_chunk(jcfg, J_BFS, s, interpret=True))

    eng = StreamingEngine(EngineConfig(**CFG), "bfs", device="cpu")
    cfg = eng.cfg
    st = state_from_numpy(cfg, {k: np.asarray(v)
                                for k, v in jst._asdict().items()},
                          device="cpu")
    for i in range(70):
        jst, jc = fk(jst)
        st, tc = cca_cycle_chunk(cfg, eng.app, st)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc),
                                      err_msg=f"counters, chunk {i}")
        got = state_to_numpy(st)
        for k, v in jst._asdict().items():
            a, b = got[k], np.asarray(v)
            assert a.dtype == b.dtype and a.shape == b.shape, k
            if a.dtype == np.float32:
                a, b = a.view(np.int32), b.view(np.int32)
            np.testing.assert_array_equal(a, b, err_msg=f"{k}, chunk {i}")
        if int(tc[0]):
            break
    assert int(tc[0]), "stream did not quiesce in 70 chunks"
    eng.state = st
    np.testing.assert_array_equal(eng.values(64), bfs_levels(64, edges, 0))
