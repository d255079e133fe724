"""The sharded engine (``repro_torch.dist.cca``) over ``LocalTiles`` on
the CPU against the JAX engine's single-device run.

``tests/test_dist_cca_parity.py``'s parity config (8x8, 64 vertices, 160
edges, chunk 32) is tiled over (2, 1) and (4, 2) meshes; after every
chunk every leaf of the gathered state equals, bit for bit, the JAX
engine's state after its frozen ``run_chunk``, with BFS equal to the
oracle (a lanes=2, rhizome_cap=2 variant and the fixed-length
``run_chunk_body`` are in ``tests/test_torch_dist_cca2.py``).  The plain
tile step (``ref.tile_step_ref``) runs the stage code of
``core.engine.cycle_body`` on a tile with its origin and owned window;
``tests/test_torch_dist_gloo.py`` runs the same over gloo processes,
``tests/test_torch_dist_kernel.py`` the kernel on the card.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.apps import BFS as J_BFS
from repro.core.config import EngineConfig as JConfig
from repro.core.engine import StreamingEngine as JEngine
from repro.core.engine import run_chunk as j_run_chunk
from repro.core.engine import run_chunk_body as j_run_chunk_body
from repro.core.ingest import load_stream as j_load
from repro.core.reference import bfs_levels
from repro_torch.core import BFS, StreamingEngine
from repro_torch.core.ingest import load_stream
from repro_torch.core.state import Tile, state_from_numpy, state_to_numpy
from repro_torch.dist import cca
from repro_torch.dist.sharding import cca_state_spec
from repro_torch.launch.dist_bench import scale_config
from repro_torch.launch.mesh import make_host_mesh

CHUNKS = 4   # the parity stream is quiescent after 3 (85 cycles)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_chunks(kw: dict, body: bool = False) -> list:
    """The JAX engine's state after each of ``CHUNKS`` chunks (numpy
    dicts), frozen ``run_chunk`` or (``body``) ``run_chunk_body``."""
    cfg0, edges = scale_config("ci")
    jeng = JEngine(JConfig(**{**{f.name: getattr(cfg0, f.name) for f in
                                 dataclasses.fields(cfg0)}, **kw}), "bfs")
    jeng.seed(0, 0.0)
    jcfg = jeng.cfg
    st, spill = j_load(jcfg, jeng.state, edges)
    assert len(spill) == 0
    out = []
    if body:
        f = jax.jit(lambda s: j_run_chunk_body(jcfg, J_BFS, s))
    for _ in range(CHUNKS):
        if body:
            st = f(st)
        else:
            st, _ = j_run_chunk(jcfg, J_BFS,
                                jax.tree.map(jnp.copy, st))
        out.append({k: np.asarray(v) for k, v in st._asdict().items()})
    return out


def port_state(kw: dict):
    cfg0, edges = scale_config("ci")
    eng = StreamingEngine(dataclasses.replace(cfg0, **kw), "bfs",
                          device="cpu")
    eng.seed(0, 0.0)
    st, spill = load_stream(eng.cfg, eng.state, edges)
    assert len(spill) == 0
    return eng, st, edges


def check_against(want: list, kw: dict, mesh_shape, run):
    eng, st, edges = port_state(kw)
    sst = cca.shard_state(eng.cfg, st, make_host_mesh(*mesh_shape,
                                                      device="cpu"))
    for k, w in enumerate(want):
        sst = run(eng.cfg, sst)
        got = state_to_numpy(cca.gather_state(sst))
        for name, a in w.items():
            np.testing.assert_array_equal(
                got[name], a, err_msg=f"chunk {k}: leaf {name!r}")
    eng.state = cca.gather_state(sst)
    np.testing.assert_array_equal(eng.values(), bfs_levels(64, edges, 0))
    return sst


def run_frozen(cfg, sst):
    return cca.run_chunk(cfg, BFS, sst)[0]


@pytest.fixture(scope="module")
def jax_parity():
    return jax_chunks({})


@pytest.mark.parametrize("mesh_shape", [(2, 1), (4, 2)])
def test_local_tiles_equal_jax_chunk_by_chunk(jax_parity, mesh_shape):
    sst = check_against(jax_parity, {}, mesh_shape, run_frozen)
    assert int(sst.gquiet) == 1
    # each rank's tile: its owned block and a halo two cells deep
    g = cca.Grid(8, 8, *mesh_shape)
    assert sst.grid == g and len(sst.tiles) == g.rows * g.cols
    assert tuple(sst.tiles[0].aq_n.shape) == g.shape
    assert sst.geoms[-1] == g.tile(g.rows * g.cols - 1)


def test_layout_follows_the_rule_but_io():
    """Per-cell leaves are tiled as ``cca_state_shardings`` says; the
    ``[IO]`` leaves, which the rule row-shards over the data group, are
    one whole copy a process, shared by its tiles (``dist/cca.py``)."""
    eng, st, _ = port_state({})
    mesh = make_host_mesh(4, 2, device="cpu")
    sst = cca.shard_state(eng.cfg, st, mesh)
    assert cca_state_spec(mesh, tuple(st.vals.shape)) == (
        "data", "model", None, None)
    assert cca_state_spec(mesh, tuple(st.io_edges.shape)) == (
        "data", "model", None)
    assert cca_state_spec(mesh, tuple(st.io_n.shape)) == ("data",)
    assert cca_state_spec(mesh, ()) == ()
    for t in sst.tiles:
        assert t.io_edges is sst.tiles[0].io_edges
        assert t.io_edges.shape == st.io_edges.shape
        assert t.vals.shape[:2] == (2 + 4, 4 + 4)
    # rank 5 (data 2, model 1) owns rows 4-5, columns 4-7
    t5, g5 = sst.tiles[5], sst.geoms[5]
    assert g5 == Tile(2, 2, 2, 4, 2, 6)
    assert torch.equal(t5.vals[2:4, 2:6], st.vals[4:6, 4:8])
    # the halo mirrors its owners; phantom cells off the grid stay empty
    assert torch.equal(t5.ch_n[0:2, 2:6], st.ch_n[2:4, 4:8])
    assert not sst.tiles[0].aq_n[:2].any()
    # counters: rank 0's the state's, the others' zero
    assert [int(t.stat_hops) for t in sst.tiles[1:]] == [0] * 7
    # refused: a mesh the grid does not tile, a state of another config's
    # shapes (every knob is carried: tests/test_torch_dist_engine.py)
    with pytest.raises(ValueError, match="does not tile"):
        cca.shard_state(eng.cfg, st, make_host_mesh(3, 1, device="cpu"))
    with pytest.raises(ValueError, match="tm_cell"):
        cca.shard_state(dataclasses.replace(eng.cfg, telemetry=True), st,
                        mesh)

