"""The cycle kernel's tile mode on the card, against the plain tile step.

A CUDA kernel has no CPU mode, so these tests carry the ``gpu`` marker and
skip (from a fixture) where there is no card; ``chip_smoke.py`` runs the
same comparisons on the card.  The JAX parity config (8x8, 64 vertices,
160 edges, chunk 32; ``launch.dist_bench``'s ci scale) sharded over every
mesh of the smoke's phase (a), on the cluster kernel and the one-block
kernel: chunk by chunk, every leaf of the gathered state equal to the
plain tile version's (``LocalTiles`` on the CPU) and to the unsharded
kernel run's, exactly, and every tile step one launch of the tile
instance.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import BFS, EngineConfig
from repro_torch.core.engine import run_chunk
from repro_torch.core.reference import bfs_levels
from repro_torch.core.state import Tile, init_state
from repro_torch.dist import cca
from repro_torch.kernels.cca_cycle import ops
from repro_torch.launch.dist_bench import loaded_state
from repro_torch.launch.mesh import make_host_mesh

pytestmark = pytest.mark.gpu
MESHES = [(2, 1), (4, 1), (8, 1), (2, 2), (4, 2)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU "
                    "mode (chip_smoke.py runs these comparisons there)")
    return torch.device("cuda")


def same(a, b, where):
    for name in a._fields:
        x, y = getattr(a, name).cpu(), getattr(b, name).cpu()
        assert torch.equal(x, y), f"{where}: leaf {name!r} differs"


@pytest.mark.parametrize("path", ["cluster", "block"])
@pytest.mark.parametrize("mesh_shape", MESHES)
def test_tiles_equal_plain_and_unsharded(card, mesh_shape, path):
    cfg, app, st, edges = loaded_state("ci", card)
    plain_st = st._replace(**{k: v.cpu() for k, v in
                              st._asdict().items()})
    one = st._replace(**{k: v.clone() for k, v in st._asdict().items()})
    k_sst = cca.shard_state(cfg, st, make_host_mesh(*mesh_shape,
                                                    device=card))
    p_sst = cca.shard_state(cfg, plain_st, make_host_mesh(*mesh_shape,
                                                          device="cpu"))
    before = ops.tile_launches_by_path()
    chunks = 0
    for chunk in range(70):
        k_sst, kr = cca.run_chunk(cfg, app, k_sst, path=path)
        p_sst, pr = cca.run_chunk(cfg, app, p_sst, path=path)
        one, r1 = run_chunk(cfg, app, one)
        chunks += 1
        got = cca.gather_state(k_sst)
        same(got, cca.gather_state(p_sst), f"chunk {chunk} vs plain")
        same(got, one, f"chunk {chunk} vs unsharded")
        assert kr.tolist() == pr.tolist() == r1.tolist()
        if kr[0]:
            break
    assert bool(kr[0]), "did not quiesce"
    n = mesh_shape[0] * mesh_shape[1]
    now = ops.tile_launches_by_path()
    got = {p: now[p] - before[p] for p in ops.PATHS}
    assert got == {p: (n * chunks * cfg.chunk if p == path else 0)
                   for p in ops.PATHS}
    # vertex i's root: slot i // 64 of cell i % 64
    vals = cca.gather_state(k_sst).vals[..., 0].cpu().numpy()
    v = np.array([vals[i % 64 // 8, i % 8, i // 64] for i in range(64)])
    np.testing.assert_array_equal(v, bfs_levels(64, edges, 0))


def test_tile_step_refuses_what_it_does_not_carry(card):
    """Every knob is carried (``tests/test_torch_dist_kernel2.py``); what
    a tile step still refuses is a state of another config's shapes, a
    trace that is not its one row and a record of the wrong shape."""
    cfg = EngineConfig(height=8, width=8, n_vertices=64, chunk=8,
                       telemetry=True)
    st = init_state(cfg, device=card)
    tile = Tile(0, 0, 0, 8, 0, 8)
    q = torch.zeros((), dtype=torch.int32, device=card)
    rec = torch.zeros(8, dtype=torch.int32, device=card)
    plain = EngineConfig(height=8, width=8, n_vertices=64, chunk=8)
    with pytest.raises(ValueError, match="tm_cell"):
        ops.cca_tile_step(cfg, BFS, init_state(plain, device=card), tile, q,
                          rec)
    with pytest.raises(ValueError, match="trace"):
        ops.cca_tile_step(cfg, BFS, st, tile, q, rec,
                          trace=torch.zeros((2, 2), dtype=torch.int32,
                                            device=card))
    with pytest.raises(ValueError):
        ops.cca_tile_step(cfg, BFS, st, tile, q,
                          torch.zeros(7, dtype=torch.int32, device=card))
    ops.cca_tile_step(cfg, BFS, st, tile, q, rec)
    assert rec[6].item() == 1
