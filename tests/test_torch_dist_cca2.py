"""The sharded engine over ``LocalTiles`` on the CPU against the JAX
engine, continued from ``tests/test_torch_dist_cca.py``: the parity config
at lanes=2, rhizome_cap=2 (every leaf after every frozen chunk), and the
fixed-length ``run_chunk_body`` against JAX's, both on a (2, 1) mesh.
"""
from test_torch_dist_cca import (check_against, jax_chunks,  # noqa: F401
                                 one_torch_thread, run_frozen)

from repro_torch.core import BFS
from repro_torch.dist import cca


def test_lanes_rhizome_tiles_equal_jax():
    kw = dict(lanes=2, rhizome_cap=2)
    check_against(jax_chunks(kw), kw, (2, 1), run_frozen)


def test_run_chunk_body_equals_jax():
    def body(cfg, sst):
        return cca.run_chunk_body(cfg, BFS, sst)
    check_against(jax_chunks({}, body=True), {}, (2, 1), body)
