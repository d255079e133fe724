"""The sharded engine over ``ProcessGroupTiles``: one gloo process a rank
on the CPU, the halo exchanged with ``batch_isend_irecv`` and the
quiescence flag and counters reduced with ``all_reduce``.

The parity config (``tests/test_dist_cca_parity.py``'s) at world size 2
((2, 1)) and 4 ((2, 2)): after every chunk every leaf of the gathered
state equals, bit for bit, the JAX engine's single-device state after its
frozen ``run_chunk``; BFS equals the oracle.  The ranks are spawned from a
fixture with a ``file://`` store in the test's temporary directory (no
port), each with its own timeout, so a hung rank fails the test.
"""
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from test_torch_dist_cca import CHUNKS, jax_chunks

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
RANK_TIMEOUT_S = 90

RANK = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    from repro_torch.core import BFS, StreamingEngine
    from repro_torch.core.ingest import load_stream
    from repro_torch.core.reference import bfs_levels
    from repro_torch.core.state import state_to_numpy
    from repro_torch.dist import cca
    from repro_torch.dist.ctx import Mesh
    from repro_torch.dist.transport import ProcessGroupTiles
    from repro_torch.launch.dist_bench import loaded_state

    rank, world, init, ref, rows, cols = sys.argv[1:7]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    tr = ProcessGroupTiles.connect(init, rank, world, backend="gloo",
                                   timeout_s=60)
    try:
        mesh = Mesh((int(rows), int(cols)), ("data", "model"), tr)
        cfg, app, st, edges = loaded_state("ci", "cpu")
        sst = cca.shard_state(cfg, st, mesh)
        assert len(sst.tiles) == 1 and sst.plan.peers
        want = np.load(ref)
        for k in range(int(want["chunks"])):
            sst, rec = cca.run_chunk(cfg, BFS, sst)
            got = state_to_numpy(cca.gather_state(sst))
            for name, a in got.items():
                np.testing.assert_array_equal(
                    a, want[f"{k}/{name}"],
                    err_msg=f"rank {rank} chunk {k}: leaf {name!r}")
        eng = StreamingEngine(cfg, "bfs", device="cpu")
        eng.state = cca.gather_state(sst)
        np.testing.assert_array_equal(eng.values(),
                                      bfs_levels(64, edges, 0))
        assert bool(cca.quiescent(sst))
    finally:
        ProcessGroupTiles.close()
    print("RANK_OK", rank)
""")


def spawn(script: str, world: int, tmp_path, *args) -> list:
    """Run ``script`` in ``world`` processes (argv: rank, world, the
    store's init method, ``args``); fail on a rank's error or timeout."""
    env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="",
               GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1")
    init = f"file://{tmp_path}/store"
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, str(r), str(world), init, *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            try:
                outs.append(p.communicate(timeout=RANK_TIMEOUT_S))
            except subprocess.TimeoutExpired:
                pytest.fail(f"a rank hung past {RANK_TIMEOUT_S}s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (o, e)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"RANK_OK {r}" in o, \
            f"rank {r} (rc {p.returncode}):\n{o[-2000:]}\n{e[-4000:]}"
    return [o for o, _ in outs]


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("ref") / "jax.npz"
    want = jax_chunks({})
    np.savez(path, chunks=CHUNKS, **{f"{k}/{n}": a for k, w in
                                     enumerate(want) for n, a in w.items()})
    return path


@pytest.mark.parametrize("world, rows, cols", [(2, 2, 1), (4, 2, 2)])
def test_process_group_tiles_equal_jax(jax_ref, tmp_path, world, rows, cols):
    spawn(RANK, world, tmp_path, str(jax_ref), str(rows), str(cols))


def test_transport_refuses_without_a_group():
    import torch.distributed as dist
    from repro_torch.dist.transport import ProcessGroupTiles
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        ProcessGroupTiles()
