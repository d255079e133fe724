"""Owner-partitioned SpMM (``repro_torch.graph.partition``) against the
JAX package's: ``partition_edges`` array for array, and
``spmm_partitioned`` over gloo (world size 4, one process a rank, each
holding its node block) within 2e-2 of JAX's ``spmm`` (the bf16 gather,
as ``tests/test_partitioned_spmm.py`` holds JAX's own) and within 1e-5 of
the port's plain ``spmm`` on the bf16-rounded features.  Over
``LocalTiles`` the gcn forward with a registered mesh equals the
unsharded forward within 2e-2.
"""
import dataclasses
import textwrap

import numpy as np
import pytest
import torch

from test_torch_dist_gloo import spawn

from repro_torch.dist.ctx import set_dist_mesh
from repro_torch.graph import partition
from repro_torch.graph.segment_ops import spmm
from repro_torch.launch.mesh import make_host_mesh

N, E, D = 64, 500, 16


def problem(seed=0):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N, E).astype(np.int32)
    dst = rng.integers(0, N, E).astype(np.int32)
    x = rng.standard_normal((N, D), dtype=np.float32)
    coeff = rng.standard_normal(E).astype(np.float32)
    return src, dst, x, coeff


def partitioned_coeff_of(src, dst, coeff, part):
    """The per-edge coefficients in ``part``'s layout (each bucket keeps
    its edges in their original order; padding 0)."""
    order = np.argsort(dst // (-(-N // 4)), kind="stable")
    out = np.zeros(part.shape[1], np.float32)
    real = part[1] != partition.PAD_DST
    out[real] = coeff[order]
    return out


@pytest.mark.parametrize("n, shards", [(40, 4), (64, 8), (10, 3)])
def test_partition_edges_equals_jax(n, shards):
    from repro.graph.partition import partition_edges as j_part
    rng = np.random.default_rng(n)
    ei = np.stack([rng.integers(0, n, 200), rng.integers(0, n, 200)]
                  ).astype(np.int32)
    got = partition.partition_edges(ei, n, shards)
    want = j_part(ei, n, shards)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


RANK = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    from repro_torch.dist.ctx import Mesh
    from repro_torch.dist.transport import ProcessGroupTiles
    from repro_torch.graph.partition import spmm_partitioned

    rank, world, init, data = sys.argv[1:5]
    rank, world = int(rank), int(world)
    a = np.load(data)
    tr = ProcessGroupTiles.connect(init, rank, world, backend="gloo",
                                   timeout_s=60)
    try:
        mesh = Mesh((world, 1), ("data", "model"), tr)
        n = a["x"].shape[0]
        blk = n // world
        x = torch.from_numpy(a["x"][rank * blk:(rank + 1) * blk])
        out = spmm_partitioned(x, torch.from_numpy(a["part"]), n,
                               torch.from_numpy(a["coeff"]), mesh)
        np.save(f"{data}.{rank}.npy", out.numpy())
    finally:
        ProcessGroupTiles.close()
    print("RANK_OK", rank)
""")


def test_spmm_partitioned_over_gloo(tmp_path):
    import jax.numpy as jnp
    from repro.graph.segment_ops import spmm as j_spmm
    src, dst, x, coeff = problem()
    part = partition.partition_edges(np.stack([src, dst]), N, 4)
    cpart = partitioned_coeff_of(src, dst, coeff, part)
    data = tmp_path / "problem.npz"
    np.savez(data, x=x, part=part, coeff=cpart)
    spawn(RANK, 4, tmp_path, str(data))
    got = np.concatenate([np.load(f"{data}.{r}.npy") for r in range(4)])
    want = np.asarray(j_spmm(jnp.asarray(x), jnp.stack([src, dst]), N,
                             jnp.asarray(coeff)))
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)
    xb = torch.from_numpy(x).to(torch.bfloat16).float()
    o = np.argsort(dst, kind="stable")
    ei = np.ascontiguousarray(np.stack([src, dst])[:, o])
    plain = spmm(xb, torch.from_numpy(ei), N,
                 torch.from_numpy(coeff[o]), "sum").numpy()
    np.testing.assert_allclose(got, plain, rtol=1e-5, atol=1e-5)


def test_gcn_forward_with_a_mesh_equals_unsharded():
    from repro_torch.configs import gnn_archs
    from repro_torch.models import gnn
    cfg = dataclasses.replace(gnn_archs.GCN_CORA, d_in=24)
    rng = np.random.default_rng(3)
    n = 96
    ei = np.stack([rng.integers(0, n, 700), rng.integers(0, n, 700)]
                  ).astype(np.int32)
    x = torch.from_numpy(rng.standard_normal((n, 24), dtype=np.float32))
    params = gnn.init_gnn_params(cfg, torch.Generator().manual_seed(1))
    want = gnn.gnn_forward(cfg, params, gnn.Graph(
        x=x, edge_index=torch.from_numpy(ei)))
    part = torch.from_numpy(partition.partition_edges(ei, n, 4))
    set_dist_mesh(make_host_mesh(4, 1, device="cpu"))
    try:
        got = gnn.gnn_forward(cfg, params, gnn.Graph(x=x, edge_index=part))
    finally:
        set_dist_mesh(None)
    torch.testing.assert_close(got, want, rtol=2e-2, atol=2e-2)
