"""The GPipe schedule of ``repro_torch.dist.pipelined_apply`` over gloo:
4 stages, one process a stage, activations sent stage to stage a tick and
the last stage's outputs broadcast, on ``tests/test_pipeline_parallel.py``'s
network (8 tanh layers, D 16, 6 microbatches of 4; weights and inputs from
numpy).  Every rank's outputs equal the port's sequential branch and JAX's
``mesh=None`` branch within 1e-6 (JAX's meshed branch is red in the seed
and is not the reference).
"""
import textwrap

import numpy as np
import torch

from test_torch_dist import pipeline_net, torch_stage
from test_torch_dist_gloo import spawn

from repro_torch.dist.pipeline import pipelined_apply, split_stages

RANK = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    from repro_torch.dist.ctx import Mesh
    from repro_torch.dist.pipeline import pipelined_apply, split_stages
    from repro_torch.dist.transport import ProcessGroupTiles

    rank, world, init, out = sys.argv[1:5]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((8, 16, 16)) * 0.3).astype(np.float32)
    b = (rng.standard_normal((8, 16)) * 0.1).astype(np.float32)
    xs = torch.from_numpy(rng.standard_normal((6, 4, 16)).astype(np.float32))

    def stage(p, x):
        for l in range(p["w"].shape[0]):
            x = torch.tanh(x @ p["w"][l] + p["b"][l])
        return x

    tr = ProcessGroupTiles.connect(init, rank, world, backend="gloo",
                                   timeout_s=60)
    try:
        mesh = Mesh((world,), ("pipe",), tr)
        stages = split_stages(dict(w=torch.from_numpy(w),
                                   b=torch.from_numpy(b)), world)
        got = pipelined_apply(stage, stages, xs, mesh)
        np.save(f"{out}.{rank}.npy", got.numpy())
    finally:
        ProcessGroupTiles.close()
    print("RANK_OK", rank)
""")


def test_gpipe_over_gloo_equals_sequential(tmp_path):
    import jax
    import jax.numpy as jnp
    from repro.dist.pipeline import pipelined_apply as j_apply
    from repro.dist.pipeline import split_stages as j_split
    spawn(RANK, 4, tmp_path, str(tmp_path / "out"))
    w, b, xs = pipeline_net()
    seq = pipelined_apply(torch_stage, split_stages(
        dict(w=torch.from_numpy(w), b=torch.from_numpy(b)), 4),
        torch.from_numpy(xs), mesh=None).numpy()

    def j_stage(p, x):
        def body(x, lp):
            return jnp.tanh(x @ lp["w"] + lp["b"]), None
        return jax.lax.scan(body, x, p)[0]

    want = np.asarray(j_apply(j_stage, j_split(dict(w=jnp.asarray(w),
                                                    b=jnp.asarray(b)), 4),
                              jnp.asarray(xs), mesh=None))
    for r in range(4):
        got = np.load(tmp_path / f"out.{r}.npy")
        np.testing.assert_allclose(got, seq, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
