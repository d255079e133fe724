"""Expert parallelism over ``ProcessGroupTiles``: one gloo process a rank
on the CPU, the bf16 sum over ``model`` an ``all_reduce`` (the world,
``model`` being all of it at ``data`` 1), against the JAX package's
``_ffn_moe_ep`` (``tests/test_torch_moe_ep.py``'s cases "1x2" and
"1x2_f32", at its tolerances); and the transport's sums and gathers over
one mesh axis on subgroups, at (2, 2) over four processes.

Each rank of the EP test runs it twice, from the whole expert leaves and
from only its own block (``dist.sharding.shard_block`` by
``lm_param_shardings``' spec), the two equal bit for bit; on a (2, 1)
mesh over the same processes each routes its half of the batch and
returns what ``LocalTiles`` at (2, 1) returns, bit for bit.  The ranks are
spawned with a ``file://`` store and a timeout each, as in
``tests/test_torch_dist_gloo.py``.
"""
import textwrap

import numpy as np

from test_torch_dist_gloo import spawn
from test_torch_moe_ep import jax_ep, tolerance  # noqa: F401

EP_RANK = textwrap.dedent("""
    import dataclasses, sys
    import numpy as np
    import torch
    from repro_torch.configs import lm_archs
    from repro_torch.dist import ctx, sharding
    from repro_torch.dist.transport import ProcessGroupTiles
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer

    rank, world, init, ref, E, tol_bf16, tol_f32 = sys.argv[1:8]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    ref = dict(np.load(ref))
    tr = ProcessGroupTiles.connect(init, rank, world, backend="gloo",
                                   timeout_s=60)
    try:
        mesh = ctx.Mesh((1, world), ("data", "model"), tr)
        ctx.set_dist_mesh(mesh)
        lp = {k[6:]: torch.from_numpy(v) for k, v in ref.items()
              if k.startswith("param/")}
        block = dict(lp)
        for n in transformer.EXPERT_LEAVES:
            spec = sharding.lm_layer_spec(mesh, n, tuple(lp[n].shape))
            block[n] = sharding.shard_block(lp[n], mesh, spec, rank).clone()
            assert block[n].shape[0] == int(E) // world
        for name, dt, tol in (("1x2", torch.bfloat16, float(tol_bf16)),
                              ("1x2_f32", torch.float32, float(tol_f32))):
            cfg = dataclasses.replace(lm_archs._smoke(lm_archs.PHI35_MOE),
                                      n_experts=int(E), moe_impl="ep",
                                      compute_dtype=dt)
            x = torch.from_numpy(ref[f"{name}/x"]).to(dt)
            got, aux = transformer._ffn_moe_ep(cfg, lp, x)
            got_b, aux_b = transformer._ffn_moe_ep(cfg, block, x)
            assert torch.equal(got, got_b) and torch.equal(aux, aux_b)
            err = float(np.abs(got.float().numpy()
                               - ref[f"{name}/out"]).max())
            assert err <= tol, (name, err, tol)
        ctx.set_dist_mesh(ctx.Mesh((world, 1), ("data", "model"), tr))
        got, aux = transformer._ffn_moe_ep(cfg, lp, x)
        ctx.set_dist_mesh(make_host_mesh(world, 1, device="cpu"))
        want, waux = transformer._ffn_moe_ep(cfg, lp, x)
        assert torch.equal(got, want) and torch.equal(aux, waux)
    finally:
        ctx.set_dist_mesh(None)
        ProcessGroupTiles.close()
    print("RANK_OK", rank)
""")

AXIS_RANK = textwrap.dedent("""
    import sys
    import torch
    from repro_torch.dist import ctx
    from repro_torch.dist.transport import LocalTiles, ProcessGroupTiles

    rank, world, init = sys.argv[1:4]
    rank, world = int(rank), int(world)
    tr = ProcessGroupTiles.connect(init, rank, world, backend="gloo",
                                   timeout_s=60)
    try:
        local = ctx.Mesh((2, 2), ("data", "model"), LocalTiles(4, "cpu"))
        blocks = [torch.arange(6, dtype=torch.bfloat16).reshape(2, 3)
                  * (r + 1) for r in range(4)]
        mesh = ctx.Mesh((2, 2), ("data", "model"), tr)
        for axes in (("model",), ("data",), ("data", "model")):
            (s,) = tr.axis_sum(mesh, axes, [blocks[rank]])
            want = local.transport.axis_sum(local, axes, blocks)[rank]
            assert s.dtype == torch.bfloat16 and torch.equal(s, want), axes
            for dim in (0, 1):
                (g,) = tr.axis_gather(mesh, axes, [blocks[rank]], dim)
                want = local.transport.axis_gather(local, axes, blocks,
                                                   dim)[rank]
                assert torch.equal(g, want), (axes, dim)
    finally:
        ProcessGroupTiles.close()
    print("RANK_OK", rank)
""")


def test_ep_over_gloo_equals_jax(jax_ep, tmp_path):  # noqa: F811
    path = tmp_path / "ref.npz"
    np.savez(path, **jax_ep)
    spawn(EP_RANK, 2, tmp_path, str(path), "16",
          str(tolerance(jax_ep["1x2/out"], "bf16")),
          str(tolerance(jax_ep["1x2_f32/out"], "f32")))


def test_axis_sum_and_gather_on_subgroups(tmp_path):
    spawn(AXIS_RANK, 4, tmp_path)
