"""The port's distribution helpers against the JAX package's
(``repro_torch.dist.{ctx,sharding,pipeline}``, ``launch.mesh``).

Every sharding rule's specs equal JAX's ``NamedSharding.spec``, leaf by
leaf, on the same shapes and on meshes (1, 1), (4, 2) and (2, 2): the JAX
side runs in one subprocess with 8 fake host devices (the device count
locks at JAX's first init), as ``tests/test_dist_cca_parity.py`` does.
The sequential ``pipelined_apply`` equals JAX's ``mesh=None`` branch
within 1e-6.
"""
import json
import os
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest
import torch

from repro_torch.core import EngineConfig
from repro_torch.core.state import init_state
from repro_torch.dist import ctx, sharding
from repro_torch.dist.ctx import Mesh
from repro_torch.dist.pipeline import pipelined_apply, split_stages
from repro_torch.launch.mesh import dp_axes, make_host_mesh

MESHES = [(1, 1), (4, 2), (2, 2)]
CFG = dict(height=8, width=8, n_vertices=64, ghost_slots=16,
           io_stream_cap=256, chunk=32)
L_, D_, F_, V_, E_, H_ = 4, 64, 96, 1000, 8, 6
LM_SHAPES = {
    "embed": [V_, D_], "unembed": [D_, V_], "final_norm": [D_],
    "layers": {"wq": [L_, D_, H_ * 16], "wk": [L_, D_, 32],
               "wv": [L_, D_, 32], "wo": [L_, H_ * 16, D_],
               "ffn_wi": [L_, D_, F_], "ffn_wg": [L_, D_, F_],
               "ffn_wo": [L_, F_, D_], "moe_wi": [L_, E_, D_, F_],
               "moe_wg": [L_, E_, D_, F_], "moe_wo": [L_, E_, F_, D_],
               "router": [L_, D_, E_], "ln1": [L_, D_], "ln2": [L_, 7]},
}
GNN_PARAMS = {"w": [[16, 16], [16, 7]], "b": [[16], [7]]}
GRAPH = {"x": [64, 16], "edge_index": [2, 400], "e": [400, 3],
         "mesh_edge_index": [2, 96], "g2m_edge_index": None}
DLRM = {"tables": [[1000, 16], [999, 16], [64, 16], [7, 16]],
        "bot": [{"w": [13, 16], "b": [16]}], "top": [{"w": [32, 1],
                                                       "b": [1]}]}
RESOLVE = [([5, 8], ["pipe", "model"]), ([8, 8], ["dp", "model"]),
           ([8, 6], ["dp", "model"]), ([16, 3], [["data", "model"], None]),
           ([12, 4], [["dp", "model"], None]), ([4, 4], [None, "data"]),
           ([6, 10], ["model", "dp"])]

JAX_SCRIPT = textwrap.dedent("""
    import os, json, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import functools, types
    import jax, jax.numpy as jnp
    from repro.core.config import EngineConfig
    from repro.core.state import init_state
    from repro.dist import ctx, sharding
    from repro.launch.mesh import make_host_mesh

    arg = json.loads(sys.stdin.read())

    def tree(t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: tree(v) for k, v in t.items()}
        if t and isinstance(t[0], (list, dict)):
            return [tree(v) for v in t]
        return jax.ShapeDtypeStruct(tuple(t), jnp.float32)

    def spec(p):
        return [list(e) if isinstance(e, tuple) else e for e in p]

    def specs(t):
        return jax.tree.map(lambda s: spec(s.spec), t,
                            is_leaf=lambda x: hasattr(x, "spec"))

    out = {}
    cfg = EngineConfig(**arg["cfg"])
    st = jax.eval_shape(functools.partial(init_state, cfg))
    for d, m in arg["meshes"]:
        mesh = make_host_mesh(d, m)
        o = out[f"{d}x{m}"] = {}
        o["cca"] = {k: spec(v.spec) for k, v in
                    sharding.cca_state_shardings(mesh, st)._asdict().items()}
        o["resolve"] = [spec(ctx.resolve_spec(mesh, s, [
            tuple(e) if isinstance(e, list) else e for e in a]))
            for s, a in arg["resolve"]]
        o["lm"] = specs(sharding.lm_param_shardings(mesh, tree(arg["lm"])))
        o["lm_batch"] = specs(sharding.lm_batch_shardings(mesh))
        o["lm_cache"] = [specs(sharding.lm_cache_shardings(
            mesh, types.SimpleNamespace(n_kv_heads=kv), b))
            for kv, b in ((2, 8), (3, 1), (4, 6))]
        o["gnn_params"] = specs(sharding.gnn_param_shardings(
            mesh, tree(arg["gnn"])))
        o["gnn_graph"] = specs(sharding.gnn_graph_shardings(
            mesh, tree(arg["graph"])))
        o["gnn_axes"] = list(sharding.gnn_axes(mesh))
        o["dlrm"] = specs(sharding.dlrm_param_shardings(
            mesh, tree(arg["dlrm"])))
        o["dlrm_batch"] = [specs(sharding.dlrm_batch_shardings(mesh, c))
                           for c in (False, True)]
        o["model_size"] = ctx.model_size(mesh)
        o["dp_axes"] = list(ctx.dp_axes_active(mesh))
    out["pad_to"] = [sharding.pad_to(n, m) for n, m in
                     ((5, 4), (8, 4), (3, 1), (0, 4), (7, 0), (9, 3))]
    print("SPECS" + json.dumps(out))
""")


@pytest.fixture(scope="module")
def jax_specs():
    arg = dict(cfg=CFG, meshes=MESHES, resolve=RESOLVE, lm=LM_SHAPES,
               gnn=GNN_PARAMS, graph=GRAPH, dlrm=DLRM)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", JAX_SCRIPT],
                       input=json.dumps(arg), capture_output=True, text=True,
                       timeout=300, env=env)
    line = [x for x in r.stdout.splitlines() if x.startswith("SPECS")]
    assert line, r.stdout[-2000:] + r.stderr[-3000:]
    return json.loads(line[0][5:])


def meta(t):
    if t is None:
        return None
    if isinstance(t, dict):
        return {k: meta(v) for k, v in t.items()}
    if t and isinstance(t[0], (list, dict)):
        return [meta(v) for v in t]
    return torch.empty(t, device="meta")


def as_json(tree):
    """Specs (tuples of entries) as the JSON of the JAX side."""
    def spec(s):
        return [list(e) if isinstance(e, tuple) else e for e in s]
    if isinstance(tree, dict):
        return {k: as_json(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [as_json(v) for v in tree]
    return spec(tree)


@pytest.mark.parametrize("shape", MESHES)
def test_sharding_rules_equal_jax(jax_specs, shape):
    want = jax_specs[f"{shape[0]}x{shape[1]}"]
    mesh = make_host_mesh(*shape, device="cpu")
    st = init_state(EngineConfig(**CFG), device="meta")
    got = {k: as_json(v) for k, v in
           sharding.cca_state_shardings(mesh, st)._asdict().items()}
    assert got == want["cca"]
    assert [as_json(ctx.resolve_spec(mesh, s, [
        tuple(e) if isinstance(e, list) else e for e in a]))
        for s, a in RESOLVE] == want["resolve"]
    assert as_json(sharding.lm_param_shardings(mesh, meta(LM_SHAPES))) \
        == want["lm"]
    assert as_json(sharding.lm_batch_shardings(mesh)) == want["lm_batch"]
    assert [as_json(list(sharding.lm_cache_shardings(
        mesh, types.SimpleNamespace(n_kv_heads=kv), b)))
        for kv, b in ((2, 8), (3, 1), (4, 6))] == want["lm_cache"]
    assert as_json(sharding.gnn_param_shardings(mesh, meta(GNN_PARAMS))) \
        == want["gnn_params"]
    assert as_json(sharding.gnn_graph_shardings(mesh, meta(GRAPH))) \
        == want["gnn_graph"]
    assert list(sharding.gnn_axes(mesh)) == want["gnn_axes"]
    assert as_json(sharding.dlrm_param_shardings(mesh, meta(DLRM))) \
        == want["dlrm"]
    assert [as_json(sharding.dlrm_batch_shardings(mesh, c))
            for c in (False, True)] == want["dlrm_batch"]
    assert ctx.model_size(mesh) == want["model_size"]
    assert list(ctx.dp_axes_active(mesh)) == want["dp_axes"]
    assert dp_axes(mesh) == ("data",)


def test_pad_to_and_registry(jax_specs):
    assert [sharding.pad_to(n, m) for n, m in
            ((5, 4), (8, 4), (3, 1), (0, 4), (7, 0), (9, 3))] \
        == jax_specs["pad_to"]
    ctx.set_dist_mesh(None)
    x = torch.ones(4, 6)
    assert ctx.constrain(x, "dp", "model") is x
    assert ctx.model_size() == 1 and ctx.dp_axes_active() == ("data",)
    mesh = Mesh((2, 4), ("data", "model"))
    ctx.set_dist_mesh(mesh)
    try:
        assert ctx.get_dist_mesh() is mesh
        assert ctx.constrain(x, "dp", "model") is x
        assert ctx.model_size() == 4
        with pytest.raises(ValueError):
            ctx.constrain(x, "dp")
    finally:
        ctx.set_dist_mesh(None)
    assert [mesh.coords(r) for r in (0, 5, 7)] == [
        dict(data=0, model=0), dict(data=1, model=1), dict(data=1, model=3)]
    assert mesh.local_ranks == tuple(range(8)) and mesh.size == 8
    pod = Mesh((2, 2, 2), ("pod", "data", "model"))
    assert ctx.dp_axes_active(pod) == ("pod", "data")
    assert dp_axes(pod) == ("pod", "data")
    assert ctx.resolve_spec(pod, (8, 6), ("dp", "model")) == (
        ("pod", "data"), "model")


def test_split_stages_shapes():
    p = dict(w=torch.arange(8 * 3 * 3, dtype=torch.float32).reshape(8, 3, 3),
             b=torch.arange(8.0))
    s = split_stages(p, 4)
    assert s["w"].shape == (4, 2, 3, 3) and s["b"].shape == (4, 2)
    assert torch.equal(s["w"][1, 0], p["w"][2])
    with pytest.raises(ValueError):
        split_stages(p, 3)


def pipeline_net(seed=0, L=8, D=16, n_micro=6, micro=4):
    """``tests/test_pipeline_parallel.py``'s network (8 tanh layers, D 16,
    6 microbatches of 4), its weights and inputs from numpy."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((L, D, D)) * 0.3).astype(np.float32)
    b = (rng.standard_normal((L, D)) * 0.1).astype(np.float32)
    xs = rng.standard_normal((n_micro, micro, D)).astype(np.float32)
    return w, b, xs


def torch_stage(p, x):
    for l in range(p["w"].shape[0]):
        x = torch.tanh(x @ p["w"][l] + p["b"][l])
    return x


def test_pipelined_apply_sequential_matches_jax():
    import jax
    import jax.numpy as jnp
    from repro.dist.pipeline import pipelined_apply as j_apply
    from repro.dist.pipeline import split_stages as j_split
    w, b, xs = pipeline_net()

    def j_stage(p, x):
        def body(x, lp):
            return jnp.tanh(x @ lp["w"] + lp["b"]), None
        x, _ = jax.lax.scan(body, x, p)
        return x

    want = np.asarray(j_apply(j_stage, j_split(dict(w=jnp.asarray(w),
                                                    b=jnp.asarray(b)), 4),
                              jnp.asarray(xs), mesh=None))
    stages = split_stages(dict(w=torch.from_numpy(w), b=torch.from_numpy(b)),
                          4)
    got = pipelined_apply(torch_stage, stages, torch.from_numpy(xs),
                          mesh=None)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # a mesh without the pipe axis runs the same loop
    got2 = pipelined_apply(torch_stage, stages, torch.from_numpy(xs),
                           make_host_mesh(2, 1, device="cpu"))
    assert torch.equal(got, got2)
    # the tick schedule over LocalTiles equals it
    pipe = Mesh((4,), ("pipe",), make_host_mesh(4, 1, device="cpu")
                .transport)
    got3 = pipelined_apply(torch_stage, stages, torch.from_numpy(xs), pipe)
    assert torch.equal(got, got3)
    with pytest.raises(ValueError):
        pipelined_apply(torch_stage, split_stages(stages_of(w, b), 2),
                        torch.from_numpy(xs), pipe)


def stages_of(w, b):
    return dict(w=torch.from_numpy(w), b=torch.from_numpy(b))


def test_freeze_is_global_and_the_loop_reads_once_a_chunk():
    """The sharded engine over ``LocalTiles`` (2, 1) on the parity config:
    a tile quiescent alone keeps stepping (the flag is the grid's), every
    tile's cycle moves together, and ``run_to_quiescence`` ends where the
    unsharded engine's increment does, with its counters."""
    from repro_torch.core import BFS, StreamingEngine
    from repro_torch.core.engine import quiescent as tile_quiescent
    from repro_torch.dist import cca
    from repro_torch.launch.dist_bench import loaded_state, scale_config
    cfg, app, st, edges = loaded_state("ci", "cpu")
    sst = cca.shard_state(cfg, st, make_host_mesh(2, 1, device="cpu"))
    alone = 0
    while not bool(sst.gquiet):
        local = [bool(tile_quiescent(t, g))
                 for t, g in zip(sst.tiles, sst.geoms)]
        sst, _ = cca.run_chunk(cfg, BFS, sst, n_cycles=1)
        alone += any(local) and not all(local)
        assert len({int(t.cycle) for t in sst.tiles}) == 1
    assert alone > 0, "no tile was ever quiescent alone"
    cfg, app, st2, _ = loaded_state("ci", "cpu")
    sst2 = cca.shard_state(cfg, st2, make_host_mesh(2, 1, device="cpu"))
    cycles, q, noprog, counters = cca.run_to_quiescence(cfg, BFS, sst2)
    eng = StreamingEngine(scale_config("ci")[0], "bfs", device="cpu")
    eng.seed(0, 0.0)
    want = eng.run_increment(edges)
    assert q and noprog == 0
    assert (cycles, *counters) == (want.cycles, want.hops, want.execs,
                                   want.stalls, want.allocs) == (
        int(sst.tiles[0].cycle), *cca.counters(sst)[1:].tolist())
