"""The port's step builders (``repro_torch.launch.steps``) against the JAX
package's (``repro.launch.steps``), on the CPU.

* Every registry (arch, shape) cell: the plan's ``args`` (meta tensors)
  equal JAX's ``build_plan`` args (``ShapeDtypeStruct``s on a 1 x 1 host
  mesh) leaf for leaf, by name, shape and dtype, with the same ``donate``
  and ``static_desc``; the LM params' sharding specs equal JAX's.
* One cell of each family at smoke size: real inputs of the plan's
  shapes, one ``step`` (a train step lowers the loss and changes every
  parameter the loss reaches; AdamW's step count becomes 1).
* The new modules import nothing of JAX or of the JAX package.
"""
import dataclasses
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as J_ARCHS
from repro.dist.ctx import set_dist_mesh as j_set_dist_mesh
from repro.launch import steps as jsteps
from repro.launch.mesh import make_host_mesh as j_mesh
from repro_torch.configs.base import shape
from repro_torch.configs.registry import ARCHS
from repro_torch.dist.ctx import set_dist_mesh
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_host_mesh

CELLS = [(a, s.name) for a in ARCHS for s in ARCHS[a].shapes]


def port_leaves(tree, prefix=""):
    """{name: leaf} of a port tree, named as JAX's paths print (dict keys
    sorted, NamedTuple fields ``.f``, sequences by index; None is no
    leaf)."""
    if tree is None:
        return {}
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = [("." + f, v) for f, v in zip(tree._fields, tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(port_leaves(v, f"{prefix}/{k}" if prefix else k))
    return out


def jax_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): leaf for path, leaf in flat}


@pytest.fixture(scope="module")
def meshes():
    yield j_mesh(1, 1), make_host_mesh(1, 1, device="cpu")
    # both packages' build_plan register their mesh: clear both, or a
    # later gcn forward in this process takes the partitioned branch
    set_dist_mesh(None)
    j_set_dist_mesh(None)


@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_plan_args_equal_jax(arch, shape_name, meshes):
    jm, tm = meshes
    jb = J_ARCHS[arch]
    js = next(s for s in jb.shapes if s.name == shape_name)
    tb = ARCHS[arch]
    ts = next(s for s in tb.shapes if s.name == shape_name)
    jp = jsteps.build_plan(jb, js, jm)
    tp = steps.build_plan(tb, ts, tm)
    assert tp.donate == jp.donate and tp.static_desc == jp.static_desc
    assert len(tp.args) == len(jp.args)
    got, want = port_leaves(tp.args), jax_leaves(jp.args)
    assert got.keys() == want.keys()
    for name, t in got.items():
        assert t.device.type == "meta", name
        assert tuple(t.shape) == tuple(want[name].shape), name
        assert str(t.dtype).split(".")[-1] == str(want[name].dtype), name
    if tb.family == "lm":        # the params' specs, padded to the rank
        for name, sh in jax_leaves(jp.in_shardings[0]).items():
            ndim = len(want["0/" + name].shape)
            got_spec = tuple(spec_of(tp.in_shardings[0], name))
            assert pad(got_spec, ndim) == pad(tuple(sh.spec), ndim), name


def pad(spec, ndim):
    return tuple(spec) + (None,) * (ndim - len(spec))


def spec_of(tree, name):
    node = tree
    for k in name.split("/"):
        node = node[int(k)] if isinstance(node, list) else node[k]
    return node


def make_like(meta, gen, high=None):
    if meta.dtype in (torch.int32, torch.int64):
        return torch.randint(0, high or 2, tuple(meta.shape), generator=gen,
                             dtype=meta.dtype)
    return torch.randn(tuple(meta.shape), generator=gen, dtype=meta.dtype) \
        * 0.02


def test_lm_train_plan_step_runs_at_smoke_size():
    from repro_torch.configs.base import ArchBundle
    b = ARCHS["llama3.2-1b"]
    cfg = b.smoke()
    bundle = ArchBundle(b.arch_id, "lm", cfg, (), b.smoke)
    spec = shape("t", "lm_train", seq_len=16, global_batch=2)
    plan = steps.build_plan(bundle, spec, make_host_mesh(1, 1, device="cpu"))
    set_dist_mesh(None)
    gen = torch.Generator().manual_seed(0)
    params = jax.tree.map(lambda m: make_like(m, gen), plan.args[0])
    params = jax.tree.map(lambda t: t + 1 if t.dim() == 1 else t, params)
    opt = steps.init_adamw(params)
    batch = {k: make_like(m, gen, cfg.vocab) for k, m in plan.args[2].items()}
    before = jax.tree.map(torch.clone, params)
    params2, opt2, loss, gnorm = plan.step(params, opt, batch)
    assert params2 is params and int(opt2.step) == 1
    assert np.isfinite(float(loss)) and float(gnorm) > 0
    changed = [not torch.equal(a, b) for a, b in zip(
        jax.tree.leaves(params), jax.tree.leaves(before))]
    assert all(changed)


def test_gnn_and_dlrm_plans_step_at_smoke_size():
    from repro_torch.configs.base import ArchBundle
    from repro_torch.data import graphs
    from repro_torch.data.pipeline import RecSysBatchSpec, recsys_batch
    mesh = make_host_mesh(1, 1, device="cpu")
    b = ARCHS["meshgraphnet"]
    cfg = dataclasses.replace(b.smoke(), d_in=4)
    spec = shape("t", "gnn_full", n_nodes=30, n_edges=90, d_feat=4)
    plan = steps.build_plan(ArchBundle(b.arch_id, "gnn", cfg, (), b.smoke),
                            spec, mesh)
    set_dist_mesh(None)
    g = graphs.build_graph(cfg, spec, np.random.default_rng(0), device="cpu")
    from repro_torch.models.gnn import init_gnn_params
    params = init_gnn_params(cfg, torch.Generator().manual_seed(0))
    batch = dict(graph=g, labels=torch.randn(30, cfg.d_out),
                 mask=torch.ones(30))
    _, opt, loss, _ = plan.step(params, steps.init_adamw(params), batch)
    assert int(opt.step) == 1 and np.isfinite(float(loss))

    b = ARCHS["dlrm-rm2"]
    cfg = b.smoke()
    plan = steps.build_plan(ArchBundle(b.arch_id, "recsys", cfg, (), b.smoke),
                            shape("t", "recsys_train", batch=8), mesh)
    set_dist_mesh(None)
    from repro_torch.models.dlrm import init_dlrm_params
    params = init_dlrm_params(cfg, torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v) for k, v in recsys_batch(RecSysBatchSpec(
        batch=8, n_dense=cfg.n_dense, n_sparse=cfg.n_sparse,
        lookups=cfg.lookups_per_field, vocab_sizes=cfg.resolved_vocabs()),
        0).items()}
    tables = [t.clone() for t in params["tables"]]
    _, opt, loss, _ = plan.step(params, steps.init_adamw(params), batch)
    assert int(opt.step) == 1 and np.isfinite(float(loss))
    assert any(not torch.equal(a, b) for a, b in zip(params["tables"],
                                                      tables))


def test_cca_plan_steps_the_engine():
    b = ARCHS["cca-streaming-bfs"]
    spec = shape("t", "cca_stream", height=4, width=4, n_vertices=32,
                 stream_edges=64)
    plan = steps.build_plan(b, spec, make_host_mesh(1, 1, device="cpu"))
    set_dist_mesh(None)
    from repro_torch.configs.cca_paper import engine_config_for
    from repro_torch.core.state import init_state
    ecfg = dataclasses.replace(engine_config_for(spec), chunk=8)
    st = init_state(ecfg, device="cpu")
    out = plan.step(st)
    assert port_leaves(out).keys() == port_leaves(plan.args[0]).keys()
    assert int(out.cycle) == int(st.cycle) + 8


def test_new_modules_import_nothing_of_jax_or_repro():
    code = ("import sys, repro_torch.optim.adamw, "
            "repro_torch.optim.compression, repro_torch.launch.steps, "
            "repro_torch.launch.train, repro_torch.train.elastic, "
            "repro_torch.data.graphs, repro_torch.kernels.flash_attention."
            "ops, repro_torch.kernels.spmm.ops, "
            "repro_torch.kernels.embedding_bag.ops; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.')]; print(bad); assert not bad")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True)
    assert r.returncode == 0, r.stdout + r.stderr
