"""Step builders: per (arch x shape) step functions, abstract inputs and
their shardings (the port of ``repro.launch.steps``).

``build_plan(bundle, spec, mesh)`` returns a ``StepPlan``: ``step``, a
runnable torch function of the port; ``args``, its inputs as
``torch.device("meta")`` tensors in the structure ``step`` takes (the
port's ``ShapeDtypeStruct``: shape and dtype, no storage); and
``in_shardings``, the port's ``dist.sharding`` specs of those inputs, in
the same structure.  A caller makes real inputs of ``args``' shapes on a
device and calls ``step`` on them.

The train steps (``lm_train``, ``gnn_*``, ``recsys_train``) are JAX's
``value_and_grad`` then ``adamw_update``: the loss is differentiated
through the port's kernels' autograd Functions (``torch.autograd.grad``
over the parameter leaves), and AdamW writes the parameters and the
moments in place and returns them.  What has no counterpart on a GPU is
dropped, with its reason:

* ``jit`` and the trace: PyTorch runs eagerly, so ``step`` is the
  function itself;
* ``donate`` stays a field (JAX's buffer donation of the params and the
  optimizer state): the port's step updates those tensors in place, which
  is what donation buys, so nothing reads the field;
* ``in_shardings`` are spec tuples.  The ``lm_prefill`` and
  ``lm_decode`` steps place their inputs by them (JAX's ``jit`` with
  ``in_shardings``): on a mesh of more than one rank with a transport,
  each input given whole is laid out for this process's ranks
  (``dist.sharding.lay_out``; one already ``Placed`` is taken as it is)
  and the step runs over the mesh, its outputs ``Placed``.  The other
  steps place nothing (``dist.ctx.constrain`` is an identity): their
  specs say where each input would lie on the mesh.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import ArchBundle, ShapeSpec
from repro_torch.dist import ctx as dist_ctx
from repro_torch.dist.sharding import (cca_state_shardings,
                                       dlrm_batch_shardings,
                                       dlrm_param_shardings, gnn_axes,
                                       gnn_graph_shardings,
                                       gnn_param_shardings,
                                       lm_batch_shardings, lm_cache_shardings,
                                       lm_param_shardings, lay_out, pad_to,
                                       Placed, tree_leaves, tree_map)
from repro_torch.launch.mesh import dp_axes
from repro_torch.models.transformer import lm_params_meta
from repro_torch.optim.adamw import AdamWConfig, adamw_update, init_adamw

META = torch.device("meta")


class StepPlan(NamedTuple):
    step: callable
    args: tuple          # meta-tensor trees
    in_shardings: tuple
    donate: tuple = ()
    static_desc: str = ""


class MetaGenerator(torch.Generator):
    """A generator whose ``device`` is meta: the models' ``init_*``
    functions draw on ``gen.device``, so under it they make meta leaves of
    the right shapes and dtypes and allocate nothing."""
    device = META


def _sds(shape, dtype):
    return torch.empty(shape, dtype=dtype, device=META)


def _rep(tree):
    return tree_map(lambda l: (None,) * l.dim(), tree)


def value_and_grad(loss_fn, params, batch):
    """(loss, grads in params' structure) of ``loss_fn(params, batch)``:
    the parameter leaves are made to require grad (in place), and the
    gradients come from one ``torch.autograd.grad``; a leaf the loss does
    not reach gets zeros, as from ``jax.grad``."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = loss_fn(params, batch)
    grads = iter(torch.autograd.grad(loss, leaves, materialize_grads=True))
    return loss.detach(), tree_map(lambda _: next(grads), params)


def train_step(loss_fn, opt_cfg: AdamWConfig):
    """``step(params, opt, batch) -> (params, opt, loss, gnorm)``."""
    def step(params, opt, batch):
        loss, grads = value_and_grad(loss_fn, params, batch)
        params, opt, gnorm = adamw_update(opt_cfg, grads, opt, params)
        return params, opt, loss, gnorm
    return step


# ------------------------------------------------------------------ LM ---

def _lm_cfg(bundle, overrides):
    cfg = bundle.config
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, moe_impl="ep")
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def _opt_shardings(pshard):
    from repro_torch.optim.adamw import AdamWState
    return AdamWState(step=(), m=pshard, v=pshard)


def _lm_train_plan(bundle: ArchBundle, spec: ShapeSpec, mesh,
                   overrides=None) -> StepPlan:
    from repro_torch.models.transformer import lm_loss
    cfg = _lm_cfg(bundle, overrides)
    B = spec.dim("global_batch")
    T = spec.dim("seq_len")
    params_shape = lm_params_meta(cfg)
    opt_shape = init_adamw(params_shape)
    batch = dict(tokens=_sds((B, T), torch.int32),
                 targets=_sds((B, T), torch.int32))
    step = train_step(lambda p, b: lm_loss(cfg, p, b), AdamWConfig())
    pshard = lm_param_shardings(mesh, params_shape)
    return StepPlan(step, (params_shape, opt_shape, batch),
                    (pshard, _opt_shardings(pshard),
                     lm_batch_shardings(mesh)),
                    donate=(0, 1), static_desc=f"{cfg.name} train B{B} T{T}")


def _on_mesh(mesh, fn, args: tuple, shardings: tuple):
    """``fn(*args)``: on a mesh of more than one rank with a transport,
    over it (registered for the call), each argument laid out by its
    shardings unless it is ``Placed`` already; otherwise as given."""
    if mesh.transport is None or mesh.size == 1:
        return fn(*args)
    args = tuple(a if isinstance(a, Placed) else lay_out(a, mesh, s)
                 for a, s in zip(args, shardings))
    before = dist_ctx.get_dist_mesh()
    dist_ctx.set_dist_mesh(mesh)
    try:
        return fn(*args)
    finally:
        dist_ctx.set_dist_mesh(before)


def _lm_prefill_plan(bundle, spec, mesh, overrides=None) -> StepPlan:
    from repro_torch.models.transformer import lm_last_logits
    cfg = _lm_cfg(bundle, overrides)
    B, T = spec.dim("global_batch"), spec.dim("seq_len")
    params_shape = lm_params_meta(cfg)
    batch = dict(tokens=_sds((B, T), torch.int32))

    shardings = (lm_param_shardings(mesh, params_shape),
                 dict(tokens=(dp_axes(mesh), None)))

    @torch.no_grad()
    def step(params, batch):
        # serving returns the last token's logits (lm_forward's [:, -1])
        return _on_mesh(mesh, lambda p, t: lm_last_logits(cfg, p, t),
                        (params, batch["tokens"]),
                        (shardings[0], shardings[1]["tokens"]))

    return StepPlan(step, (params_shape, batch), shardings,
                    static_desc=f"{cfg.name} prefill B{B} T{T}")


def _lm_decode_plan(bundle, spec, mesh, overrides=None) -> StepPlan:
    from repro_torch.models.transformer import lm_decode_step
    cfg = dataclasses.replace(_lm_cfg(bundle, overrides), remat=False)
    B, T = spec.dim("global_batch"), spec.dim("seq_len")
    params_shape = lm_params_meta(cfg)
    kv = (cfg.n_layers, B, T, cfg.n_kv_heads, cfg.dh)
    cache_shape = (_sds(kv, torch.bfloat16), _sds(kv, torch.bfloat16))
    toks = _sds((B, 1), torch.int32)
    lens = _sds((B,), torch.int32)

    dp = dp_axes(mesh)
    tok_spec = (dp, None) if B > 1 else (None, None)
    len_spec = (dp,) if B > 1 else (None,)
    shardings = (lm_param_shardings(mesh, params_shape), tok_spec,
                 lm_cache_shardings(mesh, cfg, B), len_spec)

    @torch.no_grad()
    def step(params, tokens, cache, lengths):
        return _on_mesh(mesh, lambda *a: lm_decode_step(cfg, *a),
                        (params, tokens, cache, lengths), shardings)

    return StepPlan(
        step, (params_shape, toks, cache_shape, lens), shardings,
        donate=(2,), static_desc=f"{cfg.name} decode B{B} KV{T}")


# ----------------------------------------------------------------- GNN ---

def _gnn_graph_specs(cfg, spec, mesh):
    """Padded abstract Graph + its node count for a shape spec."""
    from repro_torch.data.graphs import graphcast_sizes, \
        sampled_subgraph_sizes
    from repro_torch.models.gnn import Graph
    d = dict(spec.dims)
    mult = int(np.prod([mesh.shape[a] for a in gnn_axes(mesh)]))
    if spec.kind == "gnn_minibatch":
        n, e = sampled_subgraph_sizes(d)
    elif spec.kind == "gnn_batched":
        n, e = d["batch"] * d["n_nodes"], d["batch"] * d["n_edges"]
    else:
        n, e = d["n_nodes"], d["n_edges"]
    n, e = pad_to(n, mult), pad_to(e, mult)
    cfg = dataclasses.replace(cfg, d_in=d["d_feat"])
    fields = dict(x=_sds((n, d["d_feat"]), torch.float32),
                  edge_index=_sds((2, e), torch.int32))
    if cfg.kind == "graphcast":
        gs = graphcast_sizes(cfg, n)
        fields.update(
            mesh_edge_index=_sds((2, pad_to(gs["e_mesh"], mult)),
                                 torch.int32),
            g2m_edge_index=_sds((2, pad_to(gs["e_g2m"], mult)), torch.int32),
            m2g_edge_index=_sds((2, pad_to(gs["e_m2g"], mult)), torch.int32))
    return cfg, Graph(**fields), n


def _gnn_train_plan(bundle, spec, mesh) -> StepPlan:
    from repro_torch.models.gnn import gnn_loss, init_gnn_params
    cfg, graph, n = _gnn_graph_specs(bundle.config, spec, mesh)
    regression = cfg.kind in ("graphcast", "meshgraphnet")
    labels = _sds((n, cfg.d_out), torch.float32) if regression \
        else _sds((n,), torch.int32)
    mask = _sds((n,), torch.float32)
    params_shape = init_gnn_params(cfg, MetaGenerator())
    opt_shape = init_adamw(params_shape)
    step = train_step(lambda p, b: gnn_loss(cfg, p, b), AdamWConfig())
    ax = gnn_axes(mesh)
    fields = {k: v for k, v in graph._asdict().items()
              if k not in ("rowptr", "transposed")}
    gshard = type(graph)(**{**{k: None for k in graph._fields},
                            **gnn_graph_shardings(mesh, fields)})
    bshard = dict(graph=gshard,
                  labels=(ax, None) if regression else (ax,),
                  mask=(ax,))
    pshard = gnn_param_shardings(mesh, params_shape)
    batch = dict(graph=graph, labels=labels, mask=mask)
    return StepPlan(step, (params_shape, opt_shape, batch),
                    (pshard, _opt_shardings(pshard), bshard), donate=(0, 1),
                    static_desc=f"{cfg.name} {spec.name} N{n}")


# -------------------------------------------------------------- RecSys ---

def _dlrm_plan(bundle, spec, mesh) -> StepPlan:
    from repro_torch.models.dlrm import (dlrm_forward, dlrm_loss,
                                         init_dlrm_params, retrieval_score)
    cfg = bundle.config
    B = spec.dim("batch")
    L = cfg.lookups_per_field
    params_shape = init_dlrm_params(cfg, MetaGenerator())
    batch = dict(dense=_sds((B, cfg.n_dense), torch.float32),
                 sparse=_sds((B, cfg.n_sparse, L), torch.int32),
                 labels=_sds((B,), torch.int32))
    pshard = dlrm_param_shardings(mesh, params_shape)

    if spec.kind == "recsys_train":
        opt_shape = init_adamw(params_shape)
        step = train_step(lambda p, b: dlrm_loss(cfg, p, b), AdamWConfig())
        return StepPlan(step, (params_shape, opt_shape, batch),
                        (pshard, _opt_shardings(pshard),
                         dlrm_batch_shardings(mesh)),
                        donate=(0, 1), static_desc=f"dlrm train B{B}")

    if spec.kind == "recsys_serve":
        @torch.no_grad()
        def step(params, batch):
            return dlrm_forward(cfg, params, batch)
        return StepPlan(step, (params_shape, batch),
                        (pshard, dlrm_batch_shardings(mesh)),
                        static_desc=f"dlrm serve B{B}")

    # retrieval: 1 query vs n_candidates
    C = pad_to(spec.dim("n_candidates"), 2048)
    batch = dict(batch, candidates=_sds((C, cfg.bot_mlp[-1]),
                                        torch.float32))

    @torch.no_grad()
    def step(params, batch):
        return retrieval_score(cfg, params, batch)

    bshard = dlrm_batch_shardings(mesh, with_candidates=True)
    if B == 1:  # can't shard batch 1
        for k in ("dense", "sparse", "labels"):
            bshard[k] = _rep(batch[k])
    return StepPlan(step, (params_shape, batch), (pshard, bshard),
                    static_desc=f"dlrm retrieval C{C}")


# ----------------------------------------------------------------- CCA ---

def _cca_plan(bundle, spec, mesh) -> StepPlan:
    from repro_torch.configs.cca_paper import engine_config_for
    from repro_torch.core.apps import BFS
    from repro_torch.core.engine import run_chunk_body
    from repro_torch.core.state import init_state
    ecfg = dataclasses.replace(engine_config_for(spec), chunk=8)
    state_shape = init_state(ecfg, device=META)

    def step(state):
        return run_chunk_body(ecfg, BFS, state)

    sshard = cca_state_shardings(mesh, state_shape)
    return StepPlan(step, (state_shape,), (sshard,), donate=(0,),
                    static_desc=f"cca {ecfg.height}x{ecfg.width} "
                                f"x{ecfg.chunk}cyc")


# ------------------------------------------------------------- dispatch --

def build_plan(bundle: ArchBundle, spec: ShapeSpec, mesh,
               lm_overrides=None) -> StepPlan:
    dist_ctx.set_dist_mesh(mesh)
    kind = spec.kind
    if kind == "lm_train":
        return _lm_train_plan(bundle, spec, mesh, lm_overrides)
    if kind == "lm_prefill":
        return _lm_prefill_plan(bundle, spec, mesh, lm_overrides)
    if kind == "lm_decode":
        return _lm_decode_plan(bundle, spec, mesh, lm_overrides)
    if kind.startswith("gnn"):
        return _gnn_train_plan(bundle, spec, mesh)
    if kind.startswith("recsys"):
        return _dlrm_plan(bundle, spec, mesh)
    if kind == "cca_stream":
        return _cca_plan(bundle, spec, mesh)
    raise ValueError(kind)
