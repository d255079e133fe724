"""Sharding rules for every workload family (the port of
``repro.dist.sharding``), as per-leaf spec tuples.

Each rule returns the tree it was given with a spec in place of each leaf:
the entries JAX's ``NamedSharding.spec`` holds, leaf by leaf, for the same
shapes and mesh shape.  The headline map is :func:`cca_state_shardings`:
the engine's machine state laid over the ``(data, model)`` mesh by cell
ROWS over the data-parallel group and cell COLUMNS over ``model``, so
each rank owns a contiguous tile of compute cells
(``repro_torch.dist.cca`` lays the state out by this rule and says where
its ``[IO]`` leaves depart from it).  Per leaf:

* rank >= 2 with both leading dims divisible -> ``(dp, "model", ...)``,
* rank >= 1 with the leading dim divisible   -> ``(dp, ...)``,
* everything else                             -> replicated.

Every rule degrades per dimension to replicated where an axis is missing
from the mesh or does not divide (``ctx.resolve_spec``).
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.dist.ctx import dp_axes_active, model_size, resolve_spec


def pad_to(n: int, mult: int) -> int:
    """Round ``n`` up to a multiple of ``mult`` (mult <= 1 -> n)."""
    if mult <= 1:
        return int(n)
    return int(-(-int(n) // int(mult)) * int(mult))


def tree_map(fn, tree):
    """``fn`` on every leaf of nested dicts, lists, tuples and
    NamedTuples (anything with a ``shape`` is a leaf)."""
    if hasattr(tree, "shape"):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    raise TypeError(f"not a tree of arrays: {type(tree).__name__}")


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` (``tree_map``'s), in order."""
    out = []
    tree_map(out.append, tree)
    return out


def _dp_entry(mesh):
    """The data-parallel axis group as a spec entry."""
    dp = dp_axes_active(mesh)
    return dp[0] if len(dp) == 1 else tuple(dp)


def _dp_size(mesh) -> int:
    return math.prod(mesh.shape[a] for a in dp_axes_active(mesh)
                     if a in mesh.axis_names)


# ------------------------------------------------------------------ CCA ---

def cca_state_spec(mesh, shape) -> tuple:
    """The spec of one machine-state leaf of ``shape``."""
    dp_n, tp_n = _dp_size(mesh), model_size(mesh)
    spec = [None] * len(shape)
    if len(shape) >= 2 and shape[0] % dp_n == 0 and shape[1] % tp_n == 0:
        spec[0], spec[1] = "dp", "model"
    elif len(shape) >= 1 and shape[0] and shape[0] % dp_n == 0:
        spec[0] = "dp"
    return resolve_spec(mesh, shape, spec)


def cca_state_shardings(mesh, state_shape):
    """Per-leaf specs for the engine's ``MachineState`` (``state_shape``:
    a state, e.g. ``init_state(cfg, device="meta")``)."""
    return tree_map(lambda l: cca_state_spec(mesh, tuple(l.shape)),
                    state_shape)


# ------------------------------------------------------------------- LM ---

# Per-layer stacked weights: logical axes of the TRAILING dims (the
# leading L layer-stack dim is replicated).
_LM_LAYER_AXES = {
    "wq": ("dp", "model"), "wk": ("dp", "model"), "wv": ("dp", "model"),
    "wo": ("model", "dp"),
    "ffn_wi": ("dp", "model"), "ffn_wg": ("dp", "model"),
    "ffn_wo": ("model", "dp"),
    "moe_wi": ("model", "dp", None), "moe_wg": ("model", "dp", None),
    "moe_wo": ("model", None, "dp"),
    "router": ("dp", None),
}


def lm_layer_spec(mesh, name: str, shape) -> tuple:
    """The spec of one layer's slice (``shape`` without the ``L`` dim) of
    the stacked leaf ``name``."""
    return resolve_spec(mesh, shape,
                        _LM_LAYER_AXES.get(name, (None,) * len(shape)))


def lm_param_shardings(mesh, params_shape):
    """FSDP (d_model over dp) x TP (heads/ffn/experts over model)."""
    layers = {k: (None, *lm_layer_spec(mesh, k, tuple(v.shape)[1:]))
              for k, v in params_shape["layers"].items()}
    return dict(
        embed=resolve_spec(mesh, params_shape["embed"].shape,
                           ("model", None)),
        unembed=resolve_spec(mesh, params_shape["unembed"].shape,
                             ("dp", None)),
        final_norm=resolve_spec(mesh, params_shape["final_norm"].shape,
                                (None,)),
        layers=layers,
    )


def block_slices(mesh, shape, spec, rank: int) -> tuple:
    """The index (a slice a dimension) of the block ``rank`` holds of a
    leaf of ``shape`` laid out by ``spec``: a dimension split over axes
    is cut into equal blocks, ``rank``'s the one at its ``axis_index``
    over them (what ``shard_map`` hands that rank)."""
    out = []
    for dim, entry in zip(shape, spec):
        if entry is None:
            out.append(slice(None))
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        n = math.prod(mesh.shape[a] for a in axes)
        if dim % n:
            raise ValueError(f"a dimension of {dim} does not split over "
                             f"{axes} ({n} ranks)")
        i, size = mesh.axis_index(rank, axes), dim // n
        out.append(slice(i * size, (i + 1) * size))
    return tuple(out)


def shard_block(x, mesh, spec, rank: int):
    """The block of ``x`` that ``rank`` holds under ``spec`` (a view)."""
    return x[block_slices(mesh, tuple(x.shape), spec, rank)]


# ------------------------------------------------- laying a tree out ---

class Placed(NamedTuple):
    """A tree laid out over ``mesh`` for this process (the port of a tree
    of ``jax.Array``s placed by ``NamedSharding``s): ``blocks[k]`` is the
    tree of rank ``mesh.local_ranks[k]``'s blocks, each leaf the block its
    spec in ``specs`` (a tree of the same structure, every spec resolved
    against its leaf's shape) gives that rank.  On ``LocalTiles`` the
    process holds every rank's blocks, over a process group its own."""
    mesh: Any
    specs: Any
    blocks: list


def map_specs(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree and the tree of its specs (a leaf is
    anything with a ``shape``; its spec the tuple at the same place)."""
    if hasattr(tree, "shape"):
        return fn(tree, specs)
    if isinstance(tree, dict):
        return {k: map_specs(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_specs(fn, v, s) for v, s in zip(tree, specs)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_specs(fn, v, s) for v, s in zip(tree, specs))
    raise TypeError(f"not a tree of arrays: {type(tree).__name__}")


def _tensor(x, device) -> torch.Tensor:
    """A contiguous tensor of its own on ``device`` (never a view of the
    whole leaf it was cut from)."""
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)
    return x.to(device).clone(memory_format=torch.contiguous_format)


def lay_out(tree, mesh, specs) -> Placed:
    """``tree`` (whole leaves: tensors or numpy arrays) cut into the blocks
    of this process's ranks by ``specs`` (JAX's ``device_put`` under
    ``NamedSharding``s), each block a tensor of its own on the mesh's
    device.  Each spec is resolved against its leaf's shape first
    (``ctx.resolve_spec``): a dimension its axes do not divide stays
    replicated."""
    if mesh.transport is None:
        raise ValueError("lay_out needs a mesh with a transport "
                         "(LocalTiles or ProcessGroupTiles)")
    specs = map_specs(lambda x, s: resolve_spec(mesh, tuple(x.shape), s),
                      tree, specs)
    dev = mesh.transport.device
    return Placed(mesh, specs, [
        map_specs(lambda x, s: _tensor(shard_block(x, mesh, s, r), dev),
                  tree, specs) for r in mesh.local_ranks])


def whole_shape(mesh, block_shape, spec) -> tuple:
    """The shape of the leaf whose blocks by ``spec`` are ``block_shape``."""
    out = []
    for dim, entry in zip(block_shape, spec):
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        out.append(dim * math.prod(mesh.shape[a] for a in axes))
    return tuple(out)


def gather_placed(placed: Placed):
    """The whole tree on every process, from every rank's blocks (an
    ``all_gather`` of each leaf over a process group)."""
    mesh = placed.mesh
    leaves = [[] for _ in placed.blocks]
    for k, tree in enumerate(placed.blocks):
        map_specs(lambda x, s: leaves[k].append(x), tree, placed.specs)
    specs = []
    map_specs(lambda x, s: specs.append(s), placed.blocks[0], placed.specs)
    out = []
    for i, spec in enumerate(specs):
        blocks = mesh.transport.all_gather([lv[i] for lv in leaves])
        shape = whole_shape(mesh, tuple(blocks[0].shape), spec)
        whole = blocks[0].new_empty(shape)
        for r, b in enumerate(blocks):
            whole[block_slices(mesh, shape, spec, r)] = b
        out.append(whole)
    it = iter(out)
    return map_specs(lambda x, s: next(it), placed.blocks[0], placed.specs)


def lm_batch_shardings(mesh):
    spec = (_dp_entry(mesh), None)
    return dict(tokens=spec, targets=spec)


def lm_cache_shardings(mesh, cfg, batch: int):
    """KV cache (k, v) of ``[L, B, Tmax, K, dh]``: batch over dp; KV heads
    over model when they divide, else the time axis."""
    dp = _dp_entry(mesh)
    bspec = dp if batch > 1 and batch % _dp_size(mesh) == 0 else None
    if cfg.n_kv_heads % model_size(mesh) == 0:
        spec = (None, bspec, None, "model", None)
    else:
        spec = (None, bspec, "model", None, None)
    return (spec, spec)


# ------------------------------------------------------------------ GNN ---

def gnn_axes(mesh) -> tuple:
    """Axes the node/edge dimension shards over (graph models flatten the
    whole mesh into one 'graph' axis group)."""
    return tuple(a for a in ("data", "model") if a in mesh.axis_names)


def gnn_param_shardings(mesh, params_shape):
    """GNN weights are tiny beside the graph: replicated."""
    return tree_map(lambda l: (), params_shape)


def gnn_graph_shardings(mesh, fields: dict) -> dict:
    """Specs for the non-None Graph fields: node features row-sharded,
    every ``*edge_index`` along the edge axis (owner-partitioned buckets
    line up with the node blocks, ``graph/partition.py``)."""
    ax = gnn_axes(mesh)
    ax = ax[0] if len(ax) == 1 else ax
    out = {}
    for k, v in fields.items():
        if v is None:
            continue
        out[k] = (None, ax) if k.endswith("edge_index") else (ax, None)
    return out


# ----------------------------------------------------------------- DLRM ---

def dlrm_param_shardings(mesh, params_shape):
    """Embedding tables row-sharded over 'model' (lookups route to the
    owning shard); MLPs replicated."""
    tp = model_size(mesh)
    tables = [
        resolve_spec(mesh, t.shape, ("model", None)) if t.shape[0] % tp == 0
        else ()
        for t in params_shape["tables"]
    ]
    rep = tree_map(lambda l: (), dict(bot=params_shape["bot"],
                                      top=params_shape["top"]))
    return dict(tables=tables, bot=rep["bot"], top=rep["top"])


def dlrm_batch_shardings(mesh, with_candidates: bool = False):
    dp = _dp_entry(mesh)
    out = dict(dense=(dp, None), sparse=(dp, None, None), labels=(dp,))
    if with_candidates:
        out["candidates"] = ("model", None)
    return out
