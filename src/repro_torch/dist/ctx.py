"""Process-global distribution context: the mesh registry and the spec
helpers (the port of ``repro.dist.ctx``).

The paper's vertex object is "parallelized across many scratchpad
memory-coupled cores and yet provides a single programming abstraction to
the data object".  In the JAX package GSPMD distributes whole arrays over
a device mesh; in the port a :class:`Mesh` names the same axes and sizes
and carries a transport (``repro_torch.dist.transport``) that moves the
bytes: tiles on one device (``LocalTiles``) or one tile a process over
``torch.distributed`` (``ProcessGroupTiles``).

Logical axis vocabulary (DESIGN §5), as in the JAX package:

* ``"model"``            -- tensor-parallel axis,
* ``"data"`` / ``"pod"`` -- data-parallel axes (``"pod"`` only on
  multi-pod meshes),
* ``"dp"``               -- alias for the active data-parallel group
  (``("pod", "data")`` or ``("data",)``),
* ``None``               -- replicated dimension,
* a tuple of names       -- dimension sharded over several mesh axes.

A spec is a plain tuple of those entries, one a dimension: what
``jax.sharding.PartitionSpec`` holds.
"""
from __future__ import annotations

import math

_DIST_MESH = None


class Mesh:
    """Named mesh axes and their sizes (``shape[name]``, as a JAX mesh's
    ``shape``), ranks laid out row-major over ``axis_names``, and the
    ``transport`` that connects them (``None``: a mesh for the sharding
    rules only)."""

    def __init__(self, shape, axis_names, transport=None):
        shape = tuple(int(s) for s in shape)
        if len(shape) != len(axis_names) or min(shape, default=1) < 1:
            raise ValueError(f"mesh shape {shape} does not fit the axes "
                             f"{tuple(axis_names)}")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, shape))
        self.transport = transport
        if transport is not None and transport.world != self.size:
            raise ValueError(f"a {self.size}-rank mesh on a transport of "
                             f"{transport.world} ranks")

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def coords(self, rank: int) -> dict:
        """``{axis: index}`` of ``rank`` (row-major over the axes)."""
        out = {}
        for name in reversed(self.axis_names):
            rank, out[name] = divmod(rank, self.shape[name])
        return {n: out[n] for n in self.axis_names}

    def axis_index(self, rank: int, axes) -> int:
        """``rank``'s coordinate on ``axes``: on one axis its index there,
        on several the row-major index over them (the shard a dimension
        split over those axes gives ``rank``, as in JAX)."""
        c, idx = self.coords(rank), 0
        for a in axes:
            idx = idx * self.shape[a] + c[a]
        return idx

    def axis_groups(self, axes) -> list:
        """The ranks that differ only on ``axes``, a tuple a group: groups
        in rank order, each in the order of ``axis_index`` over ``axes``
        (which, for axes in mesh order, is rank order too)."""
        axes = tuple(axes)
        groups = {}
        for r in range(self.size):
            c = self.coords(r)
            key = tuple(c[a] for a in self.axis_names if a not in axes)
            groups.setdefault(key, []).append((self.axis_index(r, axes), r))
        return sorted(tuple(r for _, r in sorted(g))
                      for g in groups.values())

    @property
    def local_ranks(self) -> tuple:
        """The ranks this process holds: every rank without a transport."""
        if self.transport is None:
            return tuple(range(self.size))
        return self.transport.local_ranks

    def __repr__(self):
        return (f"Mesh({self.shape}, transport="
                f"{type(self.transport).__name__})")


def set_dist_mesh(mesh):
    """Register the process mesh the model code reads (None to clear)."""
    global _DIST_MESH
    _DIST_MESH = mesh
    return mesh


def get_dist_mesh():
    return _DIST_MESH


def model_size(mesh=None) -> int:
    """Size of the tensor-parallel ('model') axis; 1 when unmeshed."""
    mesh = mesh if mesh is not None else _DIST_MESH
    if mesh is None or "model" not in mesh.axis_names:
        return 1
    return int(mesh.shape["model"])


def dp_axes_active(mesh=None) -> tuple:
    """The data-parallel axis group present on the mesh: ``("pod",
    "data")`` on multi-pod meshes, ``("data",)`` otherwise, and
    ``("data",)`` when no mesh is registered."""
    mesh = mesh if mesh is not None else _DIST_MESH
    if mesh is None:
        return ("data",)
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names) \
        or ("data",)


def _resolve_entry(mesh, entry) -> tuple:
    """One spec entry -> the tuple of valid mesh axis names (or ())."""
    if entry is None:
        return ()
    if isinstance(entry, str):
        names = dp_axes_active(mesh) if entry == "dp" else (entry,)
    else:
        names = []
        for e in entry:
            names.extend(dp_axes_active(mesh) if e == "dp" else (e,))
        names = tuple(names)
    return tuple(n for n in names if n in mesh.axis_names)


def resolve_spec(mesh, shape, axes) -> tuple:
    """Logical axes -> a spec valid for ``shape`` on ``mesh``: an entry a
    dimension, ``None`` (replicated) where the named axes are absent from
    the mesh or their combined size does not divide the dimension, the
    axis name where one axis remains, else the tuple of names."""
    spec = []
    for dim, entry in zip(shape, axes):
        names = _resolve_entry(mesh, entry)
        size = math.prod(mesh.shape[n] for n in names) if names else 1
        if not names or size <= 1 or dim % size != 0:
            spec.append(None)
        elif len(names) == 1:
            spec.append(names[0])
        else:
            spec.append(tuple(names))
    return tuple(spec)


def constrain(x, *axes):
    """``x`` unchanged.  JAX's ``constrain`` pins an array's sharding for
    GSPMD inside a traced program; eager PyTorch has no such constraint,
    and the port's layouts are explicit: it lays tensors out per rank
    itself (``dist.sharding.lay_out``, ``repro_torch.dist.cca``,
    ``graph.partition``) and its forward over a mesh computes on each
    rank's blocks, gathering and summing where GSPMD would
    (``models.transformer``'s forward on a ``Placed`` tree).  Checks the
    axis count, as JAX's does."""
    if _DIST_MESH is not None and len(axes) != x.dim():
        raise ValueError(
            f"constrain: got {len(axes)} axes for rank-{x.dim()} array")
    return x
