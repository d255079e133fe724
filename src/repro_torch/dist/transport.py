"""The port's transport: what moves bytes between the ranks of a mesh.

In the JAX package GSPMD lowers the hop stage's masked rolls to
collective-permutes and the quiescence sums to all-reduces.  The port has
no compiler to do that; a transport does it by hand, behind one
interface, in two implementations (neither falls back to the other):

* :class:`LocalTiles` -- every rank a tile in this process, on one
  device.  A halo exchange is one gather and one scatter over the tiles'
  packed boundary words; a reduction is a reduction over the local axis.
* :class:`ProcessGroupTiles` -- one rank a process over
  ``torch.distributed`` (gloo on the CPU, NCCL on cards).  A halo
  exchange packs the words each peer needs with one gather, sends and
  receives them with ``batch_isend_irecv``, and scatters what arrived;
  reductions are ``all_reduce`` on device tensors.

Besides the whole-world reductions, both reduce and gather over the ranks
of chosen mesh axes (``axis_sum``, ``axis_gather``: JAX's ``psum`` and
tiled ``all_gather`` over named axes in ``shard_map``), on blocks given
one a local rank: ``LocalTiles`` over the groups of
``Mesh.axis_groups``, ``ProcessGroupTiles`` over a subgroup a group (the
world where one group is all of it).

The exchange itself (``dist.cca.HaloPlan``) is the same code on both:
pack with one gather, ``move``, unpack with one scatter.  ``LocalTiles``
lays its packed words out so that they are already where they go, and
its ``move`` is the identity.
"""
from __future__ import annotations

import datetime

import torch
import torch.distributed as dist

from repro_torch.core.state import resolve_device


class LocalTiles:
    """``world`` ranks, all in this process, on ``device`` (``None``: the
    card)."""

    def __init__(self, world: int, device=None):
        if world < 1:
            raise ValueError(f"world must be >= 1, got {world}")
        self.world = int(world)
        self.device = resolve_device(device)
        self.local_ranks = tuple(range(self.world))

    name = "local"

    def move(self, packed: torch.Tensor, plan) -> torch.Tensor:
        """The halo words each rank receives, laid out as ``plan`` unpacks
        them: for tiles of one process, the packed words themselves."""
        return packed

    def all_min(self, x: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
        """``out`` = the minimum over ranks of ``x`` (``[local ranks]``)."""
        return torch.amin(x, dim=0, out=out)

    def all_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over ranks of ``x`` (``[local ranks, ...]``)."""
        return x.sum(dim=0)

    def all_max(self, x: torch.Tensor) -> torch.Tensor:
        return x.amax(dim=0)

    def all_gather(self, blocks: list) -> list:
        """Every rank's block, in rank order (``blocks``: this process's,
        in the order of ``local_ranks``)."""
        return list(blocks)

    def broadcast(self, x: torch.Tensor, src: int) -> torch.Tensor:
        return x

    def axis_sum(self, mesh, axes, blocks: list) -> list:
        """For each rank, the sum of ``blocks`` (one a rank, in rank
        order) over the ranks that differ from it only on ``axes``."""
        out = [None] * len(blocks)
        for group in mesh.axis_groups(axes):
            total = torch.stack([blocks[r] for r in group]).sum(dim=0)
            for r in group:
                out[r] = total
        return out

    def axis_gather(self, mesh, axes, blocks: list, dim: int) -> list:
        """For each rank, the blocks of its group on ``axes``
        concatenated along ``dim`` in the group's order."""
        out = [None] * len(blocks)
        for group in mesh.axis_groups(axes):
            whole = torch.cat([blocks[r] for r in group], dim=dim)
            for r in group:
                out[r] = whole
        return out

    def barrier(self) -> None:
        pass


class ProcessGroupTiles:
    """One rank a process of the default ``torch.distributed`` group,
    which must be initialised (:meth:`connect` does it); tensors on
    ``device`` (``None``: ``cuda:<local rank>`` for NCCL, the CPU for
    gloo)."""

    name = "process_group"

    def __init__(self, device=None):
        if not dist.is_available() or not dist.is_initialized():
            raise RuntimeError("ProcessGroupTiles needs an initialised "
                               "torch.distributed process group "
                               "(ProcessGroupTiles.connect)")
        self.world = dist.get_world_size()
        self.rank = dist.get_rank()
        self.local_ranks = (self.rank,)
        self.backend = dist.get_backend()
        if device is None:
            device = (f"cuda:{torch.cuda.current_device()}"
                      if self.backend == "nccl" else "cpu")
        self.device = torch.device(device)
        self._groups = {}

    @classmethod
    def connect(cls, init_method: str, rank: int, world: int,
                backend: str | None = None, timeout_s: float = 120.0,
                device=None) -> "ProcessGroupTiles":
        """Join the process group at ``init_method`` (``tcp://host:port``
        or ``file://path``) as ``rank`` of ``world``; ``backend`` ``None``
        means NCCL where there is a card, else gloo.  Raises where the
        group cannot form within ``timeout_s``."""
        if backend is None:
            backend = "nccl" if torch.cuda.is_available() else "gloo"
        if backend == "nccl":
            if not torch.cuda.is_available():
                raise RuntimeError("the NCCL backend needs a card")
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            backend, init_method=init_method, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
        return cls(device=device)

    @staticmethod
    def close() -> None:
        if dist.is_initialized():
            dist.destroy_process_group()

    def move(self, packed: torch.Tensor, plan) -> torch.Tensor:
        """Send each peer its slice of ``packed`` and receive each peer's
        words into the layout ``plan`` unpacks, in one
        ``batch_isend_irecv``."""
        recv = torch.empty(plan.n_recv, dtype=packed.dtype,
                           device=packed.device)
        ops = []
        for peer, (s0, s1), (r0, r1) in plan.peers:
            ops.append(dist.P2POp(dist.isend, packed[s0:s1], peer))
            ops.append(dist.P2POp(dist.irecv, recv[r0:r1], peer))
        if ops:
            for w in dist.batch_isend_irecv(ops):
                w.wait()
        return recv

    def all_min(self, x: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
        out.copy_(x.reshape(out.shape))
        dist.all_reduce(out, op=dist.ReduceOp.MIN)
        return out

    def all_sum(self, x: torch.Tensor) -> torch.Tensor:
        y = x.sum(dim=0)
        dist.all_reduce(y, op=dist.ReduceOp.SUM)
        return y

    def all_max(self, x: torch.Tensor) -> torch.Tensor:
        y = x.amax(dim=0)
        dist.all_reduce(y, op=dist.ReduceOp.MAX)
        return y

    def all_gather(self, blocks: list) -> list:
        (b,) = blocks
        out = [torch.empty_like(b) for _ in range(self.world)]
        dist.all_gather(out, b.contiguous())
        return out

    def broadcast(self, x: torch.Tensor, src: int) -> torch.Tensor:
        x = x.contiguous()
        dist.broadcast(x, src)
        return x

    def _axis_group(self, mesh, axes):
        """(size of this rank's group on ``axes``, its process group:
        ``None`` for the world).  Every process makes every subgroup, in
        the same order, the first time a mesh and axes are asked for."""
        key = (tuple(mesh.shape.items()), tuple(axes))
        if key not in self._groups:
            groups = mesh.axis_groups(axes)
            size, pg = len(groups[0]), None
            if 1 < size < self.world:
                made = [dist.new_group(list(g)) for g in groups]
                pg = next(p for g, p in zip(groups, made) if self.rank in g)
            self._groups[key] = (size, pg)
        return self._groups[key]

    def axis_sum(self, mesh, axes, blocks: list) -> list:
        """This rank's block summed over its group on ``axes``."""
        (b,) = blocks
        y = b.clone(memory_format=torch.contiguous_format)
        size, pg = self._axis_group(mesh, axes)
        if size > 1:
            dist.all_reduce(y, op=dist.ReduceOp.SUM, group=pg)
        return [y]

    def axis_gather(self, mesh, axes, blocks: list, dim: int) -> list:
        """The blocks of this rank's group on ``axes``, concatenated
        along ``dim`` in rank order."""
        (b,) = blocks
        size, pg = self._axis_group(mesh, axes)
        if size == 1:
            return [b]
        b = b.contiguous()
        parts = [torch.empty_like(b) for _ in range(size)]
        dist.all_gather(parts, b, group=pg)
        return [torch.cat(parts, dim=dim)]

    def barrier(self) -> None:
        dist.barrier()
