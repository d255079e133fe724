"""Pipeline parallelism: a GPipe microbatch schedule over a mesh axis (the
port of ``repro.dist.pipeline``).

``split_stages`` carves a layer-stacked parameter tree into S contiguous
stages; ``pipelined_apply`` runs the tick schedule: every tick each stage
applies itself to the activation it holds, then the activations move one
stage forward while stage 0 takes the next microbatch.  With M
microbatches and S stages the schedule drains in ``M + S - 1`` ticks (the
pipeline bubble).  Over a ``ProcessGroupTiles`` mesh each process is one
stage and an activation moves with one send and one receive a tick; over
``LocalTiles`` the stages take turns in one process.  The last stage's
outputs are broadcast to every rank.  Without a ``pipe`` axis it runs the
sequential loop, microbatch by microbatch.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.dist.sharding import tree_leaves, tree_map


def split_stages(params, n_stages: int):
    """Split a layer-stacked tree (leaves ``[L, ...]``) into ``n_stages``
    equal contiguous stages (leaves ``[S, L/S, ...]``)."""
    def split(l):
        L = l.shape[0]
        if L % n_stages:
            raise ValueError(
                f"cannot split {L} stacked layers into {n_stages} stages")
        return l.reshape(n_stages, L // n_stages, *l.shape[1:])
    return tree_map(split, params)


def _stage(stages, s):
    return tree_map(lambda l: l[s], stages)


def pipelined_apply(stage_fn, stages, xs, mesh, axis: str = "pipe"):
    """Run ``xs`` (``[n_micro, ...microbatch]``) through the staged
    network.  ``stage_fn(stage_params, x)`` applies ONE stage (leaves the
    ``[L/S, ...]`` slice of the stack) to one microbatch.  Returns
    ``[n_micro, ...]`` outputs on every rank.  Runs the sequential loop
    when ``mesh`` is None or its ``axis`` is absent or of size 1."""
    n_stages = int(tree_leaves(stages)[0].shape[0])
    if mesh is None or axis not in mesh.axis_names \
            or int(mesh.shape[axis]) == 1:
        outs = []
        for x in xs:
            for s in range(n_stages):
                x = stage_fn(_stage(stages, s), x)
            outs.append(x)
        return torch.stack(outs)
    if int(mesh.shape[axis]) != n_stages:
        raise ValueError(
            f"{n_stages} stages need mesh axis '{axis}' of that size, "
            f"got {int(mesh.shape[axis])}")
    if mesh.size != n_stages:
        raise ValueError(f"the pipeline runs on a mesh of its '{axis}' "
                         f"axis alone, not {mesh.shape}")
    tr = mesh.transport
    n_micro = xs.shape[0]
    n_ticks = n_micro + n_stages - 1          # the pipeline bubble
    local = tr.local_ranks
    sid = {r: mesh.coords(r)[axis] for r in local}
    buf = {r: torch.zeros_like(xs[0]) for r in local}
    outs = torch.zeros_like(xs)
    for t in range(n_ticks):
        done = t - (n_stages - 1)             # microbatch finishing now
        out = {}
        for r in local:
            s = sid[r]
            inp = xs[min(t, n_micro - 1)] if s == 0 else buf[r]
            out[r] = stage_fn(_stage(stages, s), inp)
            if s == n_stages - 1 and done >= 0:
                outs[done] = out[r]
        if len(local) == n_stages:
            # stages of one process: shift the activations in place
            for r in local:
                if sid[r] > 0:
                    prev = next(q for q in local if sid[q] == sid[r] - 1)
                    buf[r] = out[prev]
        else:
            (r,) = local
            buf[r] = _shift(out[r], sid[r], n_stages, mesh, axis)
    last = next(r for r in range(mesh.size)
                if mesh.coords(r)[axis] == n_stages - 1)
    return tr.broadcast(outs, last)


def _shift(x, s, n_stages, mesh, axis):
    """Send this stage's activation to stage ``s + 1`` and receive stage
    ``s - 1``'s, in one ``batch_isend_irecv`` (stage 0 receives
    nothing and keeps zeros, which it never reads)."""
    rank_of = {mesh.coords(r)[axis]: r for r in range(mesh.size)}
    recv = torch.zeros_like(x)
    ops = []
    if s + 1 < n_stages:
        ops.append(dist.P2POp(dist.isend, x.contiguous(), rank_of[s + 1]))
    if s > 0:
        ops.append(dist.P2POp(dist.irecv, recv, rank_of[s - 1]))
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    return recv
