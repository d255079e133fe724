"""Bulk message-passing primitives over edge lists (the port of
``repro.graph.segment_ops``).

Every edge carries a message to its destination, and the destination
sums them: the bulk-synchronous rendering of the paper's diffusion.
``scatter_sum`` and ``spmm(..., "sum")`` go through the scatter-SpMM
kernel (``kernels/spmm``) for CUDA tensors and through its plain version
for CPU tensors.  The kernel takes edges sorted by destination, so these
two (and ``scatter_mean``, which sums through ``scatter_sum``) need
``edge_index[1]`` sorted ascending and int32, and take the kernel's row
pointers as ``rowptr=`` (built and checked per call when not given);
``models.gnn.sort_edges`` prepares a graph and its row pointers once.
``degrees``, the counts of ``scatter_mean``, ``scatter_max`` and
``segment_softmax`` are plain PyTorch, as the JAX package computes them
outside any Pallas kernel, and take edges in any order.

Gradients pass through the kernel's sums (``kernels/spmm``'s autograd
Functions).  On the card, ``spmm``'s backward is the kernel over the
transposed edges, which it takes as ``transposed=``
(``spmm_ops.transpose_edges``; ``models.gnn.add_transposed`` builds them
once a graph, beside its row pointers).

Semantics are ``jax.ops.segment_*``: a destination outside ``[0, n)`` is
dropped, an empty segment sums to 0 and has the maximum ``-inf``.  A
gather (``x[src]``) reads indices as JAX does: negative from the end,
then clamped into range.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.spmm import ops as spmm_ops
from repro_torch.kernels.spmm.ref import take_rows


def gather_src(x, edge_index):
    """x: [N, D]; edge_index: [2, E] (src, dst) -> messages [E, D]."""
    return take_rows(x, edge_index[0])


def scatter_sum(msgs, edge_index, n_nodes, rowptr=None):
    """Segment sum of ``msgs`` [E, ...] by ``edge_index[1]`` (sorted) in
    f32 through the kernel, returned in ``msgs``' dtype."""
    flat = msgs.reshape(msgs.shape[0], math.prod(msgs.shape[1:]))
    out = spmm_ops.scatter_spmm(flat.float().contiguous(),
                                edge_index[1], n_nodes, rowptr)
    return out.reshape(n_nodes, *msgs.shape[1:]).to(msgs.dtype)


def _in_range(idx, n):
    keep = (idx >= 0) & (idx < n)
    return keep, idx[keep].long()


def _segment_sum_plain(data, seg, n):
    keep, idx = _in_range(seg, n)
    out = torch.zeros((n, *data.shape[1:]), dtype=data.dtype,
                      device=data.device)
    return out.index_add_(0, idx, data[keep])


def _segment_max(data, seg, n):
    keep, idx = _in_range(seg, n)
    low = (-torch.inf if data.dtype.is_floating_point
           else torch.iinfo(data.dtype).min)
    out = torch.full((n, *data.shape[1:]), low, dtype=data.dtype,
                     device=data.device)
    vals = data[keep]
    idx = idx.view(-1, *[1] * (data.dim() - 1)).expand_as(vals)
    return out.scatter_reduce_(0, idx, vals, "amax", include_self=True)


def scatter_mean(msgs, edge_index, n_nodes, rowptr=None):
    s = scatter_sum(msgs, edge_index, n_nodes, rowptr)
    cnt = _segment_sum_plain(
        torch.ones(msgs.shape[0], dtype=msgs.dtype, device=msgs.device),
        edge_index[1], n_nodes)
    return s / cnt.clamp(min=1.0)[:, None]


def scatter_max(msgs, edge_index, n_nodes):
    return _segment_max(msgs, edge_index[1], n_nodes)


def degrees(edge_index, n_nodes, direction="in"):
    idx = edge_index[1] if direction == "in" else edge_index[0]
    return _segment_sum_plain(
        torch.ones(idx.shape, dtype=torch.float32, device=idx.device), idx,
        n_nodes)


def sym_norm_coeff(edge_index, n_nodes, eps=1e-9):
    """GCN symmetric normalization 1/sqrt(d_src * d_dst) per edge."""
    din = degrees(edge_index, n_nodes, "in") + 1.0   # +1: self loops
    dout = degrees(edge_index, n_nodes, "out") + 1.0
    return torch.rsqrt(take_rows(dout, edge_index[0])
                       * take_rows(din, edge_index[1]) + eps)


def spmm(x, edge_index, n_nodes, coeff=None, aggregator="sum", rowptr=None,
         transposed=None):
    """A @ X via gather-scatter.  coeff: optional per-edge scalar;
    transposed: the sum's transposed edges, for its backward on the card
    (``spmm_ops.spmm_sorted_coo``)."""
    if aggregator == "sum":
        dt = x.dtype if coeff is None else torch.promote_types(x.dtype,
                                                               coeff.dtype)
        xf = x.float().contiguous()
        cf = None if coeff is None else coeff.float().contiguous()
        out = spmm_ops.spmm_sorted_coo(xf, edge_index[0], edge_index[1],
                                       n_nodes, cf, rowptr, transposed)
        return out.to(dt)
    msgs = gather_src(x, edge_index)
    if coeff is not None:
        msgs = msgs * coeff[:, None]
    if aggregator == "mean":
        return scatter_mean(msgs, edge_index, n_nodes, rowptr)
    if aggregator == "max":
        return scatter_max(msgs, edge_index, n_nodes)
    raise ValueError(aggregator)


def segment_softmax(scores, seg_ids, n_segments):
    """Numerically stable softmax over variable-size segments (edge->dst)."""
    smax = _segment_max(scores, seg_ids, n_segments)
    ex = torch.exp(scores - take_rows(smax, seg_ids))
    ssum = _segment_sum_plain(ex, seg_ids, n_segments)
    return ex / take_rows(ssum, seg_ids).clamp(min=1e-16)
