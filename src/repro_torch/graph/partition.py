"""Owner-partitioned COO edges: the GNN's one-collective message passing
(the port of ``repro.graph.partition``).

Edges are bucketed by the rank that OWNS their destination node (node
blocks are contiguous ranges), each bucket padded to the common maximum
so the flat edge array splits evenly.  Message passing then needs one
collective a layer, the bf16 all-gather of the node features, and the
scatter-add is local: the paper's "work to data" applied to bulk message
passing.
"""
from __future__ import annotations

import numpy as np
import torch

PAD_DST = np.int32(2 ** 30)


def partition_edges(edge_index: np.ndarray, n_nodes: int,
                    n_shards: int) -> np.ndarray:
    """``[2, E]`` COO -> ``[2, E_pad]`` bucketed by destination owner,
    equal buckets, padded with ``PAD_DST``."""
    src, dst = np.asarray(edge_index)
    n_loc = -(-n_nodes // n_shards)
    owner = dst // n_loc
    order = np.argsort(owner, kind="stable")
    src, dst, owner = src[order], dst[order], owner[order]
    counts = np.bincount(owner, minlength=n_shards)
    emax = int(counts.max())
    out = np.full((2, n_shards * emax), PAD_DST, np.int32)
    pos = 0
    for s in range(n_shards):
        c = counts[s]
        out[0, s * emax:s * emax + c] = src[pos:pos + c]
        out[1, s * emax:s * emax + c] = dst[pos:pos + c]
        pos += c
    return out


def partitioned_coeff(edge_index: torch.Tensor, n_nodes: int,
                      eps: float = 1e-9) -> torch.Tensor:
    """GCN's symmetric normalisation ``1 / sqrt(d_src * d_dst)`` a
    partitioned edge (``segment_ops.sym_norm_coeff``'s values on the real
    edges; 0 on the padding, which the scatter drops)."""
    src, dst = edge_index[0].long(), edge_index[1].long()
    real = dst < n_nodes
    ones = torch.ones(int(real.sum()), dtype=torch.float32,
                      device=edge_index.device)
    din = torch.ones(n_nodes, device=edge_index.device).index_add(
        0, dst[real], ones)
    dout = torch.ones(n_nodes, device=edge_index.device).index_add(
        0, src[real], ones)
    c = torch.rsqrt(dout[src.clamp(max=n_nodes - 1)]
                    * din[dst.clamp(max=n_nodes - 1)] + eps)
    return torch.where(real, c, torch.zeros_like(c))


def spmm_partitioned(x, edge_index, n_nodes: int, coeff=None, mesh=None):
    """``A @ X`` over owner-partitioned edges on ``mesh``'s ranks.

    ``x``: this process's node blocks (``LocalTiles``: all of them, the
    whole ``[N, D]``; a process group: its own ``[N / ranks, D]``), in
    rank order; ``edge_index``: the whole ``[2, E_pad]`` of
    :func:`partition_edges` over ``mesh.size`` shards (``coeff`` its
    ``[E_pad]`` edge weights, or ``None``).  Each rank takes one bf16
    all-gather of x and scatter-adds its own bucket into its own block
    (``index_add_``; the padding is dropped).  Returns the f32 blocks in
    ``x``'s layout."""
    tr = mesh.transport
    nsh = mesh.size
    n_loc = n_nodes // nsh
    if n_loc * nsh != n_nodes:
        raise ValueError(f"{n_nodes} nodes do not split over {nsh} ranks")
    local = tr.local_ranks
    if x.shape[0] != n_loc * len(local):
        raise ValueError(f"x has {x.shape[0]} rows, this process's "
                         f"{len(local)} blocks {n_loc * len(local)}")
    D = x.shape[1]
    blocks = [b.to(torch.bfloat16).contiguous()
              for b in x.split(n_loc, dim=0)]
    xf = torch.cat(tr.all_gather(blocks), dim=0)           # [N, D] bf16
    e_loc = edge_index.shape[1] // nsh
    outs = []
    for r in local:
        src = edge_index[0, r * e_loc:(r + 1) * e_loc].long()
        dst = edge_index[1, r * e_loc:(r + 1) * e_loc].long()
        keep = dst < n_nodes
        src, dst = src[keep], dst[keep] - r * n_loc
        m = xf[src].float()
        if coeff is not None:
            m = m * coeff[r * e_loc:(r + 1) * e_loc][keep][:, None]
        out = torch.zeros((n_loc, D), dtype=torch.float32, device=x.device)
        outs.append(out.index_add_(0, dst, m))
    return torch.cat(outs, dim=0)
