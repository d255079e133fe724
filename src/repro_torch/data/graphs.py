"""Graph batch builders: synthetic graphs per shape spec and the GraphCast
multimesh (the port's copy of ``repro.data.graphs``).

The arrays are drawn in numpy with the JAX package's random calls in the
same order, so a spec and a seed give the same graph in both packages;
the tensors are then put on ``device`` (default ``cuda``), and the graph
is prepared for the scatter-SpMM kernel (``models.gnn.sort_edges``: its
edge sets are already sorted, so only their row pointers are added).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.state import resolve_device
from repro_torch.models.gnn import Graph, GNNConfig, icosphere_sizes, \
    sort_edges


def graphcast_sizes(cfg: GNNConfig, n_grid: int) -> dict:
    n_mesh, e_mesh = icosphere_sizes(cfg.mesh_refinement)
    return dict(n_mesh=n_mesh, e_mesh=e_mesh,
                e_g2m=3 * n_grid, e_m2g=3 * n_grid)


def _rand_edges(rng, n, e, sorted_dst=True):
    src = rng.integers(0, n, e, dtype=np.int64)
    dst = rng.integers(0, n, e, dtype=np.int64)
    if sorted_dst:
        o = np.argsort(dst, kind="stable")
        src, dst = src[o], dst[o]
    return np.stack([src, dst]).astype(np.int32)


def build_graph(cfg: GNNConfig, spec, rng=None, device=None) -> Graph:
    """Materialize a concrete random graph batch for a shape spec."""
    dev = resolve_device(device)
    rng = rng or np.random.default_rng(0)
    d = dict(spec.dims)
    kind = spec.kind
    if kind == "gnn_batched":
        b, n1, e1 = d["batch"], d["n_nodes"], d["n_edges"]
        n = b * n1
        # disjoint union: edges stay within each small graph
        edge_index = np.concatenate(
            [_rand_edges(rng, n1, e1, sorted_dst=False) + g * n1
             for g in range(b)], axis=1)
        o = np.argsort(edge_index[1], kind="stable")
        edge_index = edge_index[:, o]
    else:
        n, e = d["n_nodes"], d["n_edges"]
        if kind == "gnn_minibatch":
            n, e = sampled_subgraph_sizes(d)
        edge_index = _rand_edges(rng, n, e)
    x = rng.standard_normal((n, d["d_feat"]), dtype=np.float32)

    def put(a):
        return torch.from_numpy(a).to(dev)

    g = Graph(x=put(x), edge_index=put(edge_index))
    if cfg.kind == "graphcast":
        gs = graphcast_sizes(cfg, n)
        g = g._replace(
            mesh_edge_index=put(_rand_edges(rng, gs["n_mesh"], gs["e_mesh"])),
            g2m_edge_index=put(np.stack([
                rng.integers(0, n, gs["e_g2m"]),
                np.sort(rng.integers(0, gs["n_mesh"], gs["e_g2m"]))
            ]).astype(np.int32)),
            m2g_edge_index=put(np.stack([
                rng.integers(0, gs["n_mesh"], gs["e_m2g"]),
                np.sort(rng.integers(0, n, gs["e_m2g"]))
            ]).astype(np.int32)))
    return sort_edges(cfg, g)


def sampled_subgraph_sizes(dims: dict) -> tuple[int, int]:
    """Padded (nodes, edges) of a fanout-sampled block set."""
    b = dims["batch_nodes"]
    nodes, edges, frontier = b, 0, b
    for f in dims["fanout"]:
        edges += frontier * f
        frontier = frontier * f
        nodes += frontier
    return nodes, edges


# ---------------- neighbor sampler (GraphSAGE-style fanout) ----------------

class NeighborSampler:
    """Uniform fanout sampler over a CSR adjacency (host-side, numpy; the
    JAX package's, line for line, so the same seed draws the same
    subgraphs).

    Produces fixed-shape (padded) subgraph batches: seeds first, then each
    hop's sampled neighbors; edges point child -> parent (message flows
    toward the seeds, matching aggregation direction).
    """

    def __init__(self, n_nodes: int, edge_index: np.ndarray, seed: int = 0):
        src, dst = edge_index
        order = np.argsort(dst, kind="stable")
        self.nbr = src[order].astype(np.int64)
        counts = np.bincount(dst, minlength=n_nodes)
        self.ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        self.n = n_nodes
        self.rng = np.random.default_rng(seed)

    def sample(self, seeds: np.ndarray, fanout) -> dict:
        nodes = [seeds.astype(np.int64)]
        edges_src, edges_dst = [], []
        frontier = seeds.astype(np.int64)
        base = 0
        for f in fanout:
            deg = self.ptr[frontier + 1] - self.ptr[frontier]
            # sample f neighbors (with replacement; isolated -> self)
            r = self.rng.integers(0, 1 << 62, size=(len(frontier), f))
            idx = self.ptr[frontier][:, None] + r % np.maximum(deg, 1)[:, None]
            nb = np.where(deg[:, None] > 0, self.nbr[idx],
                          frontier[:, None])
            child_base = sum(len(x) for x in nodes)
            parents_local = np.arange(base, base + len(frontier))
            edges_src.append((child_base
                              + np.arange(nb.size)).astype(np.int64))
            edges_dst.append(np.repeat(parents_local, f))
            nodes.append(nb.reshape(-1))
            base += len(frontier)
            frontier = nb.reshape(-1)
        local_nodes = np.concatenate(nodes)
        ei = np.stack([np.concatenate(edges_src),
                       np.concatenate(edges_dst)]).astype(np.int32)
        return dict(node_ids=local_nodes, edge_index=ei,
                    n_seeds=len(seeds))
