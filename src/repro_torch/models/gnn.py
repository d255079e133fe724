"""GNN model zoo: GCN, GatedGCN, MeshGraphNet, GraphCast (the port of
``repro.models.gnn``; serving forwards).

All four share the bulk message-passing substrate (``graph/segment_ops``),
whose sums run on the scatter-SpMM kernel for CUDA tensors.  Each model is
an (init, forward) pair over a ``Graph``:

    Graph(x [N,Dx], edge_index [2,E], e [E,De] | None, ...)

``GNN`` wraps the pair as an ``nn.Module``.  GraphCast is the
encoder-processor-decoder variant: grid nodes are encoded onto an
icosahedral multimesh, ``n_layers`` MeshGraphNet-style blocks run on the
mesh, and the result is decoded back to the grid (arXiv:2212.12794).

The kernel takes each edge set sorted by destination, where JAX's
``segment_sum`` takes any order.  ``sort_edges`` prepares a graph once:
each edge set sorted (stable, edge features permuted alike, a sorted set
kept as it is) and its row pointers in ``Graph.rowptr``.  ``build_graph``
returns prepared graphs; ``gnn_forward`` prepares a graph that is not,
so it accepts what JAX's accepts, and no layer sorts, checks or searches
the destinations again.  The gcn branch has no mesh path.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch
from torch import nn

from repro_torch.core.state import resolve_device
from repro_torch.graph.segment_ops import scatter_sum, spmm, sym_norm_coeff
from repro_torch.kernels.spmm.ops import row_pointers
from repro_torch.models.common import (ParamTree, count_params, dense_init,
                                       layer_norm, matmul, mlp_apply,
                                       mlp_init, tree_from_numpy)


def icosphere_sizes(refinement: int) -> tuple[int, int]:
    """(n_mesh_nodes, n_multimesh_directed_edges) for refinement r."""
    n = 10 * 4 ** refinement + 2
    e = sum(60 * 4 ** l for l in range(refinement + 1))
    return n, e


class Graph(NamedTuple):
    x: torch.Tensor               # [N, Dx] node features
    edge_index: torch.Tensor      # [2, E]
    e: Any = None                 # [E, De] edge features (optional)
    # GraphCast only: the mesh graph + cross graphs
    mesh_edge_index: Any = None   # [2, Em] mesh<->mesh
    g2m_edge_index: Any = None    # [2, Eg2m] grid->mesh
    m2g_edge_index: Any = None    # [2, Em2g] mesh->grid
    # the port's own: {edge-set field: int32 [n_dst + 1] row pointers of
    # the sorted set}, from sort_edges (None: not prepared yet)
    rowptr: Any = None


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str = "gnn"
    kind: str = "gcn"             # gcn | gatedgcn | meshgraphnet | graphcast
    n_layers: int = 2
    d_hidden: int = 16
    d_in: int = 1433
    d_out: int = 7
    d_edge_in: int = 0
    aggregator: str = "mean"
    mlp_layers: int = 2           # meshgraphnet MLP depth
    mesh_refinement: int = 6      # graphcast icosphere refinement
    n_vars: int = 227             # graphcast input variables
    dropout: float = 0.0
    compute_dtype: Any = torch.float32

    def n_params(self) -> int:
        return count_params(init_gnn_params(
            self, torch.Generator().manual_seed(0)))


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def init_gnn_params(cfg: GNNConfig, gen: torch.Generator):
    """Random parameters on ``gen``'s device, in the JAX package's tree."""
    D = cfg.d_hidden

    def ones(n):
        return torch.ones(n, device=gen.device)

    def zeros(n):
        return torch.zeros(n, device=gen.device)

    if cfg.kind == "gcn":
        sizes = [cfg.d_in] + [D] * (cfg.n_layers - 1) + [cfg.d_out]
        return dict(w=[dense_init(gen, (sizes[i], sizes[i + 1]))
                       for i in range(cfg.n_layers)],
                    b=[zeros(sizes[i + 1]) for i in range(cfg.n_layers)])
    if cfg.kind == "gatedgcn":
        layers = [dict(A=dense_init(gen, (D, D)), B=dense_init(gen, (D, D)),
                       C=dense_init(gen, (D, D)), U=dense_init(gen, (D, D)),
                       V=dense_init(gen, (D, D)),
                       ln_h=ones(D), ln_hb=zeros(D),
                       ln_e=ones(D), ln_eb=zeros(D))
                  for _ in range(cfg.n_layers)]
        return dict(
            embed_h=dense_init(gen, (cfg.d_in, D)),
            embed_e=dense_init(gen, (max(cfg.d_edge_in, 1), D)),
            layers=layers,
            readout=dense_init(gen, (D, cfg.d_out)))
    if cfg.kind == "meshgraphnet":
        def mgn_mlp(din):
            return mlp_init(gen, [din] + [D] * (cfg.mlp_layers - 1) + [D])
        layers = [dict(edge=mgn_mlp(3 * D), node=mgn_mlp(2 * D),
                       ln_e=ones(D), ln_eb=zeros(D),
                       ln_h=ones(D), ln_hb=zeros(D))
                  for _ in range(cfg.n_layers)]
        return dict(
            enc_node=mlp_init(gen, [cfg.d_in, D, D]),
            enc_edge=mlp_init(gen, [max(cfg.d_edge_in, 1), D, D]),
            layers=layers,
            dec=mlp_init(gen, [D, D, cfg.d_out]))
    if cfg.kind == "graphcast":
        def mlp2(din, dout=None):
            return mlp_init(gen, [din, D, dout or D])
        return dict(
            enc_grid=mlp2(cfg.d_in),
            enc_mesh=mlp2(3),                  # mesh static features (xyz)
            g2m_edge=mlp2(4), m2g_edge=mlp2(4), mesh_edge=mlp2(4),
            g2m=dict(edge=mlp2(3 * D), node=mlp2(2 * D)),
            layers=[dict(edge=mlp2(3 * D), node=mlp2(2 * D))
                    for _ in range(cfg.n_layers)],
            m2g=dict(edge=mlp2(3 * D), node=mlp2(2 * D)),
            dec=mlp2(D, cfg.d_out))
    raise ValueError(cfg.kind)


def gnn_params_from_numpy(cfg: GNNConfig, tree, device=None):
    """The JAX package's ``init_gnn_params`` tree, as numpy arrays, as the
    port's parameters on ``device`` (default ``cuda``)."""
    if cfg.kind not in ("gcn", "gatedgcn", "meshgraphnet", "graphcast"):
        raise ValueError(cfg.kind)
    return tree_from_numpy(tree, resolve_device(device))


# --------------------------------------------------------------------------
# forwards
# --------------------------------------------------------------------------

def _sorted_edges(edge_index, e=None):
    ei = edge_index.to(torch.int32)
    dst = ei[1]
    if dst.numel() > 1 and bool((dst[1:] < dst[:-1]).any()):
        order = torch.argsort(dst, stable=True)
        ei = ei[:, order]
        e = None if e is None else e[order]
    return ei.contiguous(), e


def sort_edges(cfg: GNNConfig, g: Graph) -> Graph:
    """``g`` with each edge set int32 and sorted by destination (stable),
    ``g.e`` permuted with ``edge_index``, sorted sets kept as they are;
    and ``rowptr`` holding each set's row pointers over its destination
    nodes (the grid's, or the mesh's of ``cfg.mesh_refinement``)."""
    n_grid = g.x.shape[0]
    n_mesh = icosphere_sizes(cfg.mesh_refinement)[0]
    n_dst = dict(edge_index=n_grid, mesh_edge_index=n_mesh,
                 g2m_edge_index=n_mesh, m2g_edge_index=n_grid)
    edge_index, e = _sorted_edges(g.edge_index, g.e)
    sets = dict(edge_index=edge_index)
    for k in ("mesh_edge_index", "g2m_edge_index", "m2g_edge_index"):
        if getattr(g, k) is not None:
            sets[k] = _sorted_edges(getattr(g, k))[0]
    rowptr = {k: row_pointers(ei[1], n_dst[k]) for k, ei in sets.items()}
    return g._replace(e=e, rowptr=rowptr, **sets)


def _interaction_block(lp, h_src, h_dst, e, edge_index, n_dst, rowptr):
    """MeshGraphNet block: edge MLP + node MLP with residuals."""
    m = torch.cat([e, h_src[edge_index[0]], h_dst[edge_index[1]]], -1)
    e2 = e + mlp_apply(lp["edge"], m, act=torch.relu)
    agg = scatter_sum(e2, edge_index, n_dst, rowptr)
    h2 = h_dst + mlp_apply(lp["node"], torch.cat([h_dst, agg], -1),
                           act=torch.relu)
    return h2, e2


def _edge_ones(g: Graph, cd):
    return torch.ones((g.edge_index.shape[1], 1), dtype=cd,
                      device=g.x.device)


def gnn_forward(cfg: GNNConfig, params, g: Graph):
    cd = cfg.compute_dtype
    if g.rowptr is None:
        g = sort_edges(cfg, g)
    n = g.x.shape[0]
    rp = g.rowptr["edge_index"]
    if cfg.kind == "gcn":
        coeff = sym_norm_coeff(g.edge_index, n)
        h = g.x.to(cd)
        for i in range(cfg.n_layers):
            h = matmul(h, params["w"][i]) + params["b"][i]
            agg = spmm(h, g.edge_index, n, coeff, "sum", rp)
            h = agg.to(cd) + h  # + self loop
            if i < cfg.n_layers - 1:
                h = torch.relu(h)
        return h
    if cfg.kind == "gatedgcn":
        h = matmul(g.x.to(cd), params["embed_h"])
        e_in = g.e if g.e is not None else _edge_ones(g, cd)
        e = matmul(e_in.to(cd), params["embed_e"])
        for lp in params["layers"]:
            hs, hd = h[g.edge_index[0]], h[g.edge_index[1]]
            e_new = hs @ lp["A"] + hd @ lp["B"] + e @ lp["C"]
            eta = torch.sigmoid(e_new)
            num = scatter_sum(eta * (hs @ lp["V"]), g.edge_index, n, rp)
            den = scatter_sum(eta, g.edge_index, n, rp)
            h_new = h @ lp["U"] + num / (den + 1e-6)
            h = h + torch.relu(layer_norm(h_new, lp["ln_h"], lp["ln_hb"]))
            e = e + torch.relu(layer_norm(e_new, lp["ln_e"], lp["ln_eb"]))
        return h @ params["readout"]
    if cfg.kind == "meshgraphnet":
        h = mlp_apply(params["enc_node"], g.x.to(cd))
        e_in = g.e if g.e is not None else _edge_ones(g, cd)
        e = mlp_apply(params["enc_edge"], e_in.to(cd))
        for lp in params["layers"]:
            h2, e2 = _interaction_block(lp, h, h, e, g.edge_index, n, rp)
            h = layer_norm(h2, lp["ln_h"], lp["ln_hb"])
            e = layer_norm(e2, lp["ln_e"], lp["ln_eb"])
        return mlp_apply(params["dec"], h)
    if cfg.kind == "graphcast":
        return _graphcast_forward(cfg, params, g)
    raise ValueError(cfg.kind)


def _graphcast_forward(cfg: GNNConfig, params, g: Graph):
    """Encoder (grid->mesh) / processor (mesh) / decoder (mesh->grid)."""
    cd = cfg.compute_dtype
    dev = g.x.device
    n_grid = g.x.shape[0]
    n_mesh = icosphere_sizes(cfg.mesh_refinement)[0]  # static
    h_grid = mlp_apply(params["enc_grid"], g.x.to(cd))
    # static mesh features: use 3 pseudo-coordinates derived from index
    mi = torch.arange(n_mesh, dtype=cd, device=dev)[:, None]
    mesh_feat = torch.cat([torch.sin(mi * 0.01), torch.cos(mi * 0.01),
                           mi / max(n_mesh, 1)], dim=-1)
    h_mesh = mlp_apply(params["enc_mesh"], mesh_feat)

    def edge_feat(ei, n_a, n_b):
        d = (ei[0].to(cd) / max(n_a, 1) - ei[1].to(cd) / max(n_b, 1))[:, None]
        return torch.cat([d, d.abs(), torch.sin(d), torch.cos(d)], -1)

    # grid -> mesh encoder block (bipartite interaction)
    g2m = g.g2m_edge_index
    e_g2m = mlp_apply(params["g2m_edge"], edge_feat(g2m, n_grid, n_mesh))
    m = torch.cat([e_g2m, h_grid[g2m[0]], h_mesh[g2m[1]]], -1)
    e2 = e_g2m + mlp_apply(params["g2m"]["edge"], m)
    agg = scatter_sum(e2, g2m, n_mesh, g.rowptr["g2m_edge_index"])
    h_mesh = h_mesh + mlp_apply(params["g2m"]["node"],
                                torch.cat([h_mesh, agg], -1))
    # processor on the multimesh
    e_mesh = mlp_apply(params["mesh_edge"],
                       edge_feat(g.mesh_edge_index, n_mesh, n_mesh))
    for lp in params["layers"]:
        h_mesh, e_mesh = _interaction_block(
            lp, h_mesh, h_mesh, e_mesh, g.mesh_edge_index, n_mesh,
            g.rowptr["mesh_edge_index"])
    # mesh -> grid decoder block
    m2g = g.m2g_edge_index
    e_m2g = mlp_apply(params["m2g_edge"], edge_feat(m2g, n_mesh, n_grid))
    m = torch.cat([e_m2g, h_mesh[m2g[0]], h_grid[m2g[1]]], -1)
    e2 = e_m2g + mlp_apply(params["m2g"]["edge"], m)
    agg = scatter_sum(e2, m2g, n_grid, g.rowptr["m2g_edge_index"])
    h_grid = h_grid + mlp_apply(params["m2g"]["node"],
                                torch.cat([h_grid, agg], -1))
    return mlp_apply(params["dec"], h_grid)


@torch.no_grad()
def gnn_loss(cfg: GNNConfig, params, batch):
    """Node-level loss (forward only): classification (int labels) or
    regression (float)."""
    out = gnn_forward(cfg, params, batch["graph"])
    labels = batch["labels"]
    mask = batch.get("mask")
    if not labels.dtype.is_floating_point:
        logp = torch.log_softmax(out.float(), -1)
        loss = -logp.gather(-1, labels.long()[:, None])[:, 0]
    else:
        loss = (out.float() - labels).square().mean(-1)
    if mask is not None:
        return (loss * mask).sum() / mask.sum().clamp(min=1.0)
    return loss.mean()


class GNN(nn.Module):
    """``gnn_forward`` as an ``nn.Module`` holding its (frozen) parameters."""

    def __init__(self, cfg: GNNConfig, params):
        super().__init__()
        self.cfg = cfg
        self.params = ParamTree(params)

    @classmethod
    def from_numpy(cls, cfg: GNNConfig, tree, device=None) -> "GNN":
        return cls(cfg, gnn_params_from_numpy(cfg, tree, device))

    @torch.no_grad()
    def forward(self, g: Graph):
        return gnn_forward(self.cfg, self.params.tree(), g)
