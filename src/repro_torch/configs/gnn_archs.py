"""The four GNN architectures (public configs), as in
``repro.configs.gnn_archs``."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchBundle, gnn_shapes
from repro_torch.models.gnn import GNNConfig

# gatedgcn [arXiv:2003.00982] — benchmarking-GNNs config
GATEDGCN = GNNConfig(name="gatedgcn", kind="gatedgcn", n_layers=16,
                     d_hidden=70, d_in=1433, d_out=8, aggregator="gated")

# gcn-cora [arXiv:1609.02907] — the original 2-layer GCN on Cora
GCN_CORA = GNNConfig(name="gcn-cora", kind="gcn", n_layers=2, d_hidden=16,
                     d_in=1433, d_out=7, aggregator="mean")

# graphcast [arXiv:2212.12794] — encoder-processor-decoder mesh GNN
GRAPHCAST = GNNConfig(name="graphcast", kind="graphcast", n_layers=16,
                      d_hidden=512, mesh_refinement=6, n_vars=227,
                      d_in=227, d_out=227, aggregator="sum")

# meshgraphnet [arXiv:2010.03409]
MESHGRAPHNET = GNNConfig(name="meshgraphnet", kind="meshgraphnet",
                         n_layers=15, d_hidden=128, mlp_layers=2,
                         d_in=12, d_out=3, aggregator="sum")


def _smoke(cfg: GNNConfig) -> GNNConfig:
    return dataclasses.replace(
        cfg, n_layers=min(cfg.n_layers, 3), d_hidden=min(cfg.d_hidden, 16),
        d_in=8, d_out=4, n_vars=8, mesh_refinement=1)


def bundles():
    return [
        ArchBundle(a.name, "gnn", a, gnn_shapes(), (lambda c=a: _smoke(c)),
                   notes="paper technique directly applicable (DESIGN §5)")
        for a in (GATEDGCN, GCN_CORA, GRAPHCAST, MESHGRAPHNET)
    ]
