"""Plain PyTorch version of the EmbeddingBag (``jnp.take`` semantics: an
index in ``[-V, -1]`` counts from the end of the table, one outside
``[-V, V)`` gives a NaN row)."""
from __future__ import annotations

import torch


def embedding_bag_ref(table: torch.Tensor, indices: torch.Tensor,
                      weights: torch.Tensor | None = None,
                      combiner: str = "sum") -> torch.Tensor:
    """table: [V, D]; indices: [B, L]; weights: [B, L] or None -> [B, D]."""
    V = table.shape[0]
    idx = indices.long()
    idx = torch.where(idx < 0, idx + V, idx)
    valid = (idx >= 0) & (idx < V)
    rows = table[idx.clamp(0, max(V - 1, 0))].float()       # [B, L, D]
    rows = torch.where(valid[..., None], rows, float("nan"))
    if weights is not None:
        rows = rows * weights[..., None]
    out = rows.sum(dim=1)
    if combiner == "mean":
        out = out / indices.shape[1]
    return out


def embedding_bags_ref(tables, indices: torch.Tensor,
                       weights: torch.Tensor | None = None,
                       combiner: str = "sum") -> torch.Tensor:
    """F tables [V_f, D]; indices: [B, F, L] -> [B, F, D], field by field."""
    return torch.stack(
        [embedding_bag_ref(t, indices[:, f],
                           None if weights is None else weights[:, f],
                           combiner) for f, t in enumerate(tables)], dim=1)
