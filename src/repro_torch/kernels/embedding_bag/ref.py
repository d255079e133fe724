"""Plain PyTorch version of the EmbeddingBag (``jnp.take`` semantics: an
index in ``[-V, -1]`` counts from the end of the table, one outside
``[-V, V)`` gives a NaN row)."""
from __future__ import annotations

import torch


def take_rows(table: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """``table[indices]`` as ``jnp.take`` reads it, f32: [..., D], a NaN
    row for an index outside ``[-V, V)``."""
    V = table.shape[0]
    idx = indices.long()
    idx = torch.where(idx < 0, idx + V, idx)
    valid = (idx >= 0) & (idx < V)
    if V == 0:
        return torch.full((*idx.shape, table.shape[1]), float("nan"),
                          device=table.device)
    rows = table[idx.clamp(0, V - 1)].float()
    return torch.where(valid[..., None], rows, float("nan"))


def embedding_bag_ref(table: torch.Tensor, indices: torch.Tensor,
                      weights: torch.Tensor | None = None,
                      combiner: str = "sum") -> torch.Tensor:
    """table: [V, D]; indices: [B, L]; weights: [B, L] or None -> [B, D]."""
    rows = take_rows(table, indices)                          # [B, L, D]
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


def embedding_bags_ordered(tables, indices: torch.Tensor,
                           weights: torch.Tensor | None = None,
                           combiner: str = "sum") -> torch.Tensor:
    """``embedding_bags_ref`` in the kernel's order and rounding
    (``csrc/embedding_bag.cu``), for tests and ``chip_smoke.py``: each bag
    starts from 0 and adds its lookups l = 0 .. L-1 one at a time, each
    row (times its weight, one rounding) rounded into the sum, and the
    mean divides the sum by L in one rounding.  The divisor is a tensor on
    the sum's device: PyTorch's CUDA division by a host scalar multiplies
    by its reciprocal, which is not the kernel's rounding."""
    B, F, L = indices.shape
    out = []
    for f, t in enumerate(tables):
        rows = take_rows(t, indices[:, f])                    # [B, L, D]
        if weights is not None:
            rows = rows * weights[:, f, :, None]
        acc = torch.zeros((B, t.shape[1]), device=rows.device)
        for l in range(L):
            acc = acc + rows[:, l]
        if combiner == "mean":
            acc = acc / torch.tensor(float(L), device=acc.device)
        out.append(acc)
    return torch.stack(out, dim=1)


def embedding_bags_bwd_ref(vocabs, indices: torch.Tensor, gout: torch.Tensor,
                           weights: torch.Tensor | None = None,
                           combiner: str = "sum") -> list:
    """The tables' dense gradients [V_f, D] f32 for the bag gradients
    ``gout`` [B, F, D]: each lookup's ``gout[b, f]`` (/ L for the mean,
    then x its weight) added into the row it read, by ``index_add_`` in
    (b, l) order; a lookup outside ``[-V, V)`` adds nothing (``jnp.take``'s
    fill mode drops it), what JAX's autodiff of the gather gives."""
    B, F, L = indices.shape
    out = []
    for f, V in enumerate(vocabs):
        g = gout[:, f].float()
        if combiner == "mean":
            g = g / torch.tensor(float(L), device=g.device)
        terms = g[:, None, :].expand(B, L, g.shape[1])
        if weights is not None:
            terms = terms * weights[:, f, :, None]
        idx = indices[:, f].long()
        idx = torch.where(idx < 0, idx + V, idx)
        keep = ((idx >= 0) & (idx < V)).reshape(-1)
        grad = torch.zeros((V, g.shape[1]), dtype=torch.float32,
                           device=g.device)
        out.append(grad.index_add_(0, idx.reshape(-1)[keep],
                                   terms.reshape(B * L, -1)[keep]))
    return out
