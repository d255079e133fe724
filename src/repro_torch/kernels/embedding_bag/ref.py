"""Plain PyTorch version of the EmbeddingBag (``jnp.take`` semantics: an
index in ``[-V, -1]`` counts from the end of the table, one outside
``[-V, V)`` gives a NaN row)."""
from __future__ import annotations

import torch

SEGMENT = 32    # sorted lookups a segment of the backward kernel (its S)


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
                                   terms.reshape(B * L, g.shape[1])[keep]))
    return out


def bwd_keys_ref(vocabs, indices: torch.Tensor):
    """The backward's key pass and sort, plainly: (keys, pos, order).
    ``keys`` [B F L] int32 is each lookup's global row (its table's row,
    as ``jnp.take`` reads the index, plus the rows of the tables before
    it), or the total of rows for an index outside ``[-V, V)``; ``pos``
    int32 its flat (b, f, l) position; both in (b, f, l) order, as
    ``bag_bwd_keys_kernel`` writes them.  ``order`` (int64) sorts them
    stably by key, as the wrapper's sort does."""
    dev = indices.device
    V = torch.tensor(list(vocabs), dtype=torch.int64, device=dev)
    first = torch.cumsum(V, 0) - V                     # each table's first row
    idx = indices.long()
    idx = torch.where(idx < 0, idx + V[:, None], idx)
    keep = (idx >= 0) & (idx < V[:, None])
    keys = torch.where(keep, idx + first[:, None],
                       int(V.sum())).reshape(-1).int()
    pos = torch.arange(keys.numel(), dtype=torch.int32, device=dev)
    return keys, pos, torch.sort(keys, stable=True)[1]


def _fold(x: torch.Tensor, start: torch.Tensor,
          count: torch.Tensor) -> torch.Tensor:
    """out[i] = (((0 + x[s]) + x[s + 1]) + ...) + x[s + count[i] - 1] for
    s = start[i]: each sum from 0 in order, one f32 rounding an add; the
    sums side by side, longest first."""
    out = x.new_zeros((start.numel(), x.shape[1]))
    if not start.numel():
        return out
    order = torch.argsort(count, descending=True, stable=True)
    first = start[order]
    acc = torch.zeros_like(out)
    # more[j]: the sums with more than j terms (a prefix of ``order``)
    more = (count.numel() - torch.cumsum(torch.bincount(count), 0)).tolist()
    for j, k in enumerate(more[:-1]):
        acc[:k] = acc[:k] + x[first[:k] + j]
    out[order] = acc
    return out


def embedding_bags_bwd_ordered(vocabs, indices: torch.Tensor,
                               gout: torch.Tensor,
                               weights: torch.Tensor | None = None,
                               combiner: str = "sum",
                               segment: int = SEGMENT) -> list:
    """``embedding_bags_bwd_ref`` in the backward kernel's order and
    rounding (``csrc/embedding_bag.cu``), for tests and ``chip_smoke.py``.
    The lookups sorted stably by global row (``bwd_keys_ref``) are cut
    into segments of ``segment``; each run of one row within a segment
    (a fragment) sums its terms from 0 in that order, each term
    ``gout[b, f]`` divided by L for the mean, then times its weight, one
    rounding each; each row is the sum from 0 of its fragments in segment
    order; a row no lookup reads is +0.0.  Where ``segment`` >= B F L,
    this is ``embedding_bags_bwd_ref``'s ``index_add_`` on the CPU."""
    B, F, L = indices.shape
    D = gout.shape[-1]
    total = sum(vocabs)
    keys, _, order = bwd_keys_ref(vocabs, indices)
    sk = keys[order]
    m = int((sk < total).sum())                        # dropped ones last
    sk, sp = sk[:m].long(), order[:m]
    t = gout.reshape(B * F, D).float()[sp // L]
    if combiner == "mean":
        t = t / torch.tensor(float(L), device=t.device)
    if weights is not None:
        t = t * weights.reshape(-1)[sp][:, None]
    e = torch.arange(m, device=t.device)
    opens = torch.ones(m, dtype=torch.bool, device=t.device)
    opens[1:] = sk[1:] != sk[:-1]                      # a row's run opens
    fstart = e[opens | (e % segment == 0)]             # a fragment opens
    fcount = torch.diff(fstart, append=fstart.new_tensor([m]))
    parts = _fold(t, fstart, fcount)
    rstart = torch.nonzero(opens[fstart]).reshape(-1)  # its run's first
    rcount = torch.diff(rstart, append=rstart.new_tensor([fstart.numel()]))
    grad = torch.zeros((total, D), dtype=torch.float32, device=t.device)
    grad[sk[fstart[rstart]]] = _fold(parts, rstart, rcount)
    return list(torch.split(grad, list(vocabs)))
