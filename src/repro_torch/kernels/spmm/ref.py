"""Plain PyTorch version of the scatter-SpMM (``jax.ops.segment_sum``
semantics): a destination outside ``[0, n_nodes)`` is dropped and an
empty segment is 0."""
from __future__ import annotations

import torch


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` as JAX reads it: a negative index counts from the end,
    then every index is clamped into ``[0, len(x))``."""
    n = x.shape[0]
    idx = idx.long()
    return x[torch.where(idx < 0, idx + n, idx).clamp(0, max(n - 1, 0))]


def scatter_spmm_ref(msgs: torch.Tensor, dst: torch.Tensor,
                     n_nodes: int) -> torch.Tensor:
    """msgs: [E, D]; dst: [E] -> [n_nodes, D] f32, summed by destination."""
    keep = (dst >= 0) & (dst < n_nodes)
    out = torch.zeros((n_nodes, msgs.shape[1]), dtype=torch.float32,
                      device=msgs.device)
    return out.index_add_(0, dst[keep].long(), msgs[keep].float())


def spmm_sorted_coo_ref(x: torch.Tensor, src: torch.Tensor,
                        dst: torch.Tensor, n_nodes: int,
                        coeff: torch.Tensor | None = None) -> torch.Tensor:
    """A @ X over COO edges: gather ``x[src]``, scale by ``coeff``, sum by
    ``dst``."""
    msgs = take_rows(x, src)
    if coeff is not None:
        msgs = msgs * coeff[:, None]
    return scatter_spmm_ref(msgs, dst, n_nodes)


def spmm_ordered(x: torch.Tensor, src: torch.Tensor | None,
                 dst: torch.Tensor, n_nodes: int,
                 coeff: torch.Tensor | None = None,
                 groups: int = 1) -> torch.Tensor:
    """The segment sums in the kernel's order (``csrc/spmm.cu``), f32,
    for tests and ``chip_smoke.py``: edge k of a row (counted from the
    row's first edge; ``dst`` sorted ascending) goes to partial sum k %
    ``groups``, each partial sums its edges in order from 0, and the
    partials are folded pairwise, neighbours first.  ``groups`` is 32 /
    lanes of the kernel's warp (``ops.geometry``), 1 for the wide shape.
    The message is ``x[src] * coeff``, or row e of ``x`` without src."""
    msgs = x if src is None else take_rows(x, src)
    if coeff is not None:
        msgs = msgs * coeff[:, None]
    keep = (dst >= 0) & (dst < n_nodes)
    first = torch.searchsorted(dst, dst)          # each edge's row start
    k = (torch.arange(dst.shape[0], device=dst.device) - first)[keep]
    rows, msgs = dst[keep].long(), msgs[keep].float()
    g, pos = k % groups, k // groups
    part = torch.zeros((n_nodes, groups, msgs.shape[1]), dtype=torch.float32,
                       device=msgs.device)
    for p in range(int(pos.max()) + 1 if pos.numel() else 0):
        sel = pos == p                    # one edge a (row, group) at most
        r, gs = rows[sel], g[sel]
        part[r, gs] = part[r, gs] + msgs[sel]
    while part.shape[1] > 1:
        part = part[:, 0::2] + part[:, 1::2]
    return part[:, 0]


def source_rows(src: torch.Tensor, n: int) -> tuple[torch.Tensor,
                                                   torch.Tensor]:
    """(rows, valid): the row of ``n`` each ``src`` names (negative from
    the end) and whether it names one.  ``take_rows`` reads the clamped
    row where it does not, but JAX's gradient of that gather drops such an
    index (its scatter-add drops out-of-bounds updates)."""
    idx = src.long()
    idx = torch.where(idx < 0, idx + n, idx)
    return idx.clamp(0, max(n - 1, 0)), (idx >= 0) & (idx < n)


def scatter_spmm_bwd_ref(g: torch.Tensor, dst: torch.Tensor,
                         n_nodes: int) -> torch.Tensor:
    """The gradient of ``scatter_spmm_ref`` with respect to its messages,
    given the output gradient ``g`` [n_nodes, D]: ``g[dst]``, 0 for an
    edge whose destination was dropped (what XLA's autodiff of
    ``segment_sum`` gives)."""
    keep = (dst >= 0) & (dst < n_nodes)
    rows = g.float()[dst.long().clamp(0, max(n_nodes - 1, 0))]
    return torch.where(keep[:, None], rows, 0.0)


def spmm_sorted_coo_bwd_ref(g: torch.Tensor, x: torch.Tensor,
                            src: torch.Tensor, dst: torch.Tensor,
                            n_nodes: int,
                            coeff: torch.Tensor | None = None
                            ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The plain backward of ``spmm_sorted_coo_ref`` for the output
    gradient ``g`` [n_nodes, D]: (dx = A^T g [len(x), D] f32, the sum over
    the kept edges e of coeff[e] g[dst[e]] into row src[e] of x, where
    src[e] names one (``source_rows``); dcoeff [E] = <x[src[e]],
    g[dst[e]]>, 0 where dst[e] was dropped, or None without ``coeff``)."""
    gd = scatter_spmm_bwd_ref(g, dst, n_nodes)            # [E, D]
    msgs = gd if coeff is None else gd * coeff[:, None]
    dx = torch.zeros((x.shape[0], g.shape[1]), dtype=torch.float32,
                     device=g.device)
    rows, valid = source_rows(src, x.shape[0])
    dx.index_add_(0, rows[valid], msgs[valid])
    dcoeff = None if coeff is None else (take_rows(x, src).float()
                                         * gd).sum(-1)
    return dx, dcoeff
