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
