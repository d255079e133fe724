"""Diffusion applications: the paper's ``bfs-action``, SSSP, CC, the
ingestion-only mode, and the max-monotone widest and most-reliable paths.

Each app is a *monotone relaxation* (``core/apps.py`` of the JAX
package): ``relax(vals, incoming) -> (new_vals, changed)`` at the
target, ``edge_value(src_val, w)`` along an edge, and
``propagate_on_insert(vals)`` (Listing 4, line 7).  The first four are
min-monotone with ``1e9`` as "unreached"; ``widest`` and ``reliable``
are max-monotone with ``0`` as "unreached", so their ``combine``,
``fwd_merge`` and ``fwd_neutral`` flip.  ``code`` is the app's number in
the CUDA cycle kernel (``kernels/cca_cycle/csrc/cca_cycle.cu``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

INF = 1e9


@dataclasses.dataclass(frozen=True)
class DiffusionApp:
    name: str
    code: int
    # (vals[..., VN], incoming [...]) -> (new vals, changed bool [...])
    relax: Callable
    # (emit source value, edge weight) -> value
    edge_value: Callable
    # vals[..., VN] -> bool [...]: propagate on edge-insert?
    propagate_on_insert: Callable
    init_val: float = INF
    n_vals: int = 1
    # host-side merge of one vertex's values across its rhizome roots
    combine: Callable = np.minimum
    # coalescing rule of the deferred app-forward register, and the
    # element that loses every merge
    fwd_merge: Callable = torch.minimum
    fwd_neutral: float = INF
    qbatch: int = 1


def _min_relax(vals, incoming):
    """Min-relax of value 0: ``(new vals, changed)``."""
    v = vals[..., 0]
    changed = incoming < v
    new = vals.clone()
    new[..., 0] = torch.where(changed, incoming, v)
    return new, changed


def _max_relax(vals, incoming):
    """Max-relax of value 0: ``(new vals, changed)``."""
    v = vals[..., 0]
    changed = incoming > v
    new = vals.clone()
    new[..., 0] = torch.where(changed, incoming, v)
    return new, changed


def _reached(vals):
    return vals[..., 0] < INF


def _never(vals):
    return torch.zeros(vals.shape[:-1], dtype=torch.bool, device=vals.device)


BFS = DiffusionApp(name="bfs", code=0, relax=_min_relax,
                   edge_value=lambda v, w: v + 1.0,
                   propagate_on_insert=_reached)
SSSP = DiffusionApp(name="sssp", code=1, relax=_min_relax,
                    edge_value=lambda v, w: v + w,
                    propagate_on_insert=_reached)
CC = DiffusionApp(name="cc", code=2, relax=_min_relax,
                  edge_value=lambda v, w: v, propagate_on_insert=_reached)
# Ingestion only: the paper's experiment with bfs-action propagation off
# (§5), to isolate streaming-insert time.  Values never change.
INGEST_ONLY = DiffusionApp(name="ingest_only", code=3,
                           relax=lambda vals, incoming: (vals, _never(vals)),
                           edge_value=lambda v, w: v,
                           propagate_on_insert=_never)

# Widest path (maximin bottleneck capacity): an edge caps the path at
# min(path, w), sources seed +INF.
WIDEST = DiffusionApp(name="widest", code=4, relax=_max_relax,
                      edge_value=lambda v, w: torch.minimum(v, w),
                      propagate_on_insert=lambda vals: vals[..., 0] > 0.0,
                      init_val=0.0, combine=np.maximum,
                      fwd_merge=torch.maximum, fwd_neutral=0.0)
# Most-reliable path: the max-product of edge reliabilities in (0, 1],
# one IEEE f32 multiply an edge.
RELIABLE = DiffusionApp(name="reliable", code=5, relax=_max_relax,
                        edge_value=lambda v, w: v * w,
                        propagate_on_insert=lambda vals: vals[..., 0] > 0.0,
                        init_val=0.0, combine=np.maximum,
                        fwd_merge=torch.maximum, fwd_neutral=0.0)

APPS = {a.name: a for a in (BFS, SSSP, CC, INGEST_ONLY, WIDEST, RELIABLE)}
