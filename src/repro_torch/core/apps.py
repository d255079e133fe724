"""Diffusion applications: the paper's ``bfs-action`` plus SSSP and CC.

Each app is a *monotone relaxation* (``core/apps.py`` of the JAX
package): ``relax(vals, incoming) -> (new_vals, changed)`` at the
target, ``edge_value(src_val, w)`` along an edge, and
``propagate_on_insert(vals)`` (Listing 4, line 7).  All three are
min-monotone with ``1e9`` as "unreached".  ``code`` is the app's number
in the CUDA cycle kernel (``kernels/cca_cycle/csrc/cca_cycle.cu``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

INF = 1e9


@dataclasses.dataclass(frozen=True)
class DiffusionApp:
    name: str
    code: int
    edge_value: Callable          # (src value, edge weight) -> value
    init_val: float = INF
    n_vals: int = 1
    qbatch: int = 1
    fwd_neutral: float = INF

    @staticmethod
    def relax(vals, incoming):
        """Min-relax of value 0: ``(new vals, changed)``."""
        v = vals[..., 0]
        changed = incoming < v
        new = vals.clone()
        new[..., 0] = torch.where(changed, incoming, v)
        return new, changed

    @staticmethod
    def propagate_on_insert(vals):
        return vals[..., 0] < INF

    @staticmethod
    def fwd_merge(a, b):
        return torch.minimum(a, b)


BFS = DiffusionApp(name="bfs", code=0, edge_value=lambda v, w: v + 1.0)
SSSP = DiffusionApp(name="sssp", code=1, edge_value=lambda v, w: v + w)
CC = DiffusionApp(name="cc", code=2, edge_value=lambda v, w: v)

APPS = {a.name: a for a in (BFS, SSSP, CC)}
