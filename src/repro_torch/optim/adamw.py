"""AdamW + schedules + global-norm clipping (the port of
``repro.optim.adamw``), in f32.

The same update as the JAX package's: the gradients scaled by
``min(1, grad_clip / (global_norm + 1e-9))``, the step's learning rate
from ``schedule`` (linear warmup, then cosine down to ``min_lr_frac``),
bias-corrected moments and decoupled weight decay.  Where JAX returns new
arrays, ``adamw_update`` writes the parameters and the moments in place
(under ``torch.no_grad``) and returns the same tensors in the same
structure: a caller that holds them (``prepare_tables``' handle of the
DLRM tables, a checkpoint of the tree) keeps seeing them, and no second
copy of the model and its moments is made.  The schedule's scalars are
f32 device tensors computed as ``jnp`` computes them, so the step count
never leaves the device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch.dist.sharding import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class AdamWState(NamedTuple):
    step: torch.Tensor      # int32 scalar
    m: dict
    v: dict


def schedule(cfg: AdamWConfig, step):
    """The learning rate at ``step`` (an int or an int32 tensor), f32."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def init_adamw(params) -> AdamWState:
    """Zero moments like ``params`` (f32 where a leaf is), step 0 on the
    first leaf's device."""
    dev = tree_leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=tree_map(torch.zeros_like, params),
                      v=tree_map(torch.zeros_like, params))


def global_norm(tree):
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads, state: AdamWState, params):
    """One AdamW step: ``(params, state, gnorm)``, the parameters and the
    moments updated in place and returned in their structure."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = schedule(cfg, step)
    stepf = step.float()
    b1c = 1 - torch.pow(torch.tensor(cfg.b1, device=stepf.device), stepf)
    b2c = 1 - torch.pow(torch.tensor(cfg.b2, device=stepf.device), stepf)
    for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state.m),
                          tree_leaves(state.v), tree_leaves(params)):
        g = g.float() * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g))
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) \
            + cfg.weight_decay * p.float()
        p.copy_((p - lr * delta.to(p.dtype)).to(p.dtype))
    return params, AdamWState(step=step, m=state.m, v=state.v), gnorm
