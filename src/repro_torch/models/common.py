"""Shared model building blocks (the port of ``repro.models.common``).

Parameters are trees of plain dicts and lists of tensors, laid out like
the JAX package's pytrees, so that ``tree_from_numpy`` carries a JAX
parameter tree (as numpy arrays) across unchanged.  ``ParamTree`` holds
such a tree as an ``nn.Module``.  Random initialisation takes an explicit
``torch.Generator`` and draws on its device.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn


def rms_norm(x, scale, eps=1e-6):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


def layer_norm(x, scale, bias, eps=1e-5):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    return ((xf - mu) * torch.rsqrt(var + eps) * scale + bias).to(x.dtype)


def matmul(a, b):
    """``a @ b`` in the promoted dtype of the two, as ``jnp.matmul``."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def dense_init(gen: torch.Generator, shape, fan_in=None,
               dtype=torch.float32):
    """Normal(0, 1/sqrt(fan_in)) on ``gen``'s device, drawn in place (no
    temporary of the table's size)."""
    fan_in = fan_in or shape[0]
    out = torch.empty(shape, dtype=torch.float32, device=gen.device)
    return out.normal_(0.0, 1.0 / np.sqrt(fan_in), generator=gen).to(dtype)


def mlp_init(gen: torch.Generator, sizes, dtype=torch.float32):
    """Plain MLP params: list of ``dict(w, b)``."""
    return [dict(w=dense_init(gen, (sizes[i], sizes[i + 1]), dtype=dtype),
                 b=torch.zeros(sizes[i + 1], dtype=dtype, device=gen.device))
            for i in range(len(sizes) - 1)]


def mlp_apply(params, x, act=torch.relu, final_act=False):
    for i, lyr in enumerate(params):
        x = x @ lyr["w"].to(x.dtype) + lyr["b"].to(x.dtype)
        if i < len(params) - 1 or final_act:
            x = act(x)
    return x


def leaves(tree):
    """The tensors of a parameter tree, in order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in leaves(v)]
    return [tree]


def count_params(tree) -> int:
    return int(sum(t.numel() for t in leaves(tree)))


def tree_from_numpy(tree, device: torch.device):
    """A parameter tree of numpy arrays (e.g. a JAX pytree passed through
    ``np.asarray``) as tensors on ``device``, same structure."""
    if isinstance(tree, dict):
        return {k: tree_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_from_numpy(v, device) for v in tree]
    return torch.tensor(np.asarray(tree), device=device)


class ParamTree(nn.Module):
    """A parameter tree held as an ``nn.Module`` (frozen parameters, for
    serving); ``tree()`` gives the dicts and lists back."""

    def __init__(self, tree):
        super().__init__()
        self._is_dict = isinstance(tree, dict)
        values = list(tree.values()) if self._is_dict else list(tree)
        self._keys = ([str(k) for k in tree] if self._is_dict
                      else [str(i) for i in range(len(values))])
        for k, v in zip(self._keys, values):
            if isinstance(v, torch.Tensor):
                self.register_parameter(k, nn.Parameter(v,
                                                        requires_grad=False))
            else:
                self.add_module(k, ParamTree(v))

    def tree(self):
        vals = [self._parameters[k] if k in self._parameters
                else self._modules[k].tree() for k in self._keys]
        return dict(zip(self._keys, vals)) if self._is_dict else vals
