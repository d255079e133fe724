"""DLRM (RM2-class): sparse embedding bags -> dot interaction -> MLPs (the
port of ``repro.models.dlrm``; forward, loss and retrieval).

The lookups are the EmbeddingBag kernel (``kernels/embedding_bag``): on
the card one launch gathers and reduces all ``n_sparse`` fields of a
batch; on the CPU its plain version does.  The dot interaction and the
MLPs are plain ``torch`` matrix products, as the JAX package leaves them
to XLA.  The lookup is the paper's "send work to data" principle applied
to recsys: only the touched rows of the tables are read.

The kernel reads f32 tables and sums in f32; the result is cast to
``compute_dtype`` after the lookup (JAX casts the tables first).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np
import torch

from repro_torch.core.state import resolve_device
from repro_torch.kernels.embedding_bag import ops as bag_ops
from repro_torch.models.common import (dense_init, mlp_apply, mlp_init,
                                       tree_from_numpy)


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    name: str = "dlrm"
    n_dense: int = 13
    n_sparse: int = 26
    embed_dim: int = 64
    vocab_sizes: tuple = ()          # len == n_sparse
    lookups_per_field: int = 4       # multi-hot bag size (RM2-style)
    bot_mlp: tuple = (512, 256, 64)
    top_mlp: tuple = (512, 256, 1)
    interaction: str = "dot"
    compute_dtype: Any = torch.float32

    def resolved_vocabs(self) -> tuple:
        if self.vocab_sizes:
            return self.vocab_sizes
        # Criteo-like mix: a few huge tables, many small.  All sizes are
        # multiples of 512 so tables row-shard evenly on any mesh axis.
        base = [33_554_432, 8_388_608, 4_194_304, 1_048_576, 524_288,
                131_072, 65_536, 16_384, 4_096, 1_024]
        return tuple(base[i % len(base)] for i in range(self.n_sparse))

    def n_params(self) -> int:
        emb = sum(self.resolved_vocabs()) * self.embed_dim
        sizes = [self.n_dense, *self.bot_mlp]
        bot = sum(sizes[i] * sizes[i + 1] + sizes[i + 1]
                  for i in range(len(sizes) - 1))
        n_vec = self.n_sparse + 1
        d_int = n_vec * (n_vec - 1) // 2 + self.bot_mlp[-1]
        sizes = [d_int, *self.top_mlp]
        top = sum(sizes[i] * sizes[i + 1] + sizes[i + 1]
                  for i in range(len(sizes) - 1))
        return emb + bot + top


def init_dlrm_params(cfg: DLRMConfig, gen: torch.Generator):
    """Random parameters on ``gen``'s device, in the JAX package's tree;
    each table is drawn in place on the device."""
    tables = [dense_init(gen, (v, cfg.embed_dim), cfg.embed_dim)
              for v in cfg.resolved_vocabs()]
    n_vec = cfg.n_sparse + 1
    d_int = n_vec * (n_vec - 1) // 2 + cfg.bot_mlp[-1]
    return dict(tables=tables,
                bot=mlp_init(gen, [cfg.n_dense, *cfg.bot_mlp]),
                top=mlp_init(gen, [d_int, *cfg.top_mlp]))


def dlrm_params_from_numpy(cfg: DLRMConfig, tree, device=None):
    """The JAX package's ``init_dlrm_params`` tree, as numpy arrays, as the
    port's parameters on ``device`` (default ``cuda``)."""
    shapes = [tuple(np.shape(t)) for t in tree["tables"]]
    want = [(v, cfg.embed_dim) for v in cfg.resolved_vocabs()]
    if shapes != want:
        raise ValueError(f"tables {shapes} do not fit {cfg.name}: {want}")
    return tree_from_numpy(tree, resolve_device(device))


def prepare_dlrm_params(params):
    """``params`` with its tables checked once for the EmbeddingBag kernel
    (``bag_ops.prepare_tables``), for serving: a forward over them skips
    the per-table checks of every call.  Prepare again after resizing a
    table or giving it other storage."""
    return dict(params, tables=bag_ops.prepare_tables(params["tables"]))


def embedding_bag(table, indices, weights=None, combiner="sum"):
    """table: [V, D]; indices: [B, L] -> [B, D] (the kernel's F = 1 case)."""
    return bag_ops.embedding_bag_fwd(table, indices, weights, combiner)


def _bottom_and_bags(cfg: DLRMConfig, params, batch):
    cd = cfg.compute_dtype
    x_bot = mlp_apply(params["bot"], batch["dense"].to(cd), final_act=True)
    embs = bag_ops.embedding_bags(params["tables"], batch["sparse"])
    return x_bot, embs.to(cd)                       # [B, D], [B, F, D]


@functools.lru_cache(maxsize=8)
def _triu(n: int, dev: torch.device):
    """The strict upper triangle's (rows, cols) on ``dev``, made once (a
    copy to the card per forward would sync the host)."""
    return tuple(torch.as_tensor(a, device=dev)
                 for a in np.triu_indices(n, k=1))


def dlrm_forward(cfg: DLRMConfig, params, batch):
    """batch: dense [B, n_dense] f32; sparse [B, n_sparse, L] i32."""
    x_bot, embs = _bottom_and_bags(cfg, params, batch)
    vecs = torch.cat([x_bot[:, None], embs], dim=1)  # [B, F+1, D]
    if cfg.interaction != "dot":
        raise ValueError(cfg.interaction)
    z = torch.bmm(vecs, vecs.transpose(1, 2))
    iu, ju = _triu(vecs.shape[1], z.device)
    inter = z[:, iu, ju]                             # [B, F(F+1)/2]
    top_in = torch.cat([x_bot, inter], dim=-1)
    return mlp_apply(params["top"], top_in)[:, 0]   # logits [B]


def dlrm_loss(cfg: DLRMConfig, params, batch):
    z = dlrm_forward(cfg, params, batch).float()
    y = batch["labels"].float()
    # sigmoid BCE with logits
    loss = z.clamp(min=0) - z * y + torch.log1p(torch.exp(-z.abs()))
    return loss.mean()


# ---------------- retrieval (two-tower scoring) ----------------

def retrieval_score(cfg: DLRMConfig, params, batch):
    """Score one (or few) queries against a large candidate set.

    batch: dense [B, n_dense], sparse [B, n_sparse, L],
           candidates [C, D] — returns top-100 (scores, ids).
    """
    x_bot, embs = _bottom_and_bags(cfg, params, batch)
    user = x_bot + embs.sum(dim=1)                  # [B, D] user tower
    cand = batch["candidates"].to(cfg.compute_dtype)
    scores = user @ cand.T                          # batched dot  [B, C]
    return torch.topk(scores, 100)
