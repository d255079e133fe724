"""Config/shape registry plumbing (the port's copy of
``repro.configs.base``: the shapes of the LM, GNN and recsys families).

Every architecture contributes an ArchBundle: the exact published
configuration, its shape set, and a reduced smoke config runnable on CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # lm_train | lm_prefill | lm_decode |
                       # gnn_full | gnn_minibatch | gnn_batched |
                       # recsys_train | recsys_serve | recsys_retrieval |
                       # cca_stream
    dims: tuple        # sorted (key, value) pairs

    def dim(self, k, default=None):
        return dict(self.dims).get(k, default)


def shape(name, kind, **dims) -> ShapeSpec:
    return ShapeSpec(name=name, kind=kind, dims=tuple(sorted(dims.items())))


@dataclasses.dataclass(frozen=True)
class ArchBundle:
    arch_id: str
    family: str        # lm | gnn | recsys
    config: Any
    shapes: tuple
    smoke: Callable    # () -> reduced config (same family)
    notes: str = ""


# ---- the common LM shape set (assigned to all 5 LM archs) ----

def lm_shapes():
    return (
        shape("train_4k", "lm_train", seq_len=4096, global_batch=256),
        shape("prefill_32k", "lm_prefill", seq_len=32768, global_batch=32),
        shape("decode_32k", "lm_decode", seq_len=32768, global_batch=128),
        # decode against a 512k KV cache is linear in seq_len (one query)
        shape("long_500k", "lm_decode", seq_len=524288, global_batch=1),
    )


def gnn_shapes():
    return (
        shape("full_graph_sm", "gnn_full", n_nodes=2708, n_edges=10556,
              d_feat=1433),
        shape("minibatch_lg", "gnn_minibatch", n_nodes=232965,
              n_edges=114615892, batch_nodes=1024, fanout=(15, 10),
              d_feat=602),
        shape("ogb_products", "gnn_full", n_nodes=2449029, n_edges=61859140,
              d_feat=100),
        shape("molecule", "gnn_batched", n_nodes=30, n_edges=64, batch=128,
              d_feat=32),
    )


def recsys_shapes():
    return (
        shape("train_batch", "recsys_train", batch=65536),
        shape("serve_p99", "recsys_serve", batch=512),
        shape("serve_bulk", "recsys_serve", batch=262144),
        shape("retrieval_cand", "recsys_retrieval", batch=1,
              n_candidates=1_000_000),
    )
