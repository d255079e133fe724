"""Deterministic synthetic batch streams (the port's copy of
``repro.data.pipeline``).

Every batch is a pure function of (seed, step), drawn in numpy with the
JAX package's random calls in the same order, so both packages see the
same batches.  Batches are numpy arrays; the caller puts them on a device.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class LMBatchSpec:
    batch: int
    seq_len: int
    vocab: int
    seed: int = 0


def lm_batch(spec: LMBatchSpec, step: int) -> dict:
    rng = np.random.default_rng((spec.seed << 20) ^ step)
    # zipf-ish token distribution (more realistic activation stats)
    z = rng.zipf(1.3, size=(spec.batch, spec.seq_len + 1))
    toks = (z % spec.vocab).astype(np.int32)
    return dict(tokens=toks[:, :-1], targets=toks[:, 1:])


@dataclasses.dataclass(frozen=True)
class RecSysBatchSpec:
    batch: int
    n_dense: int
    n_sparse: int
    lookups: int
    vocab_sizes: tuple
    seed: int = 0


def recsys_batch(spec: RecSysBatchSpec, step: int) -> dict:
    rng = np.random.default_rng((spec.seed << 20) ^ step)
    dense = rng.standard_normal((spec.batch, spec.n_dense),
                                dtype=np.float32)
    sparse = np.stack(
        [rng.integers(0, v, size=(spec.batch, spec.lookups))
         for v in spec.vocab_sizes], axis=1).astype(np.int32)
    labels = rng.integers(0, 2, size=(spec.batch,)).astype(np.int32)
    return dict(dense=dense, sparse=sparse, labels=labels)
