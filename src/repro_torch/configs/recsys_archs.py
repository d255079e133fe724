"""dlrm-rm2 [arXiv:1906.00091], as in ``repro.configs.recsys_archs``."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchBundle, recsys_shapes
from repro_torch.models.dlrm import DLRMConfig

DLRM_RM2 = DLRMConfig(
    name="dlrm-rm2", n_dense=13, n_sparse=26, embed_dim=64,
    bot_mlp=(512, 256, 64), top_mlp=(512, 512, 256, 1), interaction="dot",
    lookups_per_field=4)


def _smoke(cfg: DLRMConfig) -> DLRMConfig:
    return dataclasses.replace(
        cfg, n_sparse=4, embed_dim=8, bot_mlp=(16, 8), top_mlp=(16, 8, 1),
        vocab_sizes=(64, 32, 16, 8), lookups_per_field=2)


def bundles():
    return [ArchBundle(
        "dlrm-rm2", "recsys", DLRM_RM2, recsys_shapes(),
        lambda: _smoke(DLRM_RM2),
        notes="embedding lookup = 'work to data' (DESIGN §5); "
              "tables row-sharded over the model axis")]
