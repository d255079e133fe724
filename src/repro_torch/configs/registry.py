"""Central architecture registry: ``--arch <id>`` resolution (the port's
copy of ``repro.configs.registry``)."""
from __future__ import annotations

from repro_torch.configs import cca_paper, gnn_archs, lm_archs, recsys_archs
from repro_torch.configs.base import ArchBundle


def all_bundles() -> dict[str, ArchBundle]:
    out = {}
    for mod in (lm_archs, gnn_archs, recsys_archs, cca_paper):
        for b in mod.bundles():
            out[b.arch_id] = b
    return out


ARCHS = all_bundles()
ASSIGNED = [a for a in ARCHS if ARCHS[a].family != "cca"]


def get(arch_id: str) -> ArchBundle:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch '{arch_id}'; have: {sorted(ARCHS)}")
    return ARCHS[arch_id]


def get_shape(arch_id: str, shape_name: str):
    b = get(arch_id)
    for s in b.shapes:
        if s.name == shape_name:
            return b, s
    raise KeyError(f"{arch_id} has no shape '{shape_name}'; "
                   f"have {[s.name for s in b.shapes]}")


def cells():
    """All (arch, shape) cells."""
    return [(a, s.name) for a in ARCHS for s in ARCHS[a].shapes]
