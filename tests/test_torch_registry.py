"""The port's config registry (``repro_torch.configs.registry`` and the ten
``configs/<arch>.py`` aliases) against the JAX package's: the same arch
ids in the same order, families, configs field by field (dtypes mapped
to torch's; the engine config has no ``backend`` field in the port, as
``tests/test_torch_engine.py`` says), shape sets, smoke configs, and
cells: 43 in all, the 40 of the ten assigned architectures (4 shapes
each) and the engine's 3.
"""
import dataclasses
import importlib

import jax.numpy as jnp
import pytest
import torch

from repro.configs import registry as jreg
from repro_torch.configs import registry

ALIASES = ["phi35_moe_42b", "arctic_480b", "starcoder2_3b", "qwen3_1p7b",
           "llama3_2_1b", "gatedgcn", "gcn_cora", "graphcast",
           "meshgraphnet", "dlrm_rm2"]
DT = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def fields(cfg) -> dict:
    out = {k: DT.get(v, v) if not isinstance(v, (list, dict)) else v
           for k, v in dataclasses.asdict(cfg).items()}
    out.pop("backend", None)
    return out


def shapes(b):
    return [(s.name, s.kind, s.dims) for s in b.shapes]


def test_arch_ids_families_and_cells():
    assert list(registry.ARCHS) == list(jreg.ARCHS)
    assert registry.ASSIGNED == jreg.ASSIGNED and len(registry.ASSIGNED) == 10
    assert registry.cells() == jreg.cells() and len(registry.cells()) == 43
    assigned = [c for c in registry.cells() if c[0] in registry.ASSIGNED]
    assert len(assigned) == 40
    for a, b in registry.ARCHS.items():
        jb = jreg.ARCHS[a]
        assert (b.arch_id, b.family, b.notes != "") == (
            jb.arch_id, jb.family, jb.notes != "")
        assert shapes(b) == shapes(jb)


@pytest.mark.parametrize("arch", list(jreg.ARCHS))
def test_configs_field_by_field(arch):
    b, jb = registry.get(arch), jreg.get(arch)
    assert type(b.config).__name__ == type(jb.config).__name__
    assert fields(b.config) == fields(jb.config)
    assert fields(b.smoke()) == fields(jb.smoke())
    for s in jb.shapes:
        got, spec = registry.get_shape(arch, s.name)
        assert got is b and (spec.name, spec.kind, spec.dims) == (
            s.name, s.kind, s.dims)


def test_lookups_refuse_unknown_names():
    with pytest.raises(KeyError, match="unknown arch 'nope'"):
        registry.get("nope")
    with pytest.raises(KeyError, match="has no shape 'nope'"):
        registry.get_shape("gcn-cora", "nope")


@pytest.mark.parametrize("name", ALIASES)
def test_arch_modules_alias_the_registry(name):
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    jmod = importlib.import_module(f"repro.configs.{name}")
    assert mod.BUNDLE is registry.get(jmod.BUNDLE.arch_id)
    assert mod.CONFIG is mod.BUNDLE.config
    assert fields(mod.CONFIG) == fields(jmod.CONFIG)
    assert sorted(mod.SHAPES) == sorted(jmod.SHAPES)
    assert fields(mod.smoke()) == fields(jmod.smoke())
