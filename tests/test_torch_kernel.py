"""The hand-written CUDA cycle kernel on the card.

A CUDA kernel has no CPU mode, so these tests carry the ``gpu`` marker
and skip (from a fixture) where there is no card; ``chip_smoke.py`` runs
the same comparisons on the card.  Tolerance is exact: every state leaf
and the launch record equal the plain PyTorch version's.
"""
import json
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.core import EngineConfig, StreamingEngine
from repro_torch.core.ingest import load_stream
from repro_torch.graph.streams import StreamSpec, make_stream
from repro_torch.kernels.cca_cycle import ops
from repro_torch.kernels.cca_cycle.ref import cca_cycle_chunk_ref

pytestmark = pytest.mark.gpu
PINNED = json.loads((pathlib.Path(__file__).parent / "data"
                     / "pre_lanes_reference.json").read_text())


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA cycle kernel has no CPU "
                    "mode (chip_smoke.py runs these comparisons there)")
    return torch.device("cuda")


def clone(st):
    return st._replace(**{k: v.clone() for k, v in st._asdict().items()})


def assert_same(a, b, ctx):
    for k in a._fields:
        x, y = getattr(a, k), getattr(b, k)
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y), f"{ctx}: leaf {k!r}"


def test_kernel_matches_plain_chunk_by_chunk(card):
    eng = StreamingEngine(EngineConfig(**PINNED["cfg"]), "bfs", device=card)
    eng.seed(0, 0.0)
    cfg, st = eng.cfg, eng.state
    before = ops.launches
    for i, e in enumerate(make_stream(StreamSpec(**PINNED["spec"]))):
        st, _ = load_stream(cfg, st, e)
        for c in range(50):
            sk, ck = ops.cca_cycle_chunk(cfg, eng.app, clone(st), 16)
            st, cr = cca_cycle_chunk_ref(cfg, eng.app, st, 16)
            assert torch.equal(ck, cr), (i, c)
            assert_same(sk, st, f"increment {i}, chunk {c}")
            if int(cr[0]):
                break
    assert ops.launches > before


def test_engine_replays_pinned_fingerprint(card):
    eng = StreamingEngine(EngineConfig(**PINNED["cfg"]), "bfs", device=card)
    eng.seed(0, 0.0)
    rows = []
    for e in make_stream(StreamSpec(**PINNED["spec"])):
        r = eng.run_increment(e, max_cycles=500_000)
        rows.append(dict(cycles=r.cycles, hops=r.hops, execs=r.execs,
                         stalls=r.stalls, allocs=r.allocs))
    assert rows == PINNED["backends"]["jnp"]["increments"]
    np.testing.assert_array_equal(
        eng.values(), np.float32(PINNED["backends"]["jnp"]["values"]))


def test_wrapper_rejects_malformed_state(card):
    eng = StreamingEngine(EngineConfig(**PINNED["cfg"]), "bfs", device=card)
    bad = eng.state._replace(aq_n=eng.state.aq_n.long())
    with pytest.raises(ValueError, match="aq_n"):
        ops.cca_cycle_chunk(eng.cfg, eng.app, bad)
    bad = eng.state._replace(edst=eng.state.edst.transpose(0, 1))
    with pytest.raises(ValueError, match="edst"):
        ops.cca_cycle_chunk(eng.cfg, eng.app, bad)
    bad = eng.state._replace(cvalid=eng.state.cvalid.cpu())
    with pytest.raises(ValueError, match="cvalid"):
        ops.cca_cycle_chunk(eng.cfg, eng.app, bad)
