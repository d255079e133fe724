"""Stage parity: one call of each cycle stage of the PyTorch port equals
the JAX package's on the same mid-run state.

The states are JAX engine states taken mid-increment on the pinned
stream (``tests/data/pre_lanes_reference.json``); each is fed through
hop -> staging -> phase0 -> io, every stage getting the JAX output of
the stage before it, in both packages.  Tolerance is exact: integer and
bool leaves equal, float32 leaves equal as bits, and the stages' side
outputs (hop count, activity masks) equal.
"""
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import EngineConfig as JConfig
from repro.core import StreamingEngine as JEngine
from repro.core.apps import BFS as J_BFS
from repro.core.exec_stage import phase0_stage as j_phase0
from repro.core.exec_stage import staging_stage as j_staging
from repro.core.ingest import io_stage as j_io
from repro.core.ingest import load_stream as j_load
from repro.core.routing import hop_stage as j_hop
from repro.core.state import MachineState as JState
from repro.graph.streams import StreamSpec, make_stream
from repro_torch.core.apps import BFS
from repro_torch.core.config import EngineConfig
from repro_torch.core.engine import _rc
from repro_torch.core.exec_stage import phase0_stage, staging_stage
from repro_torch.core.ingest import io_stage
from repro_torch.core.routing import hop_stage
from repro_torch.core.state import state_from_numpy, state_to_numpy

PINNED = json.loads((pathlib.Path(__file__).parent / "data"
                     / "pre_lanes_reference.json").read_text())
SNAP_CYCLES = (6, 20, 35)      # increment 0 quiesces at cycle 48


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain version runs thousands of tiny ops per cycle: one
    intra-op thread is faster, and leaves the cores to the other test
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def as_numpy(st) -> dict:
    return {k: np.asarray(v) for k, v in st._asdict().items()}


def _jstate(arrays: dict) -> JState:
    return JState(**{k: jnp.asarray(v) for k, v in arrays.items()})


def assert_same(a: dict, b: dict, ctx: str):
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, (ctx, k)
        if x.dtype == np.float32:
            x, y = x.view(np.int32), y.view(np.int32)
        np.testing.assert_array_equal(x, y, err_msg=f"{ctx}: leaf {k!r}")


@pytest.fixture(scope="module")
def jax_stages():
    """The four JAX stages, jitted once, plus mid-run snapshots of the
    pinned stream taken by stepping the JAX state with them."""
    cfg = JEngine(JConfig(**PINNED["cfg"]), "bfs").cfg
    rows = jnp.broadcast_to(jnp.arange(cfg.height, dtype=jnp.int32)[:, None],
                            (cfg.height, cfg.width))
    cols = jnp.broadcast_to(jnp.arange(cfg.width, dtype=jnp.int32)[None, :],
                            (cfg.height, cfg.width))
    stages = dict(
        hop=jax.jit(lambda s: j_hop(cfg, s, rows, cols)),
        staging=jax.jit(lambda s: j_staging(cfg, J_BFS, s, rows, cols)),
        phase0=jax.jit(lambda s, b: j_phase0(cfg, J_BFS, s, rows, cols, b)),
        io=jax.jit(lambda s: j_io(cfg, s, rows, cols)))
    eng = JEngine(JConfig(**PINNED["cfg"]), "bfs")
    eng.seed(0, 0.0)
    st, _ = j_load(cfg, eng.state, make_stream(StreamSpec(
        **PINNED["spec"]))[0])
    snaps = []
    for c in range(max(SNAP_CYCLES) + 1):
        if c in SNAP_CYCLES:
            snaps.append(as_numpy(st))
        busy0 = st.cvalid
        st, hops = stages["hop"](st)
        st, _ = stages["staging"](st)
        st, _ = stages["phase0"](st, busy0)
        st = stages["io"](st)
        st = st._replace(cycle=st.cycle + 1, stat_hops=st.stat_hops + hops)
    return stages, snaps


@pytest.mark.parametrize("snap", range(len(SNAP_CYCLES)))
def test_stages_match_jax(jax_stages, snap):
    stages, snaps = jax_stages
    cfg = EngineConfig(**PINNED["cfg"])
    rows, cols = _rc(cfg, "cpu")
    x = snaps[snap]
    busy0 = x["cvalid"]
    ctx = f"cycle {SNAP_CYCLES[snap]}"

    def port(arrays):
        return state_from_numpy(cfg, arrays, device="cpu")

    jst, jh = stages["hop"](_jstate(x))
    tst, th = hop_stage(cfg, port(x), rows, cols)
    assert int(th) == int(jh) and int(jh) > 0
    assert_same(state_to_numpy(tst), as_numpy(jst), f"hop, {ctx}")

    x = as_numpy(jst)
    jst, ja = stages["staging"](_jstate(x))
    tst, ta = staging_stage(cfg, BFS, port(x), rows, cols)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    assert_same(state_to_numpy(tst), as_numpy(jst), f"staging, {ctx}")

    x = as_numpy(jst)
    jst, jp = stages["phase0"](_jstate(x), jnp.asarray(busy0))
    tst, tp = phase0_stage(cfg, BFS, port(x), rows, cols,
                           torch.from_numpy(busy0.copy()))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    assert_same(state_to_numpy(tst), as_numpy(jst), f"phase0, {ctx}")

    x = as_numpy(jst)
    jst = stages["io"](_jstate(x))
    tst = io_stage(cfg, port(x), rows, cols)
    assert_same(state_to_numpy(tst), as_numpy(jst), f"io, {ctx}")
