"""The cycle kernels' tile instances with telemetry, faults and query
batches, and traced tile launches, on the card against the plain tile
step.

A CUDA kernel has no CPU mode, so these tests carry the ``gpu`` marker and
skip (from a fixture) where there is no card; ``chip_smoke.py`` runs the
same comparisons there (phase 52).  Each knob mix of the unsharded kernels
(``kTm``, ``kFlt``, ``kTm + kFlt``, ``kQ``, ``kQ + kTm``) in its tile
instance, on the cluster kernel and the one-block kernel, over a (2, 2)
mesh of ``LocalTiles``: the ci parity config (8x8) to quiescence and the
32x32 fingerprint config for two chunks of its first increment, chunk by
chunk every leaf of the gathered state, the launch record and the trace
rows equal to the plain tile step's on the CPU, and every tile step one
launch of the knob's instance.
"""
import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.core import StreamingEngine
from repro_torch.core.config import EngineConfig
from repro_torch.core.ingest import load_stream
from repro_torch.dist import cca
from repro_torch.graph.streams import StreamSpec, make_stream
from repro_torch.kernels.cca_cycle import ops
from repro_torch.launch.dist_bench import scale_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.mq import batch_app
from repro_torch.resilience.faults import FaultPlan

pytestmark = pytest.mark.gpu
DATA = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch" \
    / "data"
# drops, dups and corruptions often enough to cross the tile boundaries of
# a (2, 2) mesh, and the S link of cell (3, 3) (row 3 -> 4: a boundary on
# the 8x8 grid) dead for 40 cycles
PLAN = FaultPlan(seed=3, drop_rate=0.05, dup_rate=0.05, corrupt_rate=0.05,
                 blackouts=((3, 3, 1, 0, 40),))
KNOBS = {"tl+tm": (dict(telemetry=True), "bfs"),
         "tl+flt": (dict(faults=PLAN), "bfs"),
         "tl+tm+flt": (dict(telemetry=True, faults=PLAN), "bfs"),
         "tl+q": ({}, ("bfs", "sssp", "cc")),
         "tl+q+tm": (dict(telemetry=True), ("bfs", "sssp", "cc")),
         "tl": ({}, "bfs")}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU "
                    "mode (chip_smoke.py runs these comparisons there)")
    return torch.device("cuda")


def config(name: str):
    """``(cfg, edges, chunks, cycles a chunk)`` of a stream: the ci parity
    config to quiescence, or two 16-cycle chunks of the 32x32 fingerprint
    config's first increment."""
    if name == "ci":
        cfg, edges = scale_config("ci")
        return cfg, edges, 8, None
    fp = json.loads((DATA / "fingerprint_32x32.json").read_text())
    fields = EngineConfig.__dataclass_fields__
    cfg = EngineConfig(**{k: v for k, v in fp["cfg"].items()
                          if k in fields})
    return cfg, make_stream(StreamSpec(**fp["spec"]))[0], 2, 16


def loaded(base, kw, app, edges, dev):
    eng = StreamingEngine(dataclasses.replace(base, **kw),
                          app if isinstance(app, str) else batch_app(app),
                          device=dev)
    eng.seed(0, 0.0)
    st, spill = load_stream(eng.cfg, eng.state, edges)
    assert len(spill) == 0
    return eng.cfg, eng.app, st


@pytest.mark.parametrize("knob", list(KNOBS))
@pytest.mark.parametrize("which", ["ci", "32x32"])
def test_tile_instance_equals_plain(card, which, knob):
    base, edges, max_chunks, n = config(which)
    kw, app = KNOBS[knob]
    cfg, app, st = loaded(base, kw, app, edges, card)
    _, _, plain = loaded(base, kw, KNOBS[knob][1], edges, "cpu")
    ssts = {p: cca.shard_state(cfg, st if p == "block" else
                               st._replace(**{k: v.clone() for k, v in
                                              st._asdict().items()}),
                               make_host_mesh(2, 2, device=card))
            for p in ops.PATHS}
    p_sst = cca.shard_state(cfg, plain, make_host_mesh(2, 2, device="cpu"))
    n = cfg.chunk if n is None else n
    tr = {p: torch.zeros((n, 2), dtype=torch.int32, device=card)
          for p in ops.PATHS}
    p_tr = torch.zeros((n, 2), dtype=torch.int32)
    before = dict(ops.tile_launches)
    for chunk in range(max_chunks):
        p_sst, pr = cca.run_chunk(cfg, app, p_sst, n, trace=p_tr)
        want = cca.gather_state(p_sst)
        ran = int(pr[1])
        for path in ops.PATHS:
            ssts[path], kr = cca.run_chunk(cfg, app, ssts[path], n,
                                           path=path, trace=tr[path])
            got = cca.gather_state(ssts[path])
            where = f"{which} {knob} {path} chunk {chunk}"
            for name in got._fields:
                assert torch.equal(getattr(got, name).cpu(),
                                   getattr(want, name)), \
                    f"{where}: leaf {name!r}"
            assert kr.tolist() == pr.tolist(), where
            assert torch.equal(tr[path][:ran].cpu(), p_tr[:ran]), \
                f"{where}: trace rows"
        if pr[0]:
            break
    steps = 4 * (chunk + 1) * n
    assert ops.instance(cfg) == knob
    for path in ops.PATHS:
        key = f"{path} {knob}"
        assert ops.tile_launches.get(key, 0) \
            - before.get(key, 0) == steps, key
    if which == "ci" and knob in ("tl+flt", "tl+tm+flt"):
        assert (want.flt.numpy() > 0).all(), "a hazard never fired"


def test_launch_entry_refuses_what_a_tile_launch_cannot_run(card):
    """``ERR_TILE``: the C entry refuses a tile launch of more than one
    cycle or without the grid's quiescence flag, whatever its knobs;
    ``ERR_LIBRARY``: each of the two libraries refuses the other's mode."""
    import ctypes

    from repro_torch.core.apps import BFS
    from repro_torch.core.state import Tile, init_state
    cfg = EngineConfig(height=8, width=8, n_vertices=64, chunk=8,
                       telemetry=True)
    st = init_state(cfg, device=card)
    q = torch.zeros((), dtype=torch.int32, device=card)
    rec = torch.zeros(8, dtype=torch.int32, device=card)
    tile = tuple(Tile(0, 0, 0, 8, 0, 8))

    def launch(tiles, n_cycles, tile, flag):
        lib = ops._library(tiles)
        tensors, dims = ops._launch_args(cfg, BFS, st, n_cycles, None, None,
                                         tile, flag, rec)
        ptrs = (ctypes.c_void_p * len(tensors))(
            *[0 if t is None else t.data_ptr() for t in tensors])
        dims_c = (ctypes.c_int * len(dims))(*dims)
        kernel = ctypes.c_int(-1)
        err = lib.cca_cycle_launch(ptrs, len(tensors), dims_c, len(dims),
                                   torch.cuda.current_stream().cuda_stream,
                                   ctypes.byref(kernel))
        assert kernel.value == -1
        return err, lib.cca_cycle_error_string(err)

    for n_cycles, flag in ((2, q), (1, None)):
        err, text = launch(True, n_cycles, tile, flag)
        assert err == -4 and b"one cycle" in text
    for tiles, t in ((False, tile), (True, None)):
        err, text = launch(tiles, 1, t, q)
        assert err == -5 and b"other mode" in text
    torch.cuda.synchronize()
    np.testing.assert_array_equal(rec.cpu().numpy(), 0)
