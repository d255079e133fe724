"""The cycle kernel's route, on the CPU: which configs take the cluster
kernel (``kernels/cca_cycle/ops.py::cluster_geometry``), how many bytes of
shared memory a CTA of it takes, and how ``cca_cycle_chunk`` checks
``path=`` and ``n_ctas=``.  No card needed: a CPU call runs the plain
version and launches nothing.  ``tests/test_torch_kernel.py`` runs both
kernels on the card."""
import dataclasses
import json
import pathlib
import re

import pytest
import torch

from repro_torch.core import EngineConfig, StreamingEngine
from repro_torch.core.apps import BFS
from repro_torch.core.ingest import load_stream
from repro_torch.core.state import init_state
from repro_torch.graph.streams import StreamSpec, make_stream
from repro_torch.kernels.cca_cycle import ops
from repro_torch.kernels.cca_cycle.ref import cca_cycle_chunk_ref

DATA = pathlib.Path(__file__).resolve().parent / "data"
PKG = pathlib.Path(ops.__file__).resolve().parent
# the per-cell leaves the cluster kernel keeps in shared memory
SMEM_LEAVES = {"aq", "aq_n", "aq_head", "ch", "ch_n", "ch_head", "ch_rr",
               "pk_n", "cmsg", "cvalid", "cphase", "cT", "cemit", "cout",
               "cdrain", "arot", "nfree"}
SMEM_LIMIT = 232_448


def paper_cfg(n_vertices, n_edges):
    """``benchmarks/paper_experiments.py::_engine``'s config formula."""
    ghosts = max(64, 2 * n_edges // (8 * 1024), 3 * n_vertices // 1024)
    return EngineConfig(height=32, width=32, n_vertices=n_vertices,
                        edge_cap=8, ghost_slots=ghosts, queue_cap=64,
                        chan_cap=16, futq_cap=16, io_stream_cap=2 ** 21,
                        chunk=512)


def json_cfg(path):
    fields = EngineConfig.__dataclass_fields__
    return EngineConfig(**{k: v for k, v in json.loads(path.read_text())[
        "cfg"].items() if k in fields})


LIVELOCK = EngineConfig(height=8, width=8, n_vertices=64, edge_cap=2,
                        ghost_slots=48, queue_cap=8, chan_cap=2, futq_cap=2,
                        io_stream_cap=2048, chunk=64)
FITS = {
    "paper": paper_cfg(50_000, 1_000_000),
    "ci": paper_cfg(2000, 20_000),
    "fingerprint_32x32": json_cfg(PKG.parents[1] / "data"
                                  / "fingerprint_32x32.json"),
    "pinned_8x8": json_cfg(DATA / "pre_lanes_reference.json"),
    "livelock": LIVELOCK,
}
TOO_BIG = EngineConfig(height=64, width=64, n_vertices=4096, queue_cap=64,
                       chan_cap=16)
# 17 rows: no divisor but 1 and 17, and all 17 rows are too many
PRIME_H = EngineConfig(height=17, width=8, n_vertices=500, queue_cap=64,
                       chan_cap=16)


def smem_bytes(cfg, n_ctas):
    """A CTA's bytes counted from the state itself: its band's share of
    each per-cell leaf of ``init_state``, the scratch (qwork, and an
    outbox message and a grant for each of 4 directions), the IO cursors
    and 5 words (a flag, 4 counters) for each of up to 16 CTAs."""
    st = init_state(cfg, device="meta")
    leaves = sum(getattr(st, k).numel() * getattr(st, k).element_size()
                 for k in SMEM_LEAVES) // n_ctas
    cells = cfg.n_cells // n_ctas
    scratch = cells * 4 * (1 + 4 * cfg.msg_words + 4)
    return leaves + scratch + 2 * 4 * cfg.io_cells + 4 * 5 * 16


def test_paper_config_takes_16_ctas_of_2_rows():
    cfg = FITS["paper"]
    n, rows, nbytes = ops.cluster_geometry(cfg)
    assert (n, rows) == (16, 2)
    assert nbytes == smem_bytes(cfg, 16) <= SMEM_LIMIT
    assert ops.cluster_cell_bytes(cfg) == 2785
    # 8 CTAs of 4 rows would need twice the cells' bytes
    assert ops.cluster_geometry(cfg, 8) is None
    assert smem_bytes(cfg, 8) > SMEM_LIMIT


@pytest.mark.parametrize("name", sorted(FITS))
def test_configs_that_fit(name):
    cfg = FITS[name]
    n, rows, nbytes = ops.cluster_geometry(cfg)
    assert n * rows == cfg.height and 1 <= n <= 16
    assert nbytes == smem_bytes(cfg, n) <= SMEM_LIMIT
    assert ops.route(cfg) == (n, rows, nbytes)
    assert ops.route(cfg, "cluster") == (n, rows, nbytes)
    assert ops.route(cfg, "block") is None
    # the rule: the most CTAs that fit
    assert all(ops.cluster_geometry(cfg, m) is None
               for m in range(n + 1, 17))


def test_every_per_cell_leaf_is_held_or_slot_indexed():
    """Each [H, W, ...] leaf is in shared memory, indexed by slot (stays in
    device memory, touched only by its own cell), or the park buffer that
    lanes = 1 never touches."""
    cfg = FITS["paper"]
    assert set(ops.CLUSTER_LEAVES) == SMEM_LEAVES
    for k, v in init_state(cfg, device="meta")._asdict().items():
        if tuple(v.shape[:2]) != (cfg.height, cfg.width):
            continue
        assert (k in SMEM_LEAVES or v.shape[2:3] == (cfg.slots,)
                or k in ("pk", "pk_head")), k


@pytest.mark.parametrize("cfg", [TOO_BIG, PRIME_H], ids=["64x64", "17x8"])
def test_grids_whose_band_cannot_fit_take_the_block_kernel(cfg):
    assert ops.cluster_geometry(cfg) is None
    assert ops.route(cfg) is None
    with pytest.raises(ValueError, match="no cluster band fits"):
        ops.route(cfg, "cluster")


def test_explicit_cluster_sizes():
    cfg = EngineConfig(height=24, width=16, n_vertices=1000, queue_cap=64,
                       chan_cap=16)
    assert ops.cluster_geometry(cfg)[:2] == (12, 2)
    assert ops.cluster_geometry(cfg, 8)[:2] == (8, 3)
    assert ops.cluster_geometry(cfg, 6)[:2] == (6, 4)
    for n in (0, 3, 5, 7, 17, 24):   # 3: 8 rows of 16 cells do not fit
        assert ops.cluster_geometry(cfg, n) is None
    assert ops.route(cfg, n_ctas=8)[:2] == (8, 3)
    with pytest.raises(ValueError, match="in 5 CTAs"):
        ops.route(cfg, n_ctas=5)
    with pytest.raises(ValueError, match="path='block' has none"):
        ops.route(cfg, "block", n_ctas=8)


def _chunk_input(cfg):
    eng = StreamingEngine(cfg, "bfs", device="cpu")
    eng.seed(0, 0.0)
    e = make_stream(StreamSpec(n_vertices=cfg.n_vertices, n_edges=200,
                               increments=1, seed=3))[0]
    st, _ = load_stream(cfg, eng.state, e)
    return st


def test_chunk_checks_path_on_the_cpu_and_launches_nothing():
    cfg = FITS["pinned_8x8"]
    st = _chunk_input(cfg)
    before, by_path = ops.launches, dict(ops.path_launches)
    want_st, want = cca_cycle_chunk_ref(cfg, BFS, st, 16)
    for kw in (dict(), dict(path="auto"), dict(path="cluster"),
               dict(path="block"), dict(n_ctas=2)):
        got_st, got = ops.cca_cycle_chunk(cfg, BFS, st, 16, **kw)
        assert torch.equal(got, want), kw
        assert torch.equal(got_st.aq, want_st.aq), kw
    with pytest.raises(ValueError, match="path must be"):
        ops.cca_cycle_chunk(cfg, BFS, st, 16, path="grid")
    with pytest.raises(ValueError, match="no cluster band fits"):
        ops.cca_cycle_chunk(cfg, BFS, st, 16, n_ctas=3)
    big = TOO_BIG
    with pytest.raises(ValueError, match="no cluster band fits"):
        ops.cca_cycle_chunk(big, BFS, init_state(big, device="cpu"),
                            path="cluster")
    assert ops.launches == before and ops.path_launches == by_path


def _c_struct_fields(name):
    text = (PKG / "csrc" / "cca_cycle.cu").read_text()
    body = re.search(r"struct %s \{(.*?)\};" % name, text, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    return re.findall(r"\*?\s*(\w+)\s*[;,]", body)


def test_c_structs_match_the_wrapper():
    """`struct Dims`, `struct QDims` then `struct TDims` have one int for
    each entry of ``_dims`` (n_ctas and the bytes a CTA last of Dims; Q,
    the record's words and the packed slot app codes in QDims; the tile
    flag, the grid's height and width, the tile's origin and owned window
    in TDims, zeros but for a tile step); `struct Leaves` one pointer for
    each tensor the wrapper hands over, for both kernels, then the QDims
    it carries, and the grid's quiescence flag follows them in the pointer
    array."""
    from repro_torch.core.state import Tile
    from repro_torch.mq import batch_app
    cfg = FITS["ci"]
    n_dims = len(_c_struct_fields("Dims"))
    n_q = len(_c_struct_fields("QDims"))
    for geometry in (None, ops.cluster_geometry(cfg)):
        dims = ops._dims(cfg, BFS, 9, 512, geometry)
        assert len(dims) == n_dims + n_q + len(_c_struct_fields("TDims"))
    assert _c_struct_fields("Dims")[-2:] == ["n_ctas", "smem_bytes"]
    assert _c_struct_fields("QDims") == ["qb", "msgw", "qapp0", "qapp1",
                                         "qapp2", "qapp3"]
    assert _c_struct_fields("TDims") == ["tile", "GH", "GW", "r0", "c0",
                                         "or0", "or1", "oc0", "oc1"]
    assert ops._dims(cfg, BFS, 9, 512, None)[n_dims - 2:] == \
        [0, 0, 1, 5, 0, 0, 0, 0] + [0] * 9
    tile = Tile(-2, 0, 2, 10, 0, 32)
    tdims = ops._dims(cfg, BFS, 9, 1, None, tile, (12, 32), 7)
    assert tdims[:2] == [12, 32] and tdims[10] == 7
    assert tdims[n_dims + n_q:] == [1, cfg.height, cfg.width, -2, 0, 2, 10,
                                    0, 32]
    assert ops._dims(cfg, BFS, 9, 512, (16, 2, 178816))[n_dims - 2:n_dims] \
        == [16, 178816]
    # nine slots: bfs 0, widest 4, cc 2, reliable 5, ..., the ninth in qapp1
    app = batch_app(["bfs", "widest", "cc", "reliable", "sssp", "bfs",
                     "bfs", "widest", "reliable"])
    q9 = dataclasses.replace(cfg, qbatch=9, n_vals=9)
    assert ops._dims(q9, app, 9, 512, None)[n_dims:n_dims + n_q] == [
        9, 13, 0 | 4 << 4 | 2 << 8 | 5 << 12 | 1 << 16 | 4 << 28, 5, 0, 0]
    leaves = _c_struct_fields("Leaves")
    assert leaves[:len(ops.KERNEL_LEAVES)] == list(ops.KERNEL_LEAVES)
    assert leaves[len(ops.KERNEL_LEAVES):] == ["offs", "blackouts", "outbox",
                                               "grant", "qwork", "rec",
                                               "trace", "qchg", "qlast", "q"]
    tensors, _ = ops._launch_args(cfg, BFS, _chunk_input(cfg), 8)
    # every pointer of Leaves (its fields but q), then the flag's
    assert len(tensors) == len(leaves[:-1]) + 1 and tensors[-1] is None
