"""The hand-written CUDA kernels on the card, against their plain
PyTorch versions.

A CUDA kernel has no CPU mode, so these tests carry the ``gpu`` marker
and skip (from a fixture) where there is no card; ``chip_smoke.py`` runs
the same comparisons on the card at the main path's shapes.  Tolerances:
the cycle kernels are exact (every state leaf and the launch record equal
the plain version's, on the cluster kernel and on the one-block kernel);
the scatter-SpMM 1e-4 and the EmbeddingBag 1e-5,
relative to max(1, max |ref|), as their f32 sums run in another order
(the scatter-SpMM also equal, bit for bit, to ``ref.spmm_ordered``, the
order of the warp shape ``ops.geometry`` picks: narrow shapes at D = 1-20,
one row of 10,000 edges);
the flash-attention kernels entry by entry (``flash_close``), 2e-5 x
(|ref| + 1) in f32 (the 3xTF32 tensor-core kernel: split operands, and
sums and exponentials in another order), as ``tests/test_kernels.py``
holds the Pallas kernel, and
2e-2 x (|ref| + median |ref|) in bf16 (the tensor-core kernel: one
rounding of the output, held to the typical output rather than the
largest).  The flash shapes cover the tensor-core kernel's 128-row tiles
(T = 127, 129, 1000), Tq != Tk either way, B = 2 with one KV head and
G = 4; ``test_flash_wrapper_records_the_path`` checks which kernel each
dtype takes.
"""
import ctypes
import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.configs import gnn_archs, lm_archs, recsys_archs
from repro_torch.configs.base import shape
from repro_torch.core import EngineConfig, StreamingEngine
from repro_torch.core.apps import BFS
from repro_torch.core.engine import LivelockError
from repro_torch.core.state import init_state
from repro_torch.core.ingest import load_stream
from repro_torch.data.graphs import build_graph
from repro_torch.data.pipeline import RecSysBatchSpec, recsys_batch
from repro_torch.graph.streams import StreamSpec, make_stream
from repro_torch.kernels.cca_cycle import ops
from repro_torch.kernels.cca_cycle.ref import cca_cycle_chunk_ref
from repro_torch.kernels.embedding_bag import ops as bag_ops
from repro_torch.kernels.embedding_bag.ref import embedding_bags_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.spmm import ops as spmm_ops
from repro_torch.kernels.spmm.ref import (scatter_spmm_ref, spmm_ordered,
                                          spmm_sorted_coo_ref)
from repro_torch.models import dlrm, gnn, transformer

pytestmark = pytest.mark.gpu
PINNED = json.loads((pathlib.Path(__file__).parent / "data"
                     / "pre_lanes_reference.json").read_text())


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU "
                    "mode (chip_smoke.py runs these comparisons there)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def close(got, want, tol):
    got, want = got.cpu(), want.cpu()
    assert got.shape == want.shape
    scale = max(1.0, float(want.nan_to_num().abs().max()))
    torch.testing.assert_close(got, want, rtol=tol, atol=tol * scale,
                               equal_nan=True)


def flash_close(got, want, dtype):
    """|got - want| <= tol x (|want| + a) entry by entry: a = 1 in f32,
    median |want| in bf16, where the largest |want| (the first rows) is
    many times the typical one."""
    got, want = got.cpu().double(), want.cpu().double()
    assert got.shape == want.shape
    a = float(want.abs().median()) if dtype == torch.bfloat16 else 1.0
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got, want, rtol=tol, atol=tol * a)


def clone(st):
    return st._replace(**{k: v.clone() for k, v in st._asdict().items()})


def assert_same(a, b, ctx):
    for k in a._fields:
        x, y = getattr(a, k), getattr(b, k)
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y), f"{ctx}: leaf {k!r}"


@pytest.mark.parametrize("path", ["block", "cluster"])
def test_kernel_matches_plain_chunk_by_chunk(card, path):
    eng = StreamingEngine(EngineConfig(**PINNED["cfg"]), "bfs", device=card)
    eng.seed(0, 0.0)
    cfg, st = eng.cfg, eng.state
    before, by_path = ops.launches, dict(ops.path_launches)
    for i, e in enumerate(make_stream(StreamSpec(**PINNED["spec"]))):
        st, _ = load_stream(cfg, st, e)
        for c in range(50):
            sk, ck = ops.cca_cycle_chunk(cfg, eng.app, clone(st), 16,
                                         path=path)
            st, cr = cca_cycle_chunk_ref(cfg, eng.app, st, 16)
            assert torch.equal(ck, cr), (i, c)
            assert_same(sk, st, f"increment {i}, chunk {c}")
            if int(cr[0]):
                break
    n = ops.launches - before
    assert n > 0
    assert ops.path_launches == {p: k + n * (p == path)
                                 for p, k in by_path.items()}


def _hub(n, degree, seed):
    from repro_torch.graph.streams import hub_edges
    e = hub_edges(n, 0, degree, seed=seed)
    one = np.float32(1.0).view(np.int32)
    return np.concatenate([e, np.full((len(e), 1), one, np.int64)],
                          1).astype(np.int32)


def _weighted(seed=1, n=64, m=320):
    rng = np.random.default_rng(seed)
    w = (1.0 - rng.random(m)).astype(np.float32)
    e = np.stack([rng.integers(0, n, m), rng.integers(0, n, m),
                  w.view(np.int32)], 1).astype(np.int32)
    return [e[: m // 2], e[m // 2:]]


BRANCH_CASES = {
    # tests/test_lanes.py::_hub_cfg at lanes=4 (the arbiter, parking)
    "lanes4": (dict(height=8, width=8, n_vertices=128, edge_cap=4,
                    ghost_slots=48, queue_cap=20, chan_cap=16, futq_cap=4,
                    io_stream_cap=2048, chunk=64, lanes=4), "bfs", 0.0,
               lambda: [_hub(128, 200, 3)]),
    # tests/test_rhizome.py::cfg_for at rhizome_cap=4
    "rhizome4": (dict(height=8, width=8, n_vertices=64, edge_cap=4,
                      ghost_slots=32, queue_cap=96, chan_cap=16, futq_cap=8,
                      io_stream_cap=2048, chunk=128, rhizome_cap=4), "bfs",
                 0.0, lambda: [_hub(64, 40, 3)]),
    "widest": (dict(height=8, width=8, n_vertices=64, edge_cap=4,
                    ghost_slots=32, queue_cap=48, chan_cap=16, futq_cap=4,
                    io_stream_cap=2048, chunk=64, rhizome_cap=2, lanes=2),
               "widest", 1e9, _weighted),
    "reliable": (dict(height=8, width=8, n_vertices=64, edge_cap=4,
                      ghost_slots=32, queue_cap=48, chan_cap=16, futq_cap=4,
                      io_stream_cap=2048, chunk=64, rhizome_cap=2, lanes=2),
                 "reliable", 1.0, _weighted),
}


@pytest.mark.parametrize("path", ["block", "cluster"])
@pytest.mark.parametrize("case", sorted(BRANCH_CASES))
def test_lane_rhizome_and_max_app_branches_match_plain(card, case, path):
    """The lane, park, rhizome and max-app branches, chunk by chunk to
    quiescence on each kernel: every leaf and the record equal."""
    kw, app, seed, incs = BRANCH_CASES[case]
    eng = StreamingEngine(EngineConfig(**kw), app, device=card)
    eng.seed(0, seed)
    cfg, st = eng.cfg, eng.state
    for i, e in enumerate(incs()):
        st, _ = load_stream(cfg, st, e)
        for c in range(1000):
            sk, ck = ops.cca_cycle_chunk(cfg, eng.app, clone(st), path=path)
            st, cr = cca_cycle_chunk_ref(cfg, eng.app, st)
            assert torch.equal(ck, cr), (i, c)
            assert_same(sk, st, f"{case} increment {i} chunk {c}")
            if cr[0]:
                break


def paper_cfg(n_vertices, n_edges):
    """``benchmarks/paper_experiments.py::_engine``'s config formula."""
    ghosts = max(64, 2 * n_edges // (8 * 1024), 3 * n_vertices // 1024)
    return EngineConfig(height=32, width=32, n_vertices=n_vertices,
                        edge_cap=8, ghost_slots=ghosts, queue_cap=64,
                        chan_cap=16, futq_cap=16, io_stream_cap=2 ** 21,
                        chunk=512)


@pytest.fixture(scope="module")
def ci_states():
    """The 2000-vertex stream on the 32x32 paper config: the states with
    increments 2, 5 and 8 loaded (as chip_smoke.py's phase 3b)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    ci = dict(n_vertices=2000, n_edges=20_000)
    cfg = paper_cfg(**ci)
    eng = StreamingEngine(cfg, "bfs", device="cuda")
    eng.seed(0, 0.0)
    out = {}
    for i, e in enumerate(make_stream(StreamSpec(increments=10,
                                                 sampling="edge", seed=1,
                                                 **ci))[:9]):
        if i in (2, 5, 8):
            st, _ = load_stream(cfg, clone(eng.state), e)
            out[i] = st._replace(**{k: torch.zeros_like(getattr(st, k))
                                    for k in ("stat_hops", "stat_exec",
                                              "stat_stall", "stat_allocs")})
        eng.run_increment(e, max_cycles=2_000_000)
    return cfg, out


@pytest.mark.parametrize("at", [2, 5, 8])
def test_cluster_kernel_matches_plain_mid_stream(card, ci_states, at):
    cfg, states = ci_states
    assert ops.cluster_geometry(cfg)[:2] == (16, 2)
    st = states[at]
    before = ops.path_launches["cluster"]
    sk, ck = ops.cca_cycle_chunk(cfg, BFS, clone(st), 512)
    sr, cr = cca_cycle_chunk_ref(cfg, BFS, st, 512)
    assert ops.path_launches["cluster"] == before + 1
    assert torch.equal(ck, cr) and int(cr[1]) > 0
    assert_same(sk, sr, f"increment {at}")


def test_cluster_kernel_gives_the_same_bits_twice(card, ci_states):
    cfg, states = ci_states
    a, ca = ops.cca_cycle_chunk(cfg, BFS, clone(states[5]), 512)
    b, cb = ops.cca_cycle_chunk(cfg, BFS, clone(states[5]), 512)
    assert torch.equal(ca, cb)
    assert_same(a, b, "second launch")


@pytest.mark.parametrize("n_ctas,rows", [(None, 2), (8, 3), (6, 4)])
def test_cluster_kernel_on_a_24x16_grid(card, n_ctas, rows):
    """24 rows: bands of 2 rows in 12 CTAs, 3 in 8, 4 in 6, chunk by
    chunk to quiescence."""
    cfg = EngineConfig(height=24, width=16, n_vertices=1000, edge_cap=4,
                       ghost_slots=32, queue_cap=64, chan_cap=16,
                       futq_cap=8, io_stream_cap=4096, chunk=128)
    assert ops.route(cfg, n_ctas=n_ctas)[1] == rows
    eng = StreamingEngine(cfg, "bfs", device=card)
    eng.seed(0, 0.0)
    st, chunks = eng.state, 0
    for e in make_stream(StreamSpec(n_vertices=1000, n_edges=3000,
                                    increments=2, seed=5)):
        st, _ = load_stream(cfg, st, e)
        for c in range(100):
            sk, ck = ops.cca_cycle_chunk(cfg, BFS, clone(st), 128,
                                         n_ctas=n_ctas)
            st, cr = cca_cycle_chunk_ref(cfg, BFS, st, 128)
            assert torch.equal(ck, cr), c
            assert_same(sk, st, f"chunk {c}")
            chunks += 1
            if int(cr[0]):
                break
    assert chunks > 2


@pytest.mark.parametrize("n_cycles", [0, 1])
def test_cluster_kernel_runs_zero_and_one_cycle(card, n_cycles):
    eng = StreamingEngine(EngineConfig(**PINNED["cfg"]), "bfs", device=card)
    eng.seed(0, 0.0)
    e = make_stream(StreamSpec(**PINNED["spec"]))[0]
    st, _ = load_stream(eng.cfg, eng.state, e)
    sk, ck = ops.cca_cycle_chunk(eng.cfg, BFS, clone(st), n_cycles,
                                 path="cluster")
    sr, cr = cca_cycle_chunk_ref(eng.cfg, BFS, st, n_cycles)
    assert ck.tolist() == cr.tolist() == [0, n_cycles]
    assert_same(sk, sr, f"n_cycles={n_cycles}")


def test_cluster_kernel_on_a_quiescent_state(card):
    cfg = EngineConfig(**PINNED["cfg"])
    st = init_state(cfg, device=card)
    sk, ck = ops.cca_cycle_chunk(cfg, BFS, clone(st), 64, path="cluster")
    assert ck.tolist() == [1, 0]
    assert_same(sk, st, "quiescent on entry")


def test_livelock_on_the_card_as_on_the_cpu(card):
    """``tests/test_torch_engine.py``'s undersized buffers: the engine on
    the cluster kernel raises at the same cycle and chunk as on the CPU,
    holding the same state."""
    kw = dict(height=8, width=8, n_vertices=64, edge_cap=2, ghost_slots=48,
              queue_cap=8, chan_cap=2, futq_cap=2, io_stream_cap=2048,
              chunk=64)
    assert ops.cluster_geometry(EngineConfig(**kw)) is not None
    incs = make_stream(StreamSpec(n_vertices=64, n_edges=400, increments=2,
                                  seed=21))
    got = []
    before = ops.path_launches["cluster"]
    for dev in ("cpu", card):
        eng = StreamingEngine(EngineConfig(**kw), "bfs", device=dev)
        eng.seed(0, 0.0)
        with pytest.raises(LivelockError) as err:
            for e in incs:
                eng.run_increment(e, max_cycles=500_000)
        got.append((err.value.cycle, err.value.chunk, eng.stream_pos,
                    eng.state))
    assert got[0][:3] == got[1][:3]
    assert ops.path_launches["cluster"] > before
    assert_same(got[1][3]._replace(**{k: getattr(got[1][3], k).cpu()
                                      for k in got[1][3]._fields}),
                got[0][3], "livelock state")


def test_wrapper_counts_launches_by_path(card):
    """auto takes the cluster kernel where a band fits and the one-block
    kernel where none does; ``launches`` counts both, ``path_launches``
    each; the C entry's byte count is the wrapper's."""
    fits = EngineConfig(**PINNED["cfg"])
    big = EngineConfig(height=64, width=64, n_vertices=4096, queue_cap=64,
                       chan_cap=16)
    lib = ops._library()
    for cfg, path in ((fits, "cluster"), (big, "block")):
        st = init_state(cfg, device=card)
        total, before = ops.launches, dict(ops.path_launches)
        ops.cca_cycle_chunk(cfg, BFS, st, 4)
        torch.cuda.synchronize()
        assert ops.launches == total + 1
        assert ops.path_launches == {p: n + (p == path)
                                     for p, n in before.items()}
    with pytest.raises(ValueError, match="no cluster band fits"):
        ops.cca_cycle_chunk(big, BFS, init_state(big, device=card),
                            path="cluster")
    for n in (1, 2, 4, 8):
        geo = ops.cluster_geometry(fits, n)
        dims = ops._dims(fits, BFS, 9, 16, geo)
        assert lib.cca_cycle_cluster_smem(
            (ctypes.c_int * len(dims))(*dims), len(dims)) == geo[2]


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


def groups(D):
    return 32 // spmm_ops.geometry(D)[0]


# D = 4, 8, 12, 20: the edge of each narrow shape, rows not a multiple of
# 16 bytes where D % 4 != 0
@pytest.mark.parametrize("D", [1, 4, 7, 8, 12, 16, 20, 33, 70, 512])
@pytest.mark.parametrize("with_coeff", [False, True])
def test_spmm_kernel_matches_plain(card, D, with_coeff):
    rng = np.random.default_rng(D)
    n, e = 300, 5000
    src = torch.from_numpy(rng.integers(-n, 2 * n, e).astype(np.int32))
    dst = torch.from_numpy(np.sort(rng.integers(-20, n + 20, e)).astype(
        np.int32))
    x = torch.from_numpy(rng.standard_normal((n, D)).astype(np.float32))
    coeff = torch.from_numpy(rng.standard_normal(e).astype(np.float32)) \
        if with_coeff else None
    before = spmm_ops.launches
    on = [t if t is None else t.to(card) for t in (x, src, dst, coeff)]
    got = spmm_ops.spmm_sorted_coo(on[0], on[1], on[2], n, on[3])
    close(got, spmm_sorted_coo_ref(x, src, dst, n, coeff), 1e-4)
    assert torch.equal(got, spmm_ordered(*on[:3], n, on[3], groups(D)))
    msgs = torch.from_numpy(rng.standard_normal((e, D)).astype(np.float32))
    got = spmm_ops.scatter_spmm(msgs.to(card), on[2], n)
    close(got, scatter_spmm_ref(msgs, dst, n), 1e-4)
    assert torch.equal(got, spmm_ordered(msgs.to(card), None, on[2], n,
                                         groups=groups(D)))
    assert spmm_ops.launches == before + 2
    # deterministic (no atomics), also over row pointers built beforehand
    rp = spmm_ops.row_pointers(on[2], n)
    assert torch.equal(got, spmm_ops.scatter_spmm(msgs.to(card), on[2], n,
                                                  rp))


@pytest.mark.parametrize("D", [7, 16, 128])
def test_spmm_kernel_high_degree_row(card, D):
    """One row of 10,000 edges among rows of a few: equal bits to the
    ordered sum of its warp shape, within 1e-4 of the plain version."""
    rng = np.random.default_rng(100 + D)
    n = 64
    dst = np.sort(np.concatenate([np.full(10_000, 9),
                                  rng.integers(0, n, 2000)])).astype(np.int32)
    e = dst.shape[0]
    src = rng.integers(0, n, e).astype(np.int32)
    x = rng.standard_normal((n, D)).astype(np.float32)
    coeff = rng.standard_normal(e).astype(np.float32)
    on = [torch.from_numpy(a).to(card) for a in (x, src, dst, coeff)]
    got = spmm_ops.spmm_sorted_coo(*on[:3], n, on[3])
    assert torch.equal(got, spmm_ordered(*on[:3], n, on[3], groups(D)))
    close(got, spmm_sorted_coo_ref(*(t.cpu() for t in on[:3]), n,
                                   on[3].cpu()), 1e-4)


def test_spmm_kernel_refuses_a_shape_it_lacks(card):
    """The C entry takes the wide shape at any D and refuses a narrow one
    that does not cover D or float4 loads where D % 4 != 0."""
    x = torch.randn(8, 7, device=card)
    dst = torch.arange(8, dtype=torch.int32, device=card)
    rp = spmm_ops.row_pointers(dst, 8)
    assert torch.equal(spmm_ops.launch(x, None, None, rp, 8,
                                       shape=spmm_ops.WIDE), x)
    for shape in [(4, 1), (2, 4), (8, 2), (64, 1)]:
        with pytest.raises(RuntimeError, match="spmm kernel launch failed"):
            spmm_ops.launch(x, None, None, rp, 8, shape=shape)


def test_spmm_kernel_clamps_row_pointers(card):
    """Row pointers outside [0, E] (a stale set) give sums over the
    clamped ranges, never a read outside the messages."""
    msgs = torch.arange(12, dtype=torch.float32, device=card).view(6, 2)
    dst = torch.zeros(6, dtype=torch.int32, device=card)
    rp = torch.tensor([-3, 2, 2, 9, 9], dtype=torch.int32, device=card)
    got = spmm_ops.scatter_spmm(msgs, dst, 4, rp)
    want = torch.stack([msgs[:2].sum(0), msgs[:0].sum(0), msgs[2:].sum(0),
                        msgs[:0].sum(0)])
    assert torch.equal(got, want)


def test_spmm_wrapper_rejects_on_the_card(card):
    x = torch.zeros(4, 3, device=card)
    src = torch.tensor([0, 1, 2], dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="sorted"):
        spmm_ops.spmm_sorted_coo(x, src, src.flip(0), 4)
    with pytest.raises(ValueError, match="src"):
        spmm_ops.spmm_sorted_coo(x, src.cpu(), src, 4)


@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("D", [8, 64, 70])
def test_embedding_bag_kernel_matches_plain(card, combiner, weighted, D):
    rng = np.random.default_rng(D)
    vocabs, B, L = (1000, 7, 33), 129, 4
    tables = [torch.from_numpy(rng.standard_normal((v, D)).astype(
        np.float32)) for v in vocabs]
    idx = torch.from_numpy(np.stack([rng.integers(-v - 2, v + 2, (B, L))
                                     for v in vocabs], 1).astype(np.int32))
    w = torch.from_numpy(rng.standard_normal(idx.shape).astype(np.float32)) \
        if weighted else None
    before = bag_ops.launches
    got = bag_ops.embedding_bags([t.to(card) for t in tables], idx.to(card),
                                 None if w is None else w.to(card), combiner)
    want = embedding_bags_ref(tables, idx, w, combiner)
    assert torch.isnan(want).any()   # out-of-range indices give NaN bags
    close(got, want, 1e-5)
    assert bag_ops.launches == before + 1


def test_gnn_and_dlrm_forwards_on_the_card(card):
    spec = shape("t", "gnn_full", n_nodes=300, n_edges=2000, d_feat=8)
    for arch in (gnn_archs.GCN_CORA, gnn_archs.GATEDGCN,
                 gnn_archs.MESHGRAPHNET, gnn_archs.GRAPHCAST):
        cfg = gnn_archs._smoke(arch)
        p = gnn.init_gnn_params(cfg, torch.Generator().manual_seed(0))
        g = build_graph(cfg, spec, np.random.default_rng(0), device="cpu")
        want = gnn.gnn_forward(cfg, p, g)
        before = spmm_ops.launches
        got = gnn.gnn_forward(
            cfg, gnn.gnn_params_from_numpy(cfg, _numpy(p), card),
            build_graph(cfg, spec, np.random.default_rng(0), device=card))
        assert spmm_ops.launches > before
        close(got, want, 1e-4)
    cfg = recsys_archs._smoke(recsys_archs.DLRM_RM2)
    p = dlrm.init_dlrm_params(cfg, torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v) for k, v in recsys_batch(RecSysBatchSpec(
        64, cfg.n_dense, cfg.n_sparse, cfg.lookups_per_field,
        cfg.resolved_vocabs()), 0).items()}
    before = bag_ops.launches
    got = dlrm.dlrm_forward(cfg, dlrm.dlrm_params_from_numpy(
        cfg, _numpy(p), card), {k: v.to(card) for k, v in batch.items()})
    assert bag_ops.launches == before + 1
    close(got, dlrm.dlrm_forward(cfg, p, batch), 1e-4)


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy(v) for v in tree]
    return tree.numpy()


@pytest.mark.parametrize("B,Tq,Tk,H,Kh,dh", [
    (1, 128, 128, 4, 4, 64),     # MHA
    (2, 256, 256, 8, 2, 64),     # GQA 4:1
    (1, 256, 256, 4, 1, 128),    # MQA
    (2, 128, 128, 8, 4, 32),
    (1, 130, 130, 4, 2, 16),     # ragged: T not a tile multiple
    (1, 200, 200, 32, 8, 64),    # llama3.2-1b heads
    (1, 96, 160, 16, 8, 128),    # qwen3-1.7b heads, Tq < Tk
    (1, 160, 96, 24, 2, 128),    # starcoder2-3b heads, Tq > Tk
    # the tensor-core kernel's 128-row tiles: one short, one over, many
    (1, 127, 127, 8, 2, 64),
    (1, 129, 129, 8, 2, 128),
    (1, 1000, 1000, 8, 2, 64),
    (1, 1000, 1000, 4, 2, 128),
    (1, 100, 300, 8, 2, 64),     # Tq < Tk across tiles
    (1, 300, 100, 8, 2, 64),     # Tq > Tk across tiles
    (2, 200, 200, 4, 1, 128),    # B = 2, one KV head
    (2, 257, 257, 16, 4, 64),    # G = 4, ragged
    (1, 129, 129, 4, 2, 32),
    (1, 129, 129, 4, 2, 16),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_matches_plain(card, B, Tq, Tk, H, Kh, dh, dtype,
                                    causal):
    rng = np.random.default_rng(Tq + Tk + dh)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(dtype) for s in ((B, Tq, H, dh), (B, Tk, Kh, dh),
                                    (B, Tk, Kh, dh)))
    before, on_path = fa_ops.launches, dict(fa_ops.path_launches)
    got = fa_ops.flash_attention(q.to(card), k.to(card), v.to(card), causal)
    torch.cuda.synchronize()
    assert fa_ops.launches == before + 1
    path = "tensor_core" if dtype == torch.bfloat16 else "tensor_core_tf32x3"
    assert fa_ops.path_launches[path] == on_path[path] + 1
    assert got.dtype == dtype and got.shape == q.shape
    flash_close(got, flash_attention_ref(q, k, v, causal), dtype)


@pytest.mark.parametrize("dtype,dh,path", [
    (torch.bfloat16, 16, "tensor_core"), (torch.bfloat16, 32, "tensor_core"),
    (torch.bfloat16, 64, "tensor_core"), (torch.bfloat16, 128, "tensor_core"),
    (torch.float32, 16, "tensor_core_tf32x3"),
    (torch.float32, 32, "tensor_core_tf32x3"),
    (torch.float32, 64, "tensor_core_tf32x3"),
    (torch.float32, 128, "tensor_core_tf32x3")])
def test_flash_wrapper_records_the_path(card, dtype, dh, path):
    """bf16 goes to the tensor-core kernel, f32 to the 3xTF32 tensor-core
    kernel; ``launches`` counts both, ``path_launches`` each."""
    q = torch.randn(1, 130, 8, dh, device=card).to(dtype)
    k = torch.randn(1, 130, 2, dh, device=card).to(dtype)
    total, before = fa_ops.launches, dict(fa_ops.path_launches)
    fa_ops.flash_attention(q, k, k)
    torch.cuda.synchronize()
    assert fa_ops.launches == total + 1
    assert fa_ops.path_launches == {
        p: n + (p == path) for p, n in before.items()}


def test_flash_wrapper_rejects_on_the_card(card):
    q = torch.zeros(1, 8, 4, 64, device=card)
    k = torch.zeros(1, 8, 2, 64, device=card)
    with pytest.raises(ValueError, match="one dtype"):
        fa_ops.flash_attention(q, k.bfloat16(), k.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        fa_ops.flash_attention(q.transpose(1, 2), k, k)
    with pytest.raises(ValueError, match="head width"):
        fa_ops.flash_attention(q[..., :48].contiguous(),
                               k[..., :48].contiguous(),
                               k[..., :48].contiguous())
    k3 = torch.zeros(1, 8, 3, 64, device=card)
    with pytest.raises(ValueError, match="group"):
        fa_ops.flash_attention(q, k3, k3)
    odd = torch.zeros(1 + q.numel(), device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte boundary"):
        fa_ops.flash_attention(odd[1:].view(q.shape), k.bfloat16(),
                               k.bfloat16())


@pytest.mark.parametrize("arch", ["LLAMA32_1B", "QWEN3_1P7B",
                                  "STARCODER2_3B"])
def test_lm_forward_and_decode_on_the_card(card, arch):
    """The model's forward through the kernel (one launch a layer) equals
    its CPU forward through the plain version, in f32 (1e-4); a decode
    step equals the CPU's."""
    cfg = dataclasses.replace(lm_archs._smoke(getattr(lm_archs, arch)),
                              compute_dtype=torch.float32)
    p = transformer.init_lm_params(cfg, torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 40)).astype(np.int32))
    want = transformer.lm_forward(cfg, p, tokens)[0]
    pc = transformer.lm_params_from_numpy(cfg, _numpy(p), card)
    before = fa_ops.launches
    got = transformer.lm_forward(cfg, pc, tokens.to(card))[0]
    assert fa_ops.launches == before + cfg.n_layers
    close(got, want, 1e-4)
    lengths = torch.tensor([3, 7], dtype=torch.int32)
    caches = [transformer.init_kv_cache(cfg, 2, 16, device=d)
              for d in ("cpu", card)]
    for c in caches:
        for t in c:
            t.copy_(torch.from_numpy(np.random.default_rng(1).standard_normal(
                t.shape).astype(np.float32)))
    want, _ = transformer.lm_decode_step(cfg, p, tokens[:, :1], caches[0],
                                         lengths)
    got, _ = transformer.lm_decode_step(cfg, pc, tokens[:, :1].to(card),
                                        caches[1], lengths.to(card))
    close(got, want, 1e-4)
    close(caches[1][0].float(), caches[0][0].float(), 1e-2)   # bf16 cache
