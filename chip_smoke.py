"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's main paths through the hand-written CUDA kernels and
fails (uncaught exception, non-zero exit) if any phase does.  The
streaming engine (``StreamingEngine.seed -> run_increment -> values``,
every chunk one launch of the cycle kernel: the cluster kernel, the grid
in row bands over a thread-block cluster, wherever a band fits, as it
does on every config here):

  1. device: the card's name and power limit; no CUDA device -> exit 1
  2. build: nvcc for sm_90a, all four kernels at once, with the ptxas
     registers, spills and static shared memory of both cycle kernels'
     four instances each (without and with telemetry, without and with
     faults); fails if a cluster instance spills
  3. cycle kernel vs plain PyTorch version on the card, every leaf and the
     launch record exactly equal (tolerance 0), each launch counted on the
     kernel it took: (a) the pinned 8x8 config chunk by chunk to
     quiescence (the plain version on a CPU copy of each chunk's input),
     (b) three mid-stream states of the 2000-vertex stream on
     the 32x32 paper config, one K=512 chunk each, on the cluster kernel
     and again forced onto the one-block kernel
  4. fingerprints through the kernel: tests/data/pre_lanes_reference.json
     and src/repro_torch/data/fingerprint_32x32.json, exactly
  5. the paper's 50K-vertex / 1M-edge stream (10 edge-sampled increments)
     on the paper config, BFS values exactly the oracle's: its 102
     launches and 50,030 cycles, every launch on the cluster kernel; ns a
     machine cycle and the wall
  6. one full-size K=512 chunk through the cluster kernel and the
     one-block kernel in turns (cluster, block, block, cluster), each
     equal to the plain version: both times, the plain version's, the
     byte bound and the cluster geometry

The paper's experiments (``launch/paper_experiments.py``; the same cycle
kernel, in its branches for per-cycle traces, ``app="ingest_only"`` and
``allocator="random"``), right after phase 6:

 16. the new branches against the plain version on both cycle kernels
     (cluster, and forced onto the one-block kernel), every leaf, the
     launch record and every trace row equal: (a) the pinned 8x8 config
     chunk by chunk, traced, bfs and ingest_only (the plain version on a
     CPU copy of each chunk's input); (b) three mid-stream
     states of the 2000-vertex stream on the 32x32 paper config, one
     traced K=512 chunk each, for bfs, ingest_only and bfs under the
     random allocator
 17. the experiments at 50K vertices / 1M edges (nothing cut), the counts
     set to 0 before and every launch on the cluster kernel: ingest_only
     and bfs over edge and snowball sampling, bfs under the random
     allocator, ingest_only and bfs traced; every bfs stream's values the
     oracle's, ingest_only's all 1e9, the traced streams' totals those of
     the untraced ones increment by increment with one trace row a cycle,
     the bfs edge stream 102 launches and 50,030 cycles; the wall of each
     stream; then Fig. 8/9, Table 2, Fig. 5 and the Fig. 6/7 summary from
     the runner's cache
 18. replays: ``src/repro_torch/data/paper_ci_fingerprint.json`` (the JAX
     engine's five ci streams: counters, values, vertex_object_stats and
     both traces) and the ``engine_ci`` / ``engine_mid`` counters of
     ``results/bench_engine.json``, exactly
 19. the trace rows' cost: phase 6's K=512 chunk on the cluster kernel
     untraced and traced in turns (untraced, traced, traced, untraced),
     each equal to the plain version, the trace rows too

Virtual lanes, transit parking, rhizome vertex objects and the
max-monotone apps (the same cycle kernel, in its branches for ``lanes >
1``, ``rhizome_cap > 1``, ``app="widest"`` and ``app="reliable"``), and
the skew and lanes experiments, right after phase 19:

 20. the new branches against the plain version on both cycle kernels
     (cluster, and forced onto the one-block kernel), every leaf and the
     launch record equal, chunk by chunk to quiescence: (a) the 8x8 hub
     stream of ``tests/test_lanes.py`` at lanes=4, the hub stream of
     ``tests/test_rhizome.py`` at rhizome_cap=4 (bfs), and widest and
     reliable at rhizome_cap=2, lanes=2 on a weighted stream (the plain
     version on a CPU copy of each chunk's input); (b) the
     32x32 paper-scale skew config (rhizome_cap=4, lanes=2, 16,384
     vertices), whose cells fit no cluster band: a mid-stream state, one
     K=64 chunk on the one-block kernel
 21. ``src/repro_torch/data/skew_fingerprint.json`` (the JAX engine's
     ``bench_skew`` / ``bench_lanes`` configs at ci 8x8 and mid 16x16)
     replayed exactly on the cluster kernel: per-increment counters,
     values and vertex_object_stats of the rows that finish, the increment,
     cycle, chunk and counters of the rows that livelock; each row's wall
     and ms a launch; then ``bench_lanes("ci")`` equal to
     ``results/bench_lanes.json``, ``bench_skew("ci")``'s rows, and
     ``bench_lanes("mid")`` stopping at its lanes-smoke gate
 22. ``bench_skew``'s rows at the paper's 32x32 (16,384 vertices, 262,144
     R-MAT edges, lanes=2, queue_cap 48) on the one-block kernel,
     rhizome_cap 4, 2 and 1, each with a budget of 600,000 cycles an
     increment and the counts set to 0 just before it: ``ok`` with BFS ==
     oracle, ``livelock`` or ``budget``, and where the fingerprint holds
     the JAX engine's run of the row, its counters and outcome exactly;
     cycles, hops, stalls, rhizome stats, launches by kernel, the wall, ms
     a launch beside the byte bound

Telemetry (the same cycle kernel, in its compile-time telemetry instances:
the planes ``tm_cell``, ``tm_lane`` and ``tm_hiw`` accumulated inside the
cycle, a frame a chunk on the device, the flight recorder), right after
phase 22:

 23. both cycle kernels' telemetry instances against the plain version
     (cluster, and forced onto the one-block kernel), every leaf (the
     three planes included) and the launch record equal: the pinned 8x8
     stream chunk by chunk, the 8x8 hub stream at lanes=4, rhizome_cap=4
     (its first 16 chunks), the plain version of both on a CPU copy of
     each chunk's input, and phase 6's full-size state (the 32x32
     paper config, lanes=1), one K=512 chunk
 24. ``src/repro_torch/data/telemetry_fingerprint.json`` (the JAX engine
     with telemetry on: the pinned stream, the six ci skew and lanes
     configs, ``bench_engine``'s ci stream and the 8x8 hub livelock)
     replayed exactly on the cluster kernel: each increment's counters,
     frame count, ``dropped``, totals and final-frame plane digests, the
     ci heatmap, each livelock's cycle, chunk, frames and full text
 25. the paths with telemetry at full width, the counts set to 0 just
     before each and read just after: the paper stream (50K / 1M) in turns
     without and with telemetry (off, on, on, off), each 102 launches on
     the cluster kernel and 50,030 cycles, the runs with telemetry equal
     to phase 5's counters with every increment's final frame reconciling
     and BFS == oracle, ms a launch by CUDA events; ``bench_skew``'s
     rhizome_cap=4 row at paper scale (16,384 vertices) on the one-block
     kernel, whose ``LivelockError`` at cycle 8,192 carries the frame log
     and the JAX engine's text, wedge report included; and
     ``bench_engine("ci", profile=True)``, its heatmap equal to
     ``results/profile/heatmap_jnp.json`` but ``cycles`` (208); the paper
     stream without and with telemetry once more under ``torch.profiler``
     for the device's idle share (not measured where the profiler fails)
 26. telemetry's cost: phase 6's K=512 chunk on the cluster kernel in turns
     (off, on, on, off), each equal to its plain version

Faults, seals and repair (the same cycle kernel, in its compile-time
fault instances: a ``FaultPlan``'s drop, dup, corrupt and blackout
hazards in the hop stage, the seals, ``OP_REPAIR``, the ``flt``
counters; the engine's loss detector and repair pass), right after phase
26:

 27. both cycle kernels' fault instances, telemetry on and off, against
     one run of the plain version with telemetry on (the runs without it
     on every leaf but the planes), every leaf (``flt`` and the seal
     words included) and the launch record equal: (a) the pinned 8x8
     stream (lanes=1) under drop, dup and corrupt, chunk by chunk; (b)
     the hub stream of ``tests/test_resilience.py`` (lanes=2) under its
     plan, 16 chunks; (c) phase 6's full-size state under the paper plan
     with its blackout window over that chunk's cycles, one K=512 chunk;
     (d) the 8x8 hub stream at rhizome_cap=4 under drop, run on the
     kernel without its repair, then the repair's sentinel rows (to
     secondary roots too) loaded and run under the plan's safe twin
     (the plain version of (a), (b) and (d) on a CPU copy of each
     chunk's input)
 28. ``src/repro_torch/data/fault_fingerprint.json`` (the JAX engine
     under fault plans, telemetry on: the ci and mid fault smokes, the
     hub stream under a zero-rate plan and its four plans, the pinned
     stream under drop and corrupt; the paper config at 20K vertices /
     400K edges under the paper plan, telemetry off, which livelocks in
     its repair pass) replayed exactly on the cluster kernel: each
     increment's cycles, counters, ``flt``, frames and the digest of
     every leaf of its final state, the livelock's increment, cycle,
     chunk and ``flt``; then
     ``paper_experiments.fault_smoke`` at ci (943 cycles) and mid (3,451)
 29. the paper stream (50K / 1M) under the paper plan (drop, dup and
     corrupt at 4, 2 and 2 per cent, a W link dead for cycles 0-511) on
     the cluster kernel, telemetry off and on, the counts set to 0 just
     before each: per increment the cycles (repair included), ``flt``,
     whether the repair ran and, with telemetry, departures less
     deliveries == ``FLT_DROP``; launches by kernel; BFS == oracle.  A
     livelock is recorded, not hidden: its increment, cycle and pass,
     the kernels held against the plain version on the chunk in which
     the machine wedged, and the path again without dups
 30. what faults cost, in turns (CUDA events): the paper stream without
     faults and under a zero-rate plan (off, zero, zero, off), ms a
     launch; phase 6's K=512 chunk without faults, under the zero-rate
     plan and under the paper plan (off and faulty each equal to the
     plain version, zero-rate equal to off but for the seals); the
     faulty mid stream (10K / 100K on the paper config) against the
     clean one, both through the same function, cycles and wall (clean,
     faulty, faulty, clean).  The off
     path against the parent commit: ``tools/cca_cycle_ab.py``

The GNN and DLRM serving forwards (every aggregation a launch of the
scatter-SpMM kernel, every DLRM lookup one launch of the EmbeddingBag
kernel):

  7. the ptxas reports of the scatter-SpMM and EmbeddingBag kernels
  8. scatter-SpMM kernel vs plain on the card (max |d| <= 1e-4 max(1,
     max |ref|)) at every aggregation shape of phase 9: GCN-Cora (D = 16,
     7, gather and coeff fused), Cora edge messages (D = 70 gatedgcn, 128
     meshgraphnet), ogb_products (D = 16, 7), and GraphCast's multimesh
     at refinement 6, grid-to-mesh and mesh-to-grid sets (D = 512), and
     equal bit for bit to ``spmm_ordered``, the order of the warp shape
     ``ops.geometry`` picks; the kernel over the graph's row pointers
     timed in turns with the old wide shape (old, new, new, old, twice), beside
     the wrapper, the plain version, ``torch.sparse.mm`` on the CSR matrix
     (yardstick only), the bound and the gather floor (the 32-byte
     sectors of x the edges touch)
  9. GNN serving at published widths: gcn-cora on full_graph_sm and on
     ogb_products, gatedgcn, meshgraphnet and graphcast on full_graph_sm;
     finite outputs, equal to the CPU forward elementwise within 1e-4
     (full_graph_sm; graphcast, whose f32 function cannot meet that at
     random init, no farther from its f64 forward than twice the CPU's
     f32 forward), spmm launches per forward, wall per forward, peak
     memory
 10. EmbeddingBag kernel vs plain at RM2 widths on the 26 full-size tables
     (36.8 GB, drawn on the card, checked once by
     ``dlrm.prepare_dlrm_params`` as serving does) for serve_p99 and
     serve_bulk (1e-5), and
     equal bit for bit to ``embedding_bags_ordered`` (the kernel's order
     of sums); the warp shape ``ops.geometry`` picked; timed beside the
     plain version and ``F.embedding_bag`` per table, the byte bound, its
     share of the kernel's time, and the gather floor (every lookup into a
     table larger than the L2 read from memory); serve_p99 both by the
     call rate and as device time from a CUDA graph of its one launch
 11. DLRM-RM2 serving at full width: serve_p99 and serve_bulk forwards,
     retrieval over 1,000,000 candidates; finite logits, top-100 shapes,
     the serve_p99 logits and the retrieval's scores equal to the CPU
     forward over the touched rows (elementwise, 1e-4), launches (every
     one in the warp shape ``ops.geometry`` picks at RM2), wall, peak
     memory

The LM serving path (llama3.2-1b; every prefill attention one launch of
the flash-attention kernel a layer, the bf16 prefill on its tensor-core
path, decode attention plain PyTorch):

 12. the ptxas report of each flash-attention instantiation (registers,
     spills, shared memory); the tensor-core kernels, bf16 and 3xTF32, at
     dh 64 and 128 must not spill
 13. flash kernel vs plain on the card, entry by entry (``flash_excess``:
     2e-2 x (|ref| + median |ref|) in bf16, 2e-5 x (|ref| + 1) in f32) at
     T = 4096 at the heads of llama3.2-1b (32/8, dh 64), qwen3-1.7b (16/8,
     128) and starcoder2-3b (24/2, 128), bf16 and f32, and at llama's
     heads at T = 32768 in bf16 (the plain version head by head: its full
     score matrix would be 137 GB); at each shape two planted faults (the
     next KV head; each row blind to the keys more than T/2 back) must
     fail the same limit; each timed beside the plain version,
     ``F.scaled_dot_product_attention`` (yardstick only, on K/V repeated
     to the query heads beforehand; the backend its dispatcher picks, its
     time held to EFFICIENT_ATTENTION, and its own excess over the same
     limit) and the bound (f32: three TF32 products at 165 TFLOP/s, the
     CUDA cores' 67 beside it), with the kernel's TFLOP/s, its time over
     SDPA's and the bound's share of its time, and the path it took
     (bf16: tensor cores; f32: tensor cores as 3xTF32)
 14. prefill at full width: llama3.2-1b on prefill_32k at B = 1 and
     T = 32768 (the main path whose flash launches the kernels line
     reports: 80, all on the tensor-core path), qwen3-1.7b at B = 1,
     T = 4096: finite logits, flash
     launches per forward = n_layers, wall, tokens/s, the attention share
     by CUDA events, peak memory; llama3.2-1b once more at B = 16 (its
     own 32 runs out of memory): finite logits, wall, peak memory; at
     T = 2048 the kernel path's bf16 logits no farther from an f32
     forward than max(1e-3, 2x) the plain attention's bf16 forward; at
     T = 128 the last-token logits of ``prefill`` equal those of 128
     ``lm_decode_step`` calls within 5e-2
 15. serving at full width: ``serve()`` on llama3.2-1b at decode_32k with
     32 slots (cut from 128) and max_len 32768, 64 requests of 16 prompt
     and 24 generated tokens: every request answered, decode-step p50 /
     p99, tokens/s, peak memory

It ends with the kernels line (JSON) and the ok line (JSON, last).
"""
import collections
import contextlib
import dataclasses
import json
import pathlib
import re
import subprocess
import sys
import time
import warnings
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import kernels  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.configs import gnn_archs, lm_archs  # noqa: E402
from repro_torch.configs.base import (gnn_shapes, lm_shapes,  # noqa: E402
                                      recsys_shapes)
from repro_torch.configs.recsys_archs import DLRM_RM2  # noqa: E402
from repro_torch.core import (LIVELOCK_CHUNKS, EngineConfig,  # noqa: E402
                              LivelockError, StreamingEngine)
from repro_torch.core.apps import BFS  # noqa: E402
from repro_torch.core.msg import DIR_W  # noqa: E402
from repro_torch.core.ingest import load_stream  # noqa: E402
from repro_torch.core.reference import bfs_levels  # noqa: E402
from repro_torch.data.graphs import build_graph  # noqa: E402
from repro_torch.data.pipeline import (RecSysBatchSpec,  # noqa: E402
                                       recsys_batch)
from repro_torch.graph.segment_ops import sym_norm_coeff  # noqa: E402
from repro_torch.core.state import TM_HOP, init_state  # noqa: E402
from repro_torch.graph.streams import StreamSpec, make_stream  # noqa: E402
from repro_torch.kernels.cca_cycle import ops  # noqa: E402
from repro_torch.kernels.cca_cycle.ref import cca_cycle_chunk_ref  # noqa: E402
from repro_torch.kernels.embedding_bag import ops as bag_ops  # noqa: E402
from repro_torch.kernels.embedding_bag.ref import (  # noqa: E402
    embedding_bags_ordered, embedding_bags_ref)
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_ref)
from repro_torch.kernels.spmm import ops as spmm_ops  # noqa: E402
from repro_torch.kernels.spmm.ref import (scatter_spmm_ref,  # noqa: E402
                                          spmm_ordered, spmm_sorted_coo_ref)
from repro_torch.launch import paper_experiments as pe  # noqa: E402
from repro_torch.launch import serve as lm_serve  # noqa: E402
from repro_torch.models import dlrm, gnn, transformer  # noqa: E402
from repro_torch.resilience import (FLT_CORRUPT, FLT_DROP,  # noqa: E402
                                    FaultPlan)

H100_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (data sheet, 700 W)
H100_L2_BYTES = 50e6         # H100 L2 (data sheet)
H100_F32_FLOPS = 67e12       # f32 outside the tensor cores (data sheet)
H100_BF16_FLOPS = 989e12     # bf16 tensor cores, dense (data sheet)
H100_TF32_FLOPS = 495e12     # tf32 tensor cores, dense (data sheet)
# f32 accuracy on the tensor cores: three TF32 products (3xTF32) each
H100_F32_TC_FLOPS = H100_TF32_FLOPS / 3
PAPER_FULL = dict(n_vertices=50_000, n_edges=1_000_000)


def paper_cfg(n_vertices, n_edges):
    """``benchmarks/paper_experiments.py::_engine``'s config formula."""
    ghosts = max(64, 2 * n_edges // (8 * 1024), 3 * n_vertices // 1024)
    return EngineConfig(height=32, width=32, n_vertices=n_vertices,
                        edge_cap=8, ghost_slots=ghosts, queue_cap=64,
                        chan_cap=16, futq_cap=16, io_stream_cap=2 ** 21,
                        chunk=512)


def clone(st):
    return st._replace(**{k: v.clone() for k, v in st._asdict().items()})


def leaf_diff(a, b) -> float:
    """Max abs difference over all leaves; float leaves must also match
    bit for bit (a NaN or a -0.0 counts as a difference)."""
    worst = 0.0
    for name in a._fields:
        x, y = getattr(a, name), getattr(b, name)
        if x.dtype == torch.float32:
            if not torch.equal(x.view(torch.int32), y.view(torch.int32)):
                worst = max(worst, float((x - y).abs().max()), 1e-30)
        elif not torch.equal(x, y):
            worst = max(worst, float((x.long() - y.long()).abs().max()))
        if worst:
            raise AssertionError(f"leaf {name!r} differs (max |d| {worst})")
    return worst


TM_LEAVES = ("tm_cell", "tm_lane", "tm_hiw")


def without_telemetry(cfg, st):
    """``cfg`` with telemetry off and ``st`` with its planes the 1x1
    dummies that config lays out."""
    cfg_off = dataclasses.replace(cfg, telemetry=False)
    like = init_state(cfg_off, device="meta")
    return cfg_off, st._replace(**{
        k: torch.zeros(getattr(like, k).shape, dtype=torch.int32,
                       device=st.aq.device) for k in TM_LEAVES})


def to_device(st, dev):
    return st._replace(**{k: v.to(dev) for k, v in st._asdict().items()})


def kernel_vs_plain(cfg, app, st, n_cycles=None, paths=("auto",),
                    traced=False, plain_on_cpu=False,
                    also_without_telemetry=False):
    """One chunk through the kernel (once for each of ``paths``) and the
    plain version from the same input; returns the max abs difference (0)
    or raises.  ``traced``: each call fills a trace tensor, and the
    kernel's rows of the cycles run must equal the plain version's.
    ``plain_on_cpu`` runs the plain version on a CPU copy of the input
    (the same integer and IEEE f32 arithmetic; on an 8x8 grid ~2.5x the
    speed of its thousands of tiny launches a cycle on the card) and
    brings its result back.  ``also_without_telemetry`` (``cfg`` has
    telemetry on): each path also runs with telemetry off, and those runs
    equal the plain version's on every leaf but the planes (telemetry
    touches no other leaf), which stay their zero dummies."""
    n = cfg.chunk if n_cycles is None else n_cycles
    dev = st.aq.device

    def rows(d):
        return torch.full((n, 2), -1, dtype=torch.int32,
                          device=d) if traced else None

    cases = [(cfg, st, None)]
    if also_without_telemetry:
        cfg_off, st_off = without_telemetry(cfg, st)
        cases.append((cfg_off, st_off, st_off))
    runs = []
    for p in paths:
        for c, s, off in cases:
            tr = rows(dev)
            runs.append((off,) + ops.cca_cycle_chunk(c, app, clone(s),
                                                     n_cycles, path=p,
                                                     trace=tr) + (tr,))
    src = to_device(st, "cpu") if plain_on_cpu else st
    want = rows(src.aq.device)
    sr, cr = cca_cycle_chunk_ref(cfg, app, src, n_cycles, want)
    sr, cr = to_device(sr, dev), cr.to(dev)
    want = want.to(dev) if traced else None
    torch.cuda.synchronize()
    worst, ran = 0.0, int(cr[1])
    for off, sk, ck, tk in runs:
        tm = f" (telemetry {'off' if off else 'on'})" \
            if also_without_telemetry else ""
        if not torch.equal(ck, cr):
            raise AssertionError(f"launch record {ck.tolist()} != "
                                 f"{cr.tolist()}{tm}")
        worst = max(worst, leaf_diff(sk, sr if off is None else sr._replace(
            **{k: getattr(off, k) for k in TM_LEAVES})))
        if traced and not torch.equal(tk[:ran], want[:ran]):
            bad = int((tk[:ran] != want[:ran]).any(1).nonzero()[0])
            raise AssertionError(f"trace row {bad}: {tk[bad].tolist()} != "
                                 f"{want[bad].tolist()}{tm}")
    return worst, sr, bool(cr[0])


def chunks_vs_plain(tag, cfg, app, st, incs, max_chunks=None, **kw):
    """``kernel_vs_plain`` on both kernels (cluster, then forced onto the
    one-block kernel), the plain version on the CPU (``plain_on_cpu``: the
    8x8 grids this runs), chunk by chunk over ``incs`` from ``st``: each
    increment loaded (``None`` loads nothing), the counters, planes and
    ``flt`` reset, then run to quiescence, or until ``max_chunks`` chunks
    in all; raises unless every cycle-kernel launch since the start was
    one of these.  ``kw`` goes to ``kernel_vs_plain``.  Returns ``(max abs
    difference (0), state, chunks, cycles)``."""
    worst, chunks, cycles = 0.0, 0, 0
    before = dict(ops.path_launches)
    for e in incs:
        if e is not None:
            st, spill = load_stream(cfg, st, e)
            assert len(spill) == 0
        st, q = fresh_stats(st), False
        c0 = int(st.cycle)
        while not q and chunks != max_chunks:
            d, st, q = kernel_vs_plain(cfg, app, st,
                                       paths=("cluster", "block"),
                                       plain_on_cpu=True, **kw)
            worst, chunks = max(worst, d), chunks + 1
        cycles += int(st.cycle) - c0
    per = 2 if kw.get("also_without_telemetry") else 1
    got = {p: ops.path_launches[p] - before[p] for p in ops.PATHS}
    if got != {"block": per * chunks, "cluster": per * chunks}:
        raise AssertionError(f"{tag}: launches {got}, {chunks} chunks")
    return worst, st, chunks, cycles


def on_path(before, path, n):
    """Raise unless the cycle-kernel launches since ``before`` (a copy of
    ``ops.path_launches``) were all on ``path``: ``n`` of them, or at
    least one where ``n`` is None."""
    got = {p: ops.path_launches[p] - before[p] for p in ops.PATHS}
    ok = got[path] > 0 if n is None else got[path] == n
    if not ok or sum(got.values()) != got[path]:
        raise AssertionError(f"cycle-kernel launches {got}, not all on the "
                             f"{path} kernel")


CYCLE_INSTANCES = tuple(f"{k}{t}{f}" for k in ("cluster", "block")
                        for t in ("", "_telemetry") for f in ("", "_faults"))


def cycle_ptxas(report: str) -> dict:
    """Phase 2: the registers, spills and static shared memory of both
    cycle kernels, each in its four instances, without and with telemetry,
    without and with faults (``cluster``, ``cluster_telemetry``,
    ``cluster_faults``, ``cluster_telemetry_faults``, and ``block...`` the
    same), printed; raises if a cluster instance spills or an instance is
    missing."""
    out = {}
    for name, info in _build.ptxas_functions(report).items():
        m = re.search(r"(cca_cycle_cluster_kernel|cca_cycle_kernel)"
                      r"ILb([01])ELb([01])E", name)
        if not m:
            continue
        kind = ("cluster" if "cluster" in m[1] else "block") + (
            "_telemetry" if m[2] == "1" else "") + (
            "_faults" if m[3] == "1" else "")
        out[kind] = info
        print(f"[2] {kind} kernel: {info.get('registers')} registers, "
              f"{info.get('spill_stores')} bytes spill stores, "
              f"{info.get('spill_loads')} bytes spill loads, "
              f"{info.get('stack')} bytes stack, static smem "
              f"{info.get('smem', 0)} bytes", flush=True)
    for kind in CYCLE_INSTANCES[:4]:
        c = out.get(kind, {})
        if not c or c.get("spill_stores", 1) or c.get("spill_loads", 1):
            raise AssertionError(f"{kind} cycle kernel: spills or no report "
                                 f"({c})")
    if set(out) != set(CYCLE_INSTANCES):
        raise AssertionError(f"cycle kernel instances {sorted(out)}")
    return out


STAT_LEAVES = ("stat_hops", "stat_exec", "stat_stall", "stat_allocs",
               "tm_cell", "tm_lane", "tm_hiw", "flt")


def fresh_stats(st):
    """Counters, telemetry planes and fault counters zeroed, as
    ``run_increment`` does."""
    return st._replace(**{k: torch.zeros_like(getattr(st, k))
                          for k in STAT_LEAVES})


@contextlib.contextmanager
def timed_launches(events: list):
    """While the block runs, every cycle-kernel launch through
    ``ops.cca_cycle_chunk`` appends a pair of CUDA events around it to
    ``events``."""
    launch = ops.cca_cycle_chunk

    def timed_chunk(*a, **kw):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = launch(*a, **kw)
        ev[1].record()
        events.append(ev)
        return out

    ops.cca_cycle_chunk = timed_chunk
    try:
        yield
    finally:
        ops.cca_cycle_chunk = launch


def replay(ref):
    cfg_fields = EngineConfig.__dataclass_fields__
    cfg = EngineConfig(**{k: v for k, v in ref["cfg"].items()
                          if k in cfg_fields})
    incs = make_stream(StreamSpec(**ref["spec"]))
    eng = StreamingEngine(cfg, "bfs")
    eng.seed(0, 0.0)
    rows = []
    for e in incs:
        r = eng.run_increment(e, max_cycles=ref.get("max_cycles", 500_000))
        rows.append(dict(cycles=r.cycles, hops=r.hops, execs=r.execs,
                         stalls=r.stalls, allocs=r.allocs))
    return rows, eng.values()


def branch_phases(pinned) -> float:
    """Phase 16: the cycle kernel's branches of the paper experiments
    against the plain version, every launch on both kernels (cluster, then
    forced onto the one-block kernel), every leaf, the record and every
    trace row equal; returns the max abs difference (0)."""
    worst = 0.0
    # (a) the pinned 8x8 config chunk by chunk, traced, bfs and ingest_only
    for app in ("bfs", "ingest_only"):
        t0 = time.time()
        eng = StreamingEngine(EngineConfig(**pinned["cfg"]), app)
        if app == "bfs":
            eng.seed(0, 0.0)
        d, _, chunks, _ = chunks_vs_plain(
            f"16a {app}", eng.cfg, eng.app, eng.state,
            make_stream(StreamSpec(**pinned["spec"])), traced=True)
        worst = max(worst, d)
        print(f"[16a] 8x8 pinned, {app}, traced: both kernels == plain on "
              f"every leaf, the record and every trace row over {chunks} "
              f"chunks (max |d| {worst}; {time.time() - t0:.1f}s)",
              flush=True)
    # (b) the 32x32 ci stream: three mid-stream states, one K=512 chunk each
    ci = pe.SCALES["ci"]
    incs = pe.stream_increments("edge", "ci")
    for app, alloc in (("bfs", "vicinity"), ("ingest_only", "vicinity"),
                       ("bfs", "random")):
        eng = pe._engine(ci["n_vertices"], app, alloc, n_edges=ci["n_edges"])
        for i, e in enumerate(incs):
            if i in (2, 5, 8):
                st, _ = load_stream(eng.cfg, clone(eng.state), e)
                t0 = time.time()
                before = dict(ops.path_launches)
                d, sr, q = kernel_vs_plain(eng.cfg, eng.app, fresh_stats(st),
                                           512, ("cluster", "block"),
                                           traced=True)
                if {p: ops.path_launches[p] - before[p] for p in ops.PATHS} \
                        != {"cluster": 1, "block": 1}:
                    raise AssertionError("16b: not one launch on each kernel")
                worst = max(worst, d)
                print(f"[16b] 32x32 ci {app} {alloc} increment {i}: one "
                      f"traced K=512 chunk, both kernels == plain on every "
                      f"leaf, the record and every trace row (cycle "
                      f"{int(sr.cycle)}, quiescent {q}, "
                      f"{time.time() - t0:.1f}s)", flush=True)
            eng.run_increment(e, max_cycles=2_000_000)
    return worst


PAPER_STREAMS = (  # (app, sampling, allocator, traced), in the order run
    ("ingest_only", "edge", "vicinity", False),
    ("bfs", "edge", "vicinity", False),
    ("ingest_only", "snowball", "vicinity", False),
    ("bfs", "snowball", "vicinity", False),
    ("bfs", "edge", "random", False),
    ("ingest_only", "edge", "vicinity", True),
    ("bfs", "edge", "vicinity", True))
TOTALS = ("edges", "cycles", "hops", "execs", "stalls", "allocs")


HUB_KW = dict(height=8, width=8, n_vertices=128, edge_cap=4, ghost_slots=48,
              queue_cap=20, chan_cap=16, futq_cap=4, io_stream_cap=2048,
              chunk=64)          # tests/test_lanes.py::_hub_cfg
RHIZOME_KW = dict(height=8, width=8, n_vertices=64, edge_cap=4,
                  ghost_slots=32, queue_cap=96, chan_cap=16, futq_cap=8,
                  io_stream_cap=2048, chunk=128)   # test_rhizome.py::cfg_for
MAX_APP_KW = dict(height=8, width=8, n_vertices=64, edge_cap=4,
                  ghost_slots=32, queue_cap=48, chan_cap=16, futq_cap=4,
                  io_stream_cap=2048, chunk=64, rhizome_cap=2, lanes=2)
MAX_APP_SEEDS = {"widest": 1e9, "reliable": 1.0}

def weighted_increments(seed=1, n=64, m=320):
    """``tests/test_torch_max_apps.py``'s stream: two increments of random
    edges, each weight drawn from (0, 1]."""
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, m), rng.integers(0, n, m)
    w = (1.0 - rng.random(m)).astype(np.float32)
    e = np.stack([src, dst, w.view(np.int32)], 1).astype(np.int32)
    return [e[: m // 2], e[m // 2:]]


def lane_rhizome_phases() -> float:
    """Phase 20a: the lane, park, rhizome and max-app branches of both
    cycle kernels against the plain version, every leaf and the launch
    record equal, chunk by chunk to quiescence.  Returns the max abs
    difference (0)."""
    worst = 0.0
    cases = (
        ("8x8 hub lanes=4", EngineConfig(lanes=4, **HUB_KW), "bfs",
         [pe.hub_stream(128, 200)], 0.0),
        ("8x8 hub rhizome_cap=4 bfs", EngineConfig(rhizome_cap=4,
                                                   **RHIZOME_KW),
         "bfs", [pe.hub_stream(64, 40)], 0.0),
        ("8x8 widest rhizome_cap=2 lanes=2", EngineConfig(**MAX_APP_KW),
         "widest", weighted_increments(), MAX_APP_SEEDS["widest"]),
        ("8x8 reliable rhizome_cap=2 lanes=2", EngineConfig(**MAX_APP_KW),
         "reliable", weighted_increments(), MAX_APP_SEEDS["reliable"]))
    for name, cfg, app, incs, seed in cases:
        t0 = time.time()
        eng = StreamingEngine(cfg, app)
        eng.seed(0, seed)
        d, st, chunks, cycles = chunks_vs_plain(f"20a {name}", cfg, eng.app,
                                                eng.state, incs)
        worst = max(worst, d)
        print(f"[20a] {name}, {app}: both kernels (cluster "
              f"{ops.cluster_geometry(cfg)}) == plain on every leaf and the "
              f"record over {chunks} chunks, {cycles} cycles, "
              f"{int(st.stat_stall)} stalls in the last increment (max |d| "
              f"{worst}; {time.time() - t0:.1f}s)", flush=True)
    return worst


def skew_state_phase() -> float:
    """Phase 20b: the paper-scale skew config (rhizome_cap=4, lanes=2),
    whose cells fit no cluster band, mid-stream: eight K=512 chunks of
    increment 0 on the kernel, then one K=64 chunk on the one-block kernel
    against the plain version.  Returns the max abs difference (0)."""
    t0 = time.time()
    cfg = pe.skew_config("paper", rhizome_cap=4)
    if ops.cluster_geometry(cfg) is not None:
        raise AssertionError("20b: the paper skew config fits a band")
    eng = StreamingEngine(cfg, "bfs")
    eng.seed(0, 0.0)
    st, _ = load_stream(cfg, eng.state, pe.skew_increments("paper")[0])
    st = fresh_stats(st)
    for _ in range(8):
        st, _ = ops.cca_cycle_chunk(cfg, eng.app, st, 512)
    before = dict(ops.path_launches)
    d, sr, q = kernel_vs_plain(cfg, eng.app, st, 64, ("block",))
    on_path(before, "block", 1)
    print(f"[20b] 32x32 skew paper config (rhizome_cap=4, lanes=2; a cell "
          f"{ops.cluster_cell_bytes(cfg)} bytes, no band fits): at cycle "
          f"{int(st.cycle)} of increment 0 ({int(st.pk_n.sum())} messages "
          f"parked, {int(st.ch_n.sum())} in channels), one K=64 chunk, the "
          f"one-block kernel == plain on every leaf (quiescent {q}; "
          f"{time.time() - t0:.1f}s)", flush=True)
    return d


def skew_records() -> list:
    return json.loads((ROOT / "src" / "repro_torch" / "data"
                       / "skew_fingerprint.json").read_text())["configs"]


def check_skew_row(name, row, eng, c) -> str:
    """Raise unless ``row`` (``pe.skew_row``'s) and ``eng`` hold the JAX
    engine's record ``c``: the status, each increment's counters, then the
    livelock's increment, cycle, chunk and counters, or the values and
    ``vertex_object_stats``.  Returns what was held, in words."""
    if row["status"] != c["status"] or row["increments"] != c["increments"]:
        raise AssertionError(f"{name}: {row['status']} {row['increments']} "
                             f"!= {c['status']} {c['increments']}")
    if c["status"] == "livelock":
        if row["livelock"] != c["livelock"]:
            raise AssertionError(f"{name}: {row['livelock']} != "
                                 f"{c['livelock']}")
        return "livelock at increment %(increment)d cycle %(cycle)d" \
            % c["livelock"]
    if not (eng.values() == np.float32(c["values"])).all():
        raise AssertionError(f"{name}: values differ")
    if eng.vertex_object_stats() != c["vertex_object_stats"]:
        raise AssertionError(f"{name}: vertex_object_stats")
    return "values (== oracle) and vertex_object_stats"


def skew_replay_phases() -> dict:
    """Phase 21: ``src/repro_torch/data/skew_fingerprint.json``, the JAX
    engine's skew and lanes configs at ci and mid scale, replayed exactly
    on the cluster kernel: per-increment counters, values and
    ``vertex_object_stats`` of the rows that finish, the increment, cycle,
    chunk and counters of the livelocks."""
    t_all = time.time()
    out = {}
    for c in skew_records():
        if c["scale"] == "paper":
            continue                  # phase 22, on the one-block kernel
        key = (c["scale"], c["queue_cap"], c["lanes"], c["rhizome_cap"])
        name = "%s q=%d lanes=%d R=%d" % key
        cfg = pe.skew_config(*key)
        want_cfg = {k: v for k, v in c["cfg"].items()
                    if k in EngineConfig.__dataclass_fields__}
        if dataclasses.asdict(cfg) != want_cfg:
            raise AssertionError(f"21 {name}: config differs from the record")
        if ops.cluster_geometry(cfg) is None:
            raise AssertionError(f"21 {name}: no band fits")
        row, eng = pe.skew_row(*key)
        what = check_skew_row(f"21 {name}", row, eng, c)
        la = row["launches"]
        if la["block"] or not la["cluster"]:
            raise AssertionError(f"21 {name}: launches {la}")
        cycles = sum(r["cycles"] for r in row["increments"]) + (
            row["livelock"]["cycle"] if "livelock" in row else 0)
        out[name] = dict(status=row["status"], cycles=cycles,
                         launches=la["cluster"], wall_s=row["wall_s"])
        print(f"[21] {name}: {row['status']}, {cycles} cycles, counters and "
              f"{what} == the JAX engine's; {la['cluster']} launches on the "
              f"cluster kernel {ops.cluster_geometry(cfg)}, wall "
              f"{row['wall_s']:.4f}s ({1e3 * row['wall_s'] / la['cluster']:.4f}"
              f" ms a launch, host clock)", flush=True)
    # the ported benchmarks themselves: bench_lanes at ci against
    # results/bench_lanes.json (the JAX package's run), bench_skew's ci
    # rows, and bench_lanes at mid, which stops at its lanes-smoke gate
    rows, base = pe.bench_lanes("ci")
    want = json.loads((ROOT / "results" / "bench_lanes.json").read_text())[
        "lanes_ci"]
    if rows != want["rows"] or base != want["oversize_baseline"]:
        raise AssertionError(f"21 bench_lanes ci: {rows} {base} != {want}")
    skew = pe.bench_skew("ci")
    print(f"[21] bench_lanes ci == results/bench_lanes.json: "
          f"{json.dumps(rows)}, baseline {json.dumps(base)}; bench_skew ci: "
          f"{json.dumps(skew)}", flush=True)
    try:
        pe.bench_lanes("mid")
        raise AssertionError("21 bench_lanes mid passed its gate")
    except SystemExit as ex:
        print(f"[21] bench_lanes mid stops at its gate, as the JAX "
              f"package's does: {ex}", flush=True)
    out["bench_skew_ci"] = skew
    print(f"[21] done in {time.time() - t_all:.1f}s", flush=True)
    return out


SKEW_PAPER_ROWS = (4, 2, 1)            # rhizome_cap, lanes=2, queue_cap 48
SKEW_PAPER_MAX_CYCLES = 600_000        # a row's budget, each increment


def skew_paper_phases() -> dict:
    """Phase 22: ``bench_skew``'s rows at the paper's 32x32 (16,384
    vertices, 262,144 R-MAT edges) on the one-block kernel, since no band
    fits; each row ``ok`` with BFS == oracle, ``livelock`` or ``budget``.
    The counts are set to 0 just before each row and read just after."""
    rows = {}
    records = {c["rhizome_cap"]: c for c in skew_records()
               if c["scale"] == "paper"}
    for R in SKEW_PAPER_ROWS:
        cfg = pe.skew_config("paper", rhizome_cap=R)
        st0 = init_state(cfg, device="meta")
        mutable = sum(t.numel() * t.element_size()
                      for k, t in st0._asdict().items() if k != "io_edges")
        bound_ms = 1e3 * 2 * mutable / H100_BYTES_PER_S
        events = []
        ops.launches = 0
        ops.path_launches = dict.fromkeys(ops.PATHS, 0)
        with timed_launches(events):
            row, eng = pe.skew_row("paper", rhizome_cap=R,
                                   max_cycles=SKEW_PAPER_MAX_CYCLES)
        la = dict(ops.path_launches)
        if la["cluster"] or not la["block"] or la != row["launches"]:
            raise AssertionError(f"22 R={R}: launches {la}")
        held = "no JAX record"
        if R in records:
            held = check_skew_row(f"22 R={R}", row, eng, records[R]) \
                + " == the JAX engine's"
        kern_ms = sum(a.elapsed_time(b) for a, b in events)
        stats = eng.vertex_object_stats()
        cycles = row["cycles"] + (row["livelock"]["cycle"]
                                  if "livelock" in row else 0)
        row.update(vertex_object_stats=stats, kernel_ms=kern_ms,
                   ms_per_launch=kern_ms / la["block"], bound_ms=bound_ms,
                   mutable_mib=mutable / 2 ** 20, all_cycles=cycles)
        rows[R] = row
        print(f"[22] paper skew rhizome_cap={R}: {row['status']}"
              + (" at increment %(increment)d cycle %(cycle)d" %
                 row["livelock"] if "livelock" in row else "")
              + f", {cycles} cycles ({[r['cycles'] for r in row['increments']]}"
              f" by increment), {row['hops']} hops, {row['stalls']} stalls "
              f"in the increments that finished; rhizomes "
              f"{stats['rhizomes']} on {stats['multi_root_vertices']} "
              f"vertices, max fan-out {stats['max_fanout']}, ghosts "
              f"{stats['ghosts']}; launches {la} (one-block kernel); wall "
              f"{row['wall_s']:.3f}s (host clock), kernel "
              f"{kern_ms / 1e3:.3f}s by CUDA events, "
              f"{kern_ms / la['block']:.4f} ms a launch "
              f"({1e6 * kern_ms / max(cycles, 1):.1f} ns a cycle) beside "
              f"the bound {bound_ms:.4f} ms a launch (2 x "
              f"{mutable / 2 ** 20:.1f} MiB over 3.35 TB/s)"
              + ("; BFS == oracle" if row["status"] == "ok" else "")
              + f"; counters and {held}", flush=True)
        del eng
        torch.cuda.empty_cache()
    return rows


TELEMETRY_FP = json.loads((ROOT / "src" / "repro_torch" / "data"
                           / "telemetry_fingerprint.json").read_text())
PINNED_SPEC = json.loads((ROOT / "tests" / "data"
                          / "pre_lanes_reference.json").read_text())["spec"]


def telemetry_phase_kernels(pinned, cfg_p, st) -> tuple[float, tuple]:
    """Phase 23: both cycle kernels' telemetry instances against the plain
    version, every leaf (the three planes included) and the record equal:
    (a) the pinned 8x8 stream chunk by chunk; (b) the 8x8 hub stream at
    lanes=4, rhizome_cap=4, its first 16 chunks; (c) phase 6's full-size
    state (the 32x32 paper config, lanes=1, the last increment), one K=512
    chunk.  Returns the max abs difference (0) and (c)'s config, input and
    plain result."""
    worst = 0.0
    cases = (("8x8 pinned", EngineConfig(**pinned["cfg"], telemetry=True),
              make_stream(StreamSpec(**pinned["spec"])), None),
             ("8x8 hub lanes=4 rhizome_cap=4",
              EngineConfig(**dict(HUB_KW, lanes=4, rhizome_cap=4),
                           telemetry=True), [pe.hub_stream(128, 200)], 16))
    for name, cfg, incs, max_chunks in cases:
        t0 = time.time()
        eng = StreamingEngine(cfg, "bfs")
        eng.seed(0, 0.0)
        d, st8, chunks, _ = chunks_vs_plain(f"23 {name}", cfg, BFS,
                                            eng.state, incs, max_chunks)
        worst = max(worst, d)
        print(f"[23] {name}, telemetry: both kernels == plain on every leaf "
              f"(planes included) and the record over {chunks} chunks; "
              f"sum of tm_cell {int(st8.tm_cell.sum())}, of tm_lane "
              f"{int(st8.tm_lane.sum())} (max |d| {worst}; "
              f"{time.time() - t0:.1f}s)", flush=True)
    t0 = time.time()
    cfg_t = dataclasses.replace(cfg_p, telemetry=True)
    like = init_state(cfg_t, device="meta")
    st_t = st._replace(**{k: torch.zeros(getattr(like, k).shape,
                                         dtype=torch.int32,
                                         device=st.aq.device)
                          for k in ("tm_cell", "tm_lane", "tm_hiw")})
    before = dict(ops.path_launches)
    d, s_plain_t, q = kernel_vs_plain(cfg_t, BFS, st_t, 512,
                                      ("cluster", "block"))
    if {p: ops.path_launches[p] - before[p] for p in ops.PATHS} != \
            {"cluster": 1, "block": 1}:
        raise AssertionError("23c: not one launch on each kernel")
    print(f"[23] 32x32 paper config, the last increment's state, telemetry: "
          f"one K=512 chunk, both kernels == plain on every leaf (planes "
          f"included; cycle {int(s_plain_t.cycle)}, quiescent {q}; "
          f"{time.time() - t0:.1f}s)", flush=True)
    return max(worst, d), (cfg_t, st_t, s_plain_t)


def telemetry_run(rec: dict):
    """One stream of the telemetry fingerprint through the engine on the
    card (``pe.telemetry_replay``).  Returns ``(record, engine)``."""
    return pe.telemetry_replay(rec, TELEMETRY_FP["max_cycles"], PINNED_SPEC)


def check_telemetry_record(name, got, rec) -> None:
    for k in ("increments", "livelock", "heatmap"):
        if got.get(k) != rec.get(k):
            raise AssertionError(f"{name}: {k} differs from the JAX "
                                 f"engine's: {got.get(k)} != {rec.get(k)}")


def telemetry_phase_replay() -> None:
    """Phase 24: ``src/repro_torch/data/telemetry_fingerprint.json`` (the
    JAX engine with telemetry on) replayed exactly on the cluster kernel:
    each increment's counters, frame count, ``dropped``, totals and the
    final frame's plane digests, ``bench_engine``'s ci heatmap, and each
    livelock's increment, cycle, chunk, frame log digests and full text
    (the wedge report included)."""
    t_all = time.time()
    for rec in TELEMETRY_FP["streams"]:
        if rec["args"][:1] == ["paper"]:
            continue                       # phase 25, one-block kernel
        t0 = time.time()
        before = dict(ops.path_launches)
        got, _ = telemetry_run(rec)
        check_telemetry_record(f"24 {rec['name']}", got, rec)
        la = {p: ops.path_launches[p] - before[p] for p in ops.PATHS}
        if la["block"] or not la["cluster"]:
            raise AssertionError(f"24 {rec['name']}: launches {la}")
        ll = got.get("livelock")
        print(f"[24] {rec['name']}: "
              f"{[r['cycles'] for r in got['increments']]} cycles, frames "
              f"{[r['frames'] for r in got['increments']]}"
              + (f", livelock at increment {ll['increment']} cycle "
                 f"{ll['cycle']} with {ll['frames']} frames and its wedge "
                 f"report" if ll else "")
              + (", the heatmap" if "heatmap" in got else "")
              + f" == the JAX engine's ({la['cluster']} launches on the "
              f"cluster kernel, {time.time() - t0:.1f}s)", flush=True)
    print(f"[24] done in {time.time() - t_all:.1f}s", flush=True)


def paper_stream_run(cfg, incs, events=None, launches=102, cycles=50_030):
    """The paper stream through the engine: per-increment results and the
    engine; ``events`` (a list) gets a pair of CUDA events around each
    launch; every run ``launches`` launches on the cluster kernel and
    ``cycles`` cycles (the 50K / 1M stream's by default)."""
    eng = StreamingEngine(cfg, "bfs")
    eng.seed(0, 0.0)
    before = dict(ops.path_launches)
    with timed_launches(events) if events is not None \
            else contextlib.nullcontext():
        res = [eng.run_increment(e, max_cycles=2_000_000) for e in incs]
    torch.cuda.synchronize()
    la = {p: ops.path_launches[p] - before[p] for p in ops.PATHS}
    got = sum(r.cycles for r in res)
    if la != {"block": 0, "cluster": launches} or got != cycles:
        raise AssertionError(f"paper stream telemetry={cfg.telemetry}, "
                             f"faults={cfg.faults}: launches {la}, {got} "
                             f"cycles")
    return res, eng


def profiler_error(step) -> str | None:
    """Run one step of ``torch.profiler``; the reason it failed, if it
    did."""
    try:
        step()
    except Exception as ex:      # the profiler, not the run: not measured
        return f"{type(ex).__name__}: {ex}"
    return None


def device_idle_share(fn) -> dict:
    """Run ``fn`` under ``torch.profiler`` (CPU and CUDA activity) and
    return its wall, the device time of its kernels and copies (the sum of
    their self device times; one stream, so they do not overlap) and the
    idle share 1 - device / wall; the profiler's own host cost inflates
    the wall, so the share is an upper bound.  An exception of ``fn``
    propagates; where the profiler itself fails or its trace holds no
    device time, the share is not measured and the reason is returned."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    err = profiler_error(prof.start)
    if err:
        return dict(idle_share=None, reason=err)
    t0 = time.time()
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        wall = time.time() - t0
        err = profiler_error(prof.stop)
    if err:
        return dict(idle_share=None, reason=err)
    dev_us = []
    err = profiler_error(lambda: dev_us.append(sum(
        getattr(e, "self_device_time_total",
                getattr(e, "self_cuda_time_total", 0))
        for e in prof.key_averages() if e.device_type == DeviceType.CUDA)))
    if err or not dev_us[0]:
        return dict(idle_share=None,
                    reason=err or "no device time in the trace")
    return dict(wall_s=wall, device_s=dev_us[0] / 1e6,
                idle_share=1 - dev_us[0] / 1e6 / wall)


def telemetry_phase_paths(incs, cfg_p, plain_rows, want) -> dict:
    """Phase 25: the three paths with telemetry at full width, each with
    the counts set to 0 just before it and read just after: (a) the paper
    stream (50K / 1M) in turns without and with telemetry (off, on, on,
    off; CUDA events around every launch): every run 102 launches on the
    cluster kernel and 50,030 cycles, the runs with telemetry equal to
    phase 5's counters increment by increment, every increment's final
    frame reconciling exactly, BFS == oracle; (b) ``bench_skew``'s
    rhizome_cap=4 row at paper scale on the one-block kernel: its
    ``LivelockError`` carries the frame log and the text, wedge report
    included, of the JAX engine's (the telemetry fingerprint); (c)
    ``bench_engine("ci", profile=True)``: its heatmap equal to
    ``results/profile/heatmap_jnp.json`` in every field but ``cycles``,
    208 as the live JAX engine gives."""
    out = {}
    cfg_t = dataclasses.replace(cfg_p, telemetry=True)
    turns = {False: [], True: []}
    for tm in (False, True, True, False):
        ops.launches = 0
        ops.path_launches = dict.fromkeys(ops.PATHS, 0)
        events = []
        t0 = time.time()
        res, eng = paper_stream_run(cfg_t if tm else cfg_p, incs, events)
        wall = time.time() - t0
        la = dict(ops.path_launches)
        cycles = sum(r.cycles for r in res)
        ms = sum(a.elapsed_time(b) for a, b in events) / len(events)
        turns[tm].append(ms)
        if tm:
            rows = [dict(cycles=r.cycles, hops=r.hops, execs=r.execs,
                         stalls=r.stalls, allocs=r.allocs) for r in res]
            if rows != plain_rows:
                raise AssertionError(f"25a: {rows} != {plain_rows}")
            for r, e in zip(res, incs):
                pe.check_frames(r, len(e))
            assert (eng.values() == want).all(), "25a: BFS != oracle"
            frames = [len(r.frames) for r in res]
        print(f"[25] paper stream telemetry={tm}: {cycles} cycles, launches "
              f"{la}, {ms:.4f} ms a launch by CUDA events, wall {wall:.3f}s "
              f"(host clock, the engine's set-up included)"
              + (f"; counters == phase 5's, every final frame reconciles "
                 f"(frames by increment {frames}), BFS == oracle"
                 if tm else ""), flush=True)
        del eng, res
    out["paper_stream_ms"] = dict(off=turns[False], on=turns[True])
    out["paper_stream_launches"] = 102
    out["idle"] = {}
    for tm in (False, True):
        idle = device_idle_share(
            lambda: paper_stream_run(cfg_t if tm else cfg_p, incs))
        out["idle"]["on" if tm else "off"] = idle
        print(f"[25] paper stream telemetry={tm} under torch.profiler: "
              + (f"wall {idle['wall_s']:.3f}s, device {idle['device_s']:.3f}"
                 f"s, idle share {idle['idle_share']:.4f} (the engine's "
                 f"set-up included; an upper bound)"
                 if idle["idle_share"] is not None
                 else f"idle share not measured: {idle['reason']}"),
              flush=True)
    print(f"[25] paper stream in turns off, on, on, off: "
          f"{turns[False][0]:.4f} / {turns[True][0]:.4f} / "
          f"{turns[True][1]:.4f} / {turns[False][1]:.4f} ms a launch: "
          f"telemetry {np.mean(turns[True]) / np.mean(turns[False]):.4f}x",
          flush=True)
    torch.cuda.empty_cache()
    # (b) the paper-scale skew row, R = 4, with telemetry
    rec = next(r for r in TELEMETRY_FP["streams"]
               if r["args"][:1] == ["paper"])
    ops.launches = 0
    ops.path_launches = dict.fromkeys(ops.PATHS, 0)
    t0 = time.time()
    got, eng = telemetry_run(rec)
    wall = time.time() - t0
    la = dict(ops.path_launches)
    if la["cluster"] or not la["block"]:
        raise AssertionError(f"25b: launches {la}")
    check_telemetry_record("25b paper skew R=4", got, rec)
    ll = got["livelock"]
    print(f"[25] paper skew rhizome_cap=4, telemetry: livelock at increment "
          f"{ll['increment']} cycle {ll['cycle']} chunk {ll['chunk']}, "
          f"{ll['frames']} frames, the frame digests and the error's text "
          f"== the JAX engine's; launches {la} (one-block kernel), wall "
          f"{wall:.3f}s (host clock). Its report:\n"
          + "\n".join(ll["message"].splitlines()[1:4]), flush=True)
    out["skew_paper"] = dict(launches=la["block"], cycle=ll["cycle"],
                             frames=ll["frames"], wall_s=wall)
    del eng
    torch.cuda.empty_cache()
    # (c) the ci profile of bench_engine
    ops.launches = 0
    ops.path_launches = dict.fromkeys(ops.PATHS, 0)
    prof_dir = ROOT / "build" / "profile"
    got = pe.bench_engine("ci", profile=True, profile_dir=prof_dir)
    prof = got["profile"]
    heat = json.loads(pathlib.Path(prof["heatmap"]).read_text())
    want_heat = json.loads((ROOT / "results" / "profile"
                            / "heatmap_jnp.json").read_text())
    if heat["cycles"] != 208 or {k: v for k, v in heat.items()
                                 if k != "cycles"} != \
            {k: v for k, v in want_heat.items() if k != "cycles"}:
        raise AssertionError("25c: the heatmap differs from "
                             "results/profile/heatmap_jnp.json")
    la = dict(ops.path_launches)
    if la["block"] or not la["cluster"]:
        raise AssertionError(f"25c: launches {la}")
    print(f"[25] bench_engine ci profile: heatmap == results/profile/"
          f"heatmap_jnp.json but cycles (208, the file's 464); "
          f"{prof['frames']} frames, rates {json.dumps(prof['rates'])}; "
          f"wall {prof['wall_s']:.4f}s with telemetry, "
          f"{prof['wall_vs_plain']:.3f}x the plain run's {got['wall_s']:.4f}s"
          f" (host clock); launches {la}; dumps in {prof_dir}", flush=True)
    out["engine_ci_profile"] = dict(frames=prof["frames"],
                                    rates=prof["rates"],
                                    wall_s=prof["wall_s"],
                                    wall_vs_plain=prof["wall_vs_plain"])
    return out


def telemetry_phase_cost(cfg_t, st_t, s_plain_t, cfg_p, st, s_plain) -> dict:
    """Phase 26: telemetry's cost on phase 6's K=512 chunk on the cluster
    kernel, in turns (off, on, on, off; CUDA events), each equal to its
    plain version."""
    turns = {False: [], True: []}
    for tm in (False, True, True, False):
        cfg, s0, want = (cfg_t, st_t, s_plain_t) if tm else \
            (cfg_p, st, s_plain)
        s = clone(s0)
        before = dict(ops.path_launches)
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        a.record()
        s2, _ = ops.cca_cycle_chunk(cfg, BFS, s, 512, path="cluster")
        b.record()
        torch.cuda.synchronize()
        on_path(before, "cluster", 1)
        leaf_diff(s2, want)
        turns[tm].append(a.elapsed_time(b))
    ratio = np.mean(turns[True]) / np.mean(turns[False])
    print(f"[26] full-size K=512 chunk on the cluster kernel in turns off, "
          f"on, on, off: {turns[False][0]:.4f} / {turns[True][0]:.4f} / "
          f"{turns[True][1]:.4f} / {turns[False][1]:.4f} ms: telemetry "
          f"{ratio:.4f}x; each == plain on every leaf", flush=True)
    return dict(chunk_ms=dict(off=turns[False], on=turns[True]),
                chunk_ratio=ratio)


# ---- faults, seals and repair (phases 27-30) ----

FAULT_FP = json.loads((ROOT / "src" / "repro_torch" / "data"
                       / "fault_fingerprint.json").read_text())
# the JAX package's tests/test_resilience.py: its hub config and plan
FAULT_HUB_KW = dict(height=8, width=8, n_vertices=256, edge_cap=8,
                    ghost_slots=24, queue_cap=32, chan_cap=16, chunk=64,
                    lanes=2, max_cycles=200_000)
HUB_PLAN = FaultPlan(seed=7, drop_rate=0.05, dup_rate=0.03,
                     corrupt_rate=0.02)
# the paper stream's plan: drop, dup and corrupt at 4, 2 and 2 per cent,
# the W link out of cell (0, 1) dead for the first 512 cycles; and the
# plan fixed in advance for a livelock under it, the same without dups
PAPER_PLAN = FaultPlan(seed=7, drop_rate=0.04, dup_rate=0.02,
                       corrupt_rate=0.02, blackouts=((0, 1, DIR_W, 0, 512),))
PAPER_PLAN_NO_DUP = dataclasses.replace(PAPER_PLAN, dup_rate=0.0)
# the mid stream (10K / 100K, ten increments) on the paper config: its
# launches and cycles clean and under PAPER_PLAN (repairs included)
MID_STREAM = {"clean": (20, 7049), "faulty": (38, 14869)}
def fault_phase_kernels(pinned, cfg_p, st) -> tuple[float, tuple]:
    """Phase 27: the fault instances of both cycle kernels, telemetry on
    and off, against one run of the plain version with telemetry on
    (``kernel_vs_plain(also_without_telemetry=True)``): (a) the pinned
    8x8 stream (lanes=1) under drop, dup and corrupt, chunk by chunk; (b)
    the hub stream of ``tests/test_resilience.py`` (lanes=2) under its
    plan, 16 chunks; (c) phase 6's full-size state (the 32x32 paper
    config, the last increment loaded) under the paper plan with the
    blackout window moved onto its cycles, one K=512 chunk; (d) the 8x8
    hub stream at rhizome_cap=4 under drop, run to quiescence on the
    kernel without its repair, then the repair's sentinel rows loaded and
    run chunk by chunk under the plan's safe twin.  Returns the max abs
    difference (0) and (c)'s config, input and plain result."""

    def chunks(name, cfg, st, incs, max_chunks=None):
        t0 = time.time()
        d, st, n, _ = chunks_vs_plain(f"27 {name}", cfg, BFS, st, incs,
                                      max_chunks, also_without_telemetry=True)
        print(f"[27] {name}: the fault instances of both kernels, telemetry "
              f"on and off, == plain on every leaf and the record over {n} "
              f"chunks (cycle {int(st.cycle)}); flt {st.flt.tolist()} in the "
              f"last increment (max |d| {d}; {time.time() - t0:.1f}s)",
              flush=True)
        return d

    cfg = EngineConfig(**pinned["cfg"], telemetry=True,
                       faults=dataclasses.replace(HUB_PLAN, seed=5))
    eng = StreamingEngine(cfg, "bfs")
    eng.seed(0, 0.0)
    worst = chunks("(a) 8x8 pinned lanes=1", cfg, eng.state,
                   make_stream(StreamSpec(**pinned["spec"])))
    cfg = EngineConfig(**FAULT_HUB_KW, telemetry=True, faults=HUB_PLAN)
    eng = StreamingEngine(cfg, "bfs")
    eng.seed(0, 0.0)
    worst = max(worst, chunks("(b) 8x8 hub lanes=2", cfg, eng.state,
                              [pe.hub_stream()], 16))
    t0 = time.time()
    c0 = int(st.cycle)
    cfg_f = dataclasses.replace(cfg_p, telemetry=True, faults=dataclasses
                                .replace(PAPER_PLAN, blackouts=(
                                    (0, 1, DIR_W, c0, 512),)))
    like = init_state(cfg_f, device="meta")
    st_f = st._replace(**{k: torch.zeros(getattr(like, k).shape,
                                         dtype=torch.int32,
                                         device=st.aq.device)
                          for k in TM_LEAVES + ("flt",)})
    before = dict(ops.path_launches)
    d, s_plain_f, q = kernel_vs_plain(cfg_f, BFS, st_f, 512,
                                      ("cluster", "block"),
                                      also_without_telemetry=True)
    if {p: ops.path_launches[p] - before[p] for p in ops.PATHS} != \
            {"cluster": 2, "block": 2}:
        raise AssertionError("27c: not two launches on each kernel")
    flt = s_plain_f.flt.tolist()
    if min(flt) == 0:
        raise AssertionError(f"27c: a hazard never fired: flt {flt}")
    worst = max(worst, d)
    print(f"[27] (c) 32x32 paper config, the last increment's state, the "
          f"paper plan with its blackout over cycles {c0}..{c0 + 511}: one "
          f"K=512 chunk, the fault instances of both kernels, telemetry on "
          f"and off, == plain on every leaf (flt {flt}; cycle "
          f"{int(s_plain_f.cycle)}, quiescent {q}; {time.time() - t0:.1f}s)",
          flush=True)
    cfg = EngineConfig(rhizome_cap=4, **RHIZOME_KW, telemetry=True,
                       faults=FaultPlan(seed=3, drop_rate=0.05))
    eng = StreamingEngine(cfg, "bfs")
    eng.seed(0, 0.0)
    eng.state, spill = load_stream(cfg, eng.state, pe.hub_stream(64, 40))
    eng.state = fresh_stats(eng.state)
    eng._passes(cfg, spill, 200_000, [])
    entries = eng._repair_entries()
    secondary = int((entries[:, 1] < -1).sum())
    if not eng._loss_count() or not secondary:
        raise AssertionError(f"27d: lost {eng._loss_count()}, {secondary} "
                             f"sentinel rows for secondary roots")
    safe = dataclasses.replace(cfg, faults=cfg.faults.safe())
    st_r, spill = load_stream(safe, eng.state, entries)
    assert len(spill) == 0
    worst = max(worst, chunks(
        f"(d) 8x8 hub rhizome_cap=4, {len(entries)} repair rows "
        f"({secondary} to secondary roots) under the safe plan", safe,
        st_r, [None]))
    return worst, (cfg_f, st_f, s_plain_f)


def check_fault_record(name, got, rec) -> None:
    if got.get("livelock") != rec.get("livelock"):
        raise AssertionError(f"{name}: livelock {got.get('livelock')} != "
                             f"the JAX engine's {rec.get('livelock')}")
    if got["increments"] != rec["increments"]:
        for i, (a, b) in enumerate(zip(got["increments"],
                                       rec["increments"])):
            diff = sorted(k for k in b if a.get(k) != b[k])
            diff += sorted(f"state.{k}" for k in b["state"]
                           if a["state"].get(k) != b["state"][k])
            if diff:
                raise AssertionError(f"{name}: increment {i} differs from "
                                     f"the JAX engine's in {diff}")
        raise AssertionError(f"{name}: {len(got['increments'])} increments, "
                             f"the JAX engine's {len(rec['increments'])}")


def fault_phase_replay() -> dict:
    """Phase 28: ``src/repro_torch/data/fault_fingerprint.json`` (the JAX
    engine under fault plans) replayed exactly on the cluster kernel:
    each increment's cycles, counters, ``flt``, frame count and the digest
    of every leaf of its final state, and the livelock of the 32x32 row at
    20K vertices / 400K edges under the paper plan (its increment, cycle,
    chunk and ``flt``: the repair pass's flood, phase 29's at a size the
    JAX engine replays on a CPU); then
    ``fault_smoke`` at ci and mid, its record's cycles and counts those of
    the fingerprint's smoke rows."""
    t_all, smokes = time.time(), {}
    for rec in FAULT_FP["streams"]:
        t0 = time.time()
        before = dict(ops.path_launches)
        got, _ = pe.fault_replay(rec, PINNED_SPEC)
        check_fault_record(f"28 {rec['name']}", got, rec)
        la = {p: ops.path_launches[p] - before[p] for p in ops.PATHS}
        if la["block"] or not la["cluster"]:
            raise AssertionError(f"28 {rec['name']}: launches {la}")
        rows, ll = got["increments"], got.get("livelock")
        print(f"[28] {rec['name']}: {[r['cycles'] for r in rows]} cycles, "
              f"flt {[r['flt'] for r in rows]}, frames "
              f"{[r['frames'] for r in rows]}, every final leaf"
              + (f", the livelock at increment {ll['increment']} cycle "
                 f"{ll['cycle']} (chunk {ll['chunk']}, flt {ll['flt']})"
                 if ll else "")
              + f" == the JAX engine's ({la['cluster']} launches on the "
              f"cluster kernel, {time.time() - t0:.1f}s)", flush=True)
    for scale in pe.ENGINE_SCALES:
        rec = next(r for r in FAULT_FP["streams"]
                   if r["kind"] == "smoke" and r["scale"] == scale)
        got = pe.fault_smoke(scale)
        want = [{k: r[k] for k in ("cycles", "flt", "frames")}
                for r in rec["increments"]]
        if [{k: r[k] for k in ("cycles", "flt", "frames")}
                for r in got["increments"]] != want:
            raise AssertionError(f"28 fault_smoke {scale}: "
                                 f"{got['increments']} != {want}")
        smokes[scale] = {k: got[k] for k in (
            "status", "cycles", "wall_s", "dropped", "duplicated",
            "corrupted", "blackout_hits")}
        print(f"[28] fault_smoke({scale!r}): {json.dumps(smokes[scale])}; "
              f"== the fingerprint", flush=True)
    print(f"[28] done in {time.time() - t_all:.1f}s", flush=True)
    return smokes


@contextlib.contextmanager
def keep_inputs(ring: collections.deque):
    """While the block runs, every cycle-kernel launch through
    ``ops.cca_cycle_chunk`` first appends its config and a copy of its
    input state to ``ring`` (a bounded deque): after a livelock, its
    oldest entry is the chunk in which the machine wedged."""
    launch = ops.cca_cycle_chunk

    def kept(cfg, app, st, *a, **kw):
        ring.append((cfg, clone(st)))
        return launch(cfg, app, st, *a, **kw)

    ops.cca_cycle_chunk = kept
    try:
        yield
    finally:
        ops.cca_cycle_chunk = launch


def faulty_stream(cfg, incs, want) -> dict:
    """A stream under ``cfg``'s plan on the engine, the counts set to 0
    just before and read just after: per increment the cycles (the
    repair's included), ``flt``, whether the repair ran and (telemetry)
    departures less deliveries, which must equal ``FLT_DROP``; launches by
    kernel, all on the cluster kernel; BFS == oracle.  On a
    ``LivelockError`` the record has ``livelock`` (increment, cycle,
    chunk, whether in the repair pass, with telemetry the head of the
    flight recorder's report) and, under ``wedged``, the config
    and input of the chunk in which the machine wedged (the last with
    progress, ``LIVELOCK_CHUNKS`` launches before the error)."""
    ops.launches = 0
    ops.path_launches = dict.fromkeys(ops.PATHS, 0)
    eng = StreamingEngine(cfg, "bfs")
    eng.seed(0, 0.0)
    rows, out = [], {}
    ring = collections.deque(maxlen=LIVELOCK_CHUNKS + 1)
    torch.cuda.synchronize()
    t0 = time.time()
    with keep_inputs(ring):
        for i, e in enumerate(incs):
            try:
                r = eng.run_increment(e, max_cycles=2_000_000)
            except LivelockError as ex:
                out.update(livelock=dict(
                    increment=i, cycle=ex.cycle, chunk=ex.chunk,
                    in_repair=ring[-1][0].faults == cfg.faults.safe(),
                    flt=eng.state.flt.tolist(),
                    report=str(ex).splitlines()[1:4]), wedged=ring[0])
                break
            row = dict(cycles=r.cycles, hops=r.hops,
                       flt=eng.state.flt.tolist(),
                       repaired=pe.lost(eng) > 0)
            if cfg.telemetry:
                row["gap"] = int(eng.state.stat_hops
                                 - eng.state.tm_cell[..., TM_HOP].sum())
                if row["gap"] != row["flt"][FLT_DROP]:
                    raise AssertionError(
                        f"29 increment {i}: departures less deliveries "
                        f"{row['gap']} != FLT_DROP of {row['flt']}")
            rows.append(row)
        torch.cuda.synchronize()
    out.update(wall_s=time.time() - t0, increments=rows,
               cycles=sum(r["cycles"] for r in rows),
               launches=dict(ops.path_launches))
    if out["launches"]["block"] or not out["launches"]["cluster"]:
        raise AssertionError(f"29: launches {out['launches']}")
    if "livelock" not in out and not (eng.values() == want).all():
        raise AssertionError("29: BFS != oracle")
    return out


def fault_phase_paths(cfg_p, incs, want) -> dict:
    """Phase 29: the paper stream (50K / 1M) under ``PAPER_PLAN`` on the
    cluster kernel, telemetry off and on (``faulty_stream``): it loses
    messages and repairs them, ending with BFS == oracle.  Should it
    livelock, that is recorded, not hidden: the increment, the cycle,
    whether in the repair pass, and under ``PAPER_PLAN`` the fault
    instances of both kernels held against the plain version on the chunk
    in which it wedged (the telemetry run's); and the path runs again
    under ``PAPER_PLAN_NO_DUP``, fixed in advance."""
    out = {}
    for name, plan in (("paper", PAPER_PLAN),
                       ("paper without dups", PAPER_PLAN_NO_DUP)):
        for tm in (False, True):
            key = f"{name}, telemetry={'on' if tm else 'off'}"
            r = faulty_stream(dataclasses.replace(cfg_p, faults=plan,
                                                  telemetry=tm), incs, want)
            rows = r["increments"]
            ll = r.get("livelock")
            lost = sum(x["flt"][FLT_DROP] + x["flt"][FLT_CORRUPT]
                       for x in rows) + (ll["flt"][FLT_DROP]
                                         + ll["flt"][FLT_CORRUPT]
                                         if ll else 0)
            if not lost:
                raise AssertionError(f"29 {key}: no message lost")
            print(f"[29] {key}: "
                  + (f"LIVELOCK at increment {ll['increment']}, cycle "
                     f"{ll['cycle']} (chunk {ll['chunk']}), "
                     f"{'in' if ll['in_repair'] else 'before'} its repair "
                     f"pass, flt {ll['flt']}; before it " if ll else "")
                  + f"{r['cycles']} cycles (repairs included) in "
                  f"{r['launches']} launches, wall {r['wall_s']:.3f}s (host "
                  f"clock, set-up included); by increment: cycles "
                  f"{[x['cycles'] for x in rows]}, flt "
                  f"{[x['flt'] for x in rows]}, repaired "
                  f"{[x['repaired'] for x in rows]}"
                  + ("; departures - deliveries == FLT_DROP in each"
                     if tm else "")
                  + ("" if ll else "; BFS == oracle"), flush=True)
            if ll and tm:
                print("\n".join(f"[29]   {x}" for x in ll["report"]),
                      flush=True)
            if ll and tm and plan is PAPER_PLAN:
                t0 = time.time()
                cfg_w, st_w = r["wedged"]
                d, s_w, _ = kernel_vs_plain(cfg_w, BFS, st_w,
                                            paths=("cluster", "block"),
                                            also_without_telemetry=True)
                print(f"[29] {key}: the chunk in which it wedged (cycle "
                      f"{int(st_w.cycle)}..{int(s_w.cycle) - 1}): the fault "
                      f"instances of both kernels, telemetry on and off, == "
                      f"plain on every leaf (max |d| {d}; "
                      f"{time.time() - t0:.1f}s)", flush=True)
            r.pop("wedged", None)
            out[key] = r
        if not any("livelock" in v for v in out.values()):
            break
    return out


SEALED = ("aq", "ch", "pk", "cmsg")    # leaves that hold sealed messages


def same_but_seals(a, b) -> None:
    """Raise unless states ``a`` and ``b`` are equal but for the seal word
    (word 4) of the messages they hold and ``flt``: what a zero-rate plan
    may change."""
    for name in a._fields:
        x, y = getattr(a, name), getattr(b, name)
        if name == "flt":
            continue
        if name in SEALED:
            x, y = x[..., :4], y[..., :4]
        if not torch.equal(x, y):
            raise AssertionError(f"leaf {name!r} differs beyond the seals")


def fault_phase_cost(incs, cfg_p, st, s_plain, cfg_f, st_f, s_plain_f
                     ) -> dict:
    """Phase 30: what faults cost on the card, in turns (CUDA events).
    (a) The paper stream without faults and under a zero-rate plan (off,
    zero, zero, off): ms a launch, the same 102 launches, 50,030 cycles
    and values in every run.  (b) Phase 6's K=512 chunk on the cluster
    kernel without faults, under the zero-rate plan and under phase 27c's
    paper plan (off, zero, faulty, faulty, zero, off): without faults and
    faulty each equal to its plain version, the zero-rate run to the run
    without faults but for the seals.  (c) The faulty stream against the
    clean one, wall and cycles, in turns (clean, faulty, faulty, clean),
    both through ``paper_stream_run`` (the same code and no reads between
    increments; each run's counts set to 0 before it), on the paper config
    at the paper experiments' mid scale (10K vertices, 100K edges, ten
    increments), the largest scale whose faulty stream does not livelock
    (phase 29)."""
    out = {}
    zero = dataclasses.replace(cfg_p, faults=FaultPlan(seed=7))
    turns = {"off": [], "zero": []}
    want = None
    for which in ("off", "zero", "zero", "off"):
        ops.launches = 0
        ops.path_launches = dict.fromkeys(ops.PATHS, 0)
        events = []
        res, eng = paper_stream_run(zero if which == "zero" else cfg_p,
                                    incs, events)
        turns[which].append(sum(a.elapsed_time(b) for a, b in events)
                            / len(events))
        vals = eng.values()
        if want is None:
            want = vals
        elif not (vals == want).all():
            raise AssertionError("30a: values differ between the runs")
        if which == "zero" and sum(eng.state.flt.tolist()):
            raise AssertionError("30a: a zero-rate plan injected faults")
        del eng, res
    ratio = np.mean(turns["zero"]) / np.mean(turns["off"])
    print(f"[30] paper stream in turns off, zero-rate, zero-rate, off: "
          f"{turns['off'][0]:.4f} / {turns['zero'][0]:.4f} / "
          f"{turns['zero'][1]:.4f} / {turns['off'][1]:.4f} ms a launch "
          f"(102 launches, 50,030 cycles each): the zero-rate plan "
          f"{ratio:.4f}x", flush=True)
    out["paper_stream_ms"] = turns
    out["zero_rate_ratio"] = ratio
    cfg_fo, st_fo = without_telemetry(cfg_f, st_f)
    want_f = s_plain_f._replace(**{k: getattr(st_fo, k) for k in TM_LEAVES})
    cases = {"off": (cfg_p, st), "zero": (zero, st_f._replace(
        **{k: getattr(st, k) for k in TM_LEAVES})), "faulty": (cfg_fo, st_fo)}
    chunk = {k: [] for k in cases}
    kept = {}
    for which in ("off", "zero", "faulty", "faulty", "zero", "off"):
        cfg, s0 = cases[which]
        s = clone(s0)
        before = dict(ops.path_launches)
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        a.record()
        s2, _ = ops.cca_cycle_chunk(cfg, BFS, s, 512, path="cluster")
        b.record()
        torch.cuda.synchronize()
        on_path(before, "cluster", 1)
        chunk[which].append(a.elapsed_time(b))
        kept[which] = s2
        if which == "off":
            leaf_diff(s2, s_plain)
        elif which == "faulty":
            leaf_diff(s2, want_f)
    same_but_seals(kept["zero"], kept["off"])
    off_ms = np.mean(chunk["off"])
    print(f"[30] full-size K=512 chunk on the cluster kernel in turns off, "
          f"zero-rate, faulty, faulty, zero-rate, off: off "
          f"{chunk['off'][0]:.4f} / {chunk['off'][1]:.4f} ms, zero-rate "
          f"{chunk['zero'][0]:.4f} / {chunk['zero'][1]:.4f} ms "
          f"({np.mean(chunk['zero']) / off_ms:.4f}x), faulty "
          f"{chunk['faulty'][0]:.4f} / {chunk['faulty'][1]:.4f} ms "
          f"({np.mean(chunk['faulty']) / off_ms:.4f}x); off and faulty == "
          f"plain on every leaf, zero-rate == off but for the seals",
          flush=True)
    out["chunk_ms"] = chunk
    mid = pe.SCALES["mid"]
    incs_mid = make_stream(StreamSpec(increments=10, sampling="edge", seed=1,
                                      **mid))
    want_mid = bfs_levels(mid["n_vertices"], np.concatenate(incs_mid), 0)
    cfg_mid = paper_cfg(**mid)
    runs = {"clean": [], "faulty": []}
    for which in ("clean", "faulty", "faulty", "clean"):
        faulty = which == "faulty"
        ops.launches = 0
        ops.path_launches = dict.fromkeys(ops.PATHS, 0)
        torch.cuda.synchronize()
        t0 = time.time()
        _, eng = paper_stream_run(
            dataclasses.replace(cfg_mid, faults=PAPER_PLAN) if faulty
            else cfg_mid, incs_mid, None, *MID_STREAM[which])
        wall = time.time() - t0
        if not (eng.values() == want_mid).all():
            raise AssertionError(f"30c: the {which} mid stream's BFS != "
                                 f"oracle")
        if faulty:
            flt = eng.state.flt.tolist()
            if not flt[FLT_DROP]:
                raise AssertionError(f"30c: no drop in the last increment "
                                     f"({flt})")
        runs[which].append(wall)
        del eng
    (c_la, c_cy), (f_la, f_cy) = MID_STREAM["clean"], MID_STREAM["faulty"]
    out["faulty_vs_clean_mid"] = dict(
        clean_cycles=c_cy, faulty_cycles=f_cy, clean_launches=c_la,
        faulty_launches=f_la, clean_wall_s=runs["clean"],
        faulty_wall_s=runs["faulty"])
    print(f"[30] mid stream (10K / 100K on the 32x32 paper config) in turns "
          f"clean, faulty, faulty, clean, each through paper_stream_run: "
          f"{c_cy} / {f_cy} cycles ({f_cy / c_cy:.4f}x), {c_la} / {f_la} "
          f"launches, wall {runs['clean'][0]:.4f} / {runs['faulty'][0]:.4f} "
          f"/ {runs['faulty'][1]:.4f} / {runs['clean'][1]:.4f}s "
          f"({np.mean(runs['faulty']) / np.mean(runs['clean']):.4f}x; host "
          f"clock, the engine's set-up included, ends in synchronize); BFS "
          f"== oracle in every run, the faulty one's after its repairs (flt "
          f"of its last increment {flt})", flush=True)
    return out


def experiment_phases(smi: str) -> dict:
    """Phase 17: the paper's experiments at 50K vertices / 1M edges through
    ``launch/paper_experiments.py``, every launch on the cluster kernel
    (the counts set to 0 before and read after), checked by the repo's own
    means; then the tables, read from its cache."""
    t_all = time.time()
    ops.launches = 0
    ops.path_launches = dict.fromkeys(ops.PATHS, 0)
    n = pe.SCALES["paper"]["n_vertices"]
    oracle, streams = {}, []
    for app, sampling, alloc, traced in PAPER_STREAMS:
        t0 = time.time()
        incs = pe.stream_increments(sampling, "paper")
        gen_s = time.time() - t0
        before = dict(ops.path_launches)
        torch.cuda.synchronize()
        t0 = time.time()
        rows, eng = pe.run_stream(app, sampling, "paper", allocator=alloc,
                                  collect_traces=traced)
        torch.cuda.synchronize()
        wall = time.time() - t0
        got = {p: ops.path_launches[p] - before[p] for p in ops.PATHS}
        if got["block"] or not got["cluster"]:
            raise AssertionError(f"17 {app} {sampling}: launches {got}")
        key = (app, sampling, "paper", alloc, traced, "cuda")
        cycles = sum(r["cycles"] for r in rows)
        vals = eng.values()
        if app == "bfs":
            if sampling not in oracle:
                oracle[sampling] = bfs_levels(n, np.concatenate(incs), 0)
            assert (vals == oracle[sampling]).all(), \
                f"17 {sampling} {alloc}: BFS != oracle"
        elif not (vals == np.float32(1e9)).all():
            raise AssertionError(f"17 ingest_only {sampling}: values moved")
        if traced:
            plain = pe._CACHE[key[:4] + (False, "cuda")][0]
            for a, b in zip(plain, rows):
                if {k: a[k] for k in TOTALS} != {k: b[k] for k in TOTALS} \
                        or len(a["active"]) or len(b["active"]) != b["cycles"]:
                    raise AssertionError(f"17 traced {app}: increment "
                                         f"{b['increment']} {b} != {a}")
        if (app, sampling, alloc, traced) == ("bfs", "edge", "vicinity",
                                              False) \
                and (got["cluster"], cycles) != (102, 50_030):
            raise AssertionError(f"17 bfs edge: {got['cluster']} launches, "
                                 f"{cycles} cycles, not 102 and 50,030")
        streams.append(dict(app=app, sampling=sampling, allocator=alloc,
                            traced=traced, cycles=cycles,
                            launches=got["cluster"], wall_s=wall,
                            per_increment=[r["cycles"] for r in rows]))
        print(f"[17] {app} {sampling} {alloc}{' traced' if traced else ''}: "
              f"{cycles} cycles in {got['cluster']} launches (cluster "
              f"kernel), wall {wall:.4f}s (host clock, the engine's set-up "
              f"included, ends in synchronize; "
              f"{1e3 * wall / got['cluster']:.4f} ms a launch); "
              + ("BFS == oracle" if app == "bfs" else "values all 1e9")
              + ("; every increment's totals == the untraced run's, one "
                 "trace row a cycle" if traced else "")
              + f" (stream generated in {gen_s:.1f}s)", flush=True)
    launches = dict(ops.path_launches)
    tables = dict(
        fig8_9={s: pe.bench_cycles_per_increment("paper", s)[0]
                for s in ("edge", "snowball")},
        table2=pe.bench_energy("paper"),
        fig5=pe.bench_allocator("paper"),
        fig6_7=pe.bench_activation("paper", "edge"))
    if dict(ops.path_launches) != launches:
        raise AssertionError("17: the tables ran streams of their own")
    for name, rows in tables.items():
        print(f"[17] {name}: {json.dumps(rows)}", flush=True)
    print(f"[17] done in {time.time() - t_all:.1f}s: {launches['cluster']} "
          f"launches, all on the cluster kernel", flush=True)
    return dict(streams=streams, tables=tables, launches=launches)


def ci_stream(run: dict) -> tuple[list, object, np.ndarray, np.ndarray]:
    """One stream of the ci fingerprint through the engine on the card:
    (per-increment totals, engine, active, in-flight traces)."""
    ci = pe.SCALES["ci"]
    eng = pe._engine(ci["n_vertices"], run["app"], run["allocator"],
                     n_edges=ci["n_edges"])
    rows, act, flt = [], [], []
    for e in pe.stream_increments(run["sampling"], "ci"):
        r = eng.run_increment(e, max_cycles=2_000_000,
                              collect_traces=run["traced"])
        rows.append(dict(edges=len(e), cycles=r.cycles, hops=r.hops,
                         execs=r.execs, stalls=r.stalls, allocs=r.allocs))
        act.append(r.active_per_cycle)
        flt.append(r.in_flight_per_cycle)
    return rows, eng, np.concatenate(act), np.concatenate(flt)


def replay_phases() -> dict:
    """Phase 18: the ci fingerprint recorded from the JAX engine, and the
    ``engine_ci`` / ``engine_mid`` counters of results/bench_engine.json,
    exactly."""
    t0 = time.time()
    fp = json.loads((ROOT / "src" / "repro_torch" / "data"
                     / "paper_ci_fingerprint.json").read_text())
    before = dict(ops.path_launches)
    for run in fp["streams"]:
        rows, eng, act, flt = ci_stream(run)
        cfg = dataclasses.asdict(eng.cfg)
        want_cfg = {k: v for k, v in run["cfg"].items() if k in cfg}
        name = f"{run['app']} {run['sampling']} {run['allocator']}"
        if cfg != want_cfg or rows != run["increments"]:
            raise AssertionError(f"18 {name}: {rows} != {run['increments']}")
        if not (eng.values() == np.float32(run["values"])).all():
            raise AssertionError(f"18 {name}: values differ")
        if eng.vertex_object_stats() != run["vertex_object_stats"]:
            raise AssertionError(f"18 {name}: vertex_object_stats differ")
        if run["traced"] and not (
                act.tolist() == run["active_per_cycle"]
                and flt.tolist() == run["in_flight_per_cycle"]):
            raise AssertionError(f"18 {name}: traces differ")
        print(f"[18] ci fingerprint {name}"
              f"{' traced' if run['traced'] else ''}: "
              f"{sum(r['cycles'] for r in rows)} cycles, counters, values, "
              f"vertex_object_stats{', every trace row' if run['traced'] else ''}"
              f" == the JAX engine's", flush=True)
    bench = json.loads((ROOT / "results" / "bench_engine.json").read_text())
    engine = {}
    for scale in ("ci", "mid"):
        got = pe.bench_engine(scale)
        want = bench[f"engine_{scale}"]["backends"]["jnp"]
        keys = ("cycles", "execs", "hops", "total_cycles")
        if {k: got[k] for k in keys} != {k: want[k] for k in keys}:
            raise AssertionError(f"18 engine_{scale}: {got} != {want}")
        engine[scale] = got
        print(f"[18] engine_{scale} ({got['grid']}): cycles {got['cycles']}, "
              f"execs {got['execs']}, hops {got['hops']}, total cycles "
              f"{got['total_cycles']} == results/bench_engine.json; wall "
              f"{got['wall_s']:.4f}s for the second increment "
              f"({got['cell_cycles_per_s']:.4g} cell-cycles/s)", flush=True)
    got = {p: ops.path_launches[p] - before[p] for p in ops.PATHS}
    if got["block"] or not got["cluster"]:
        raise AssertionError(f"18: launches {got}")
    print(f"[18] done in {time.time() - t0:.1f}s", flush=True)
    return engine


def print_ptxas(report: str) -> None:
    for line in report.splitlines():
        if any(w in line for w in ("registers", "spill", "smem", "stack")):
            print("  ptxas:", line.strip())


def bag_ptxas(lib: str, report: str) -> None:
    """Phase 7: the EmbeddingBag kernel's instantiations, its shape at RM2
    (``bag_tile_kernel<16, 4, 4>``) line by line and the worst spill of
    the rest."""
    funcs = _build.ptxas_functions(report)
    rm2 = [i for n, i in funcs.items() if "bag_tile_kernelILi16ELi4ELi4E" in n]
    worst = max(funcs.values(), key=lambda i: i.get("spill_stores", 0))
    print(f"[7] {lib}: {len(funcs)} kernels; at RM2 (16 lanes x float4, "
          f"L = 4): {rm2}; the most spill of any: {worst}", flush=True)


FLASH_KERNELS = {"fa_fwd_tc": ("tensor_core", "bf16"),
                 "fa_fwd_tf32": ("tensor_core_tf32x3", "f32")}


def flash_ptxas(report: str) -> list[dict]:
    """Phase 12: one row a flash-attention instantiation (its path, head
    width and dtype read from the mangled name), printed; raises if a
    tensor-core kernel (bf16, or f32 as 3xTF32) spills at dh 64 or 128."""
    rows = []
    for name, info in _build.ptxas_functions(report).items():
        m = re.search(r"(fa_fwd_tc|fa_fwd_tf32)ILi(\d+)E", name)
        if not m:
            continue
        path, dtype = FLASH_KERNELS[m[1]]
        row = dict(path=path, dtype=dtype, dh=int(m[2]), **info)
        rows.append(row)
        print(f"[12] {row['path']} {row['dtype']} dh={row['dh']}: "
              f"{info.get('registers')} registers at entry, "
              f"{info.get('spill_stores')} bytes spill stores, "
              f"{info.get('spill_loads')} bytes spill loads, "
              f"{info.get('stack')} bytes stack, static smem "
              f"{info.get('smem', 0)} bytes", flush=True)
    for path in ("tensor_core", "tensor_core_tf32x3"):
        tc = {r["dh"]: r for r in rows if r["path"] == path}
        for dh in (64, 128):
            if dh not in tc or tc[dh].get("spill_stores", 1) or tc[dh].get(
                    "spill_loads", 1):
                raise AssertionError(f"{path} flash kernel at dh {dh}: "
                                     f"spills or no report ({tc.get(dh)})")
    return rows


def cuda_ms(fn, min_reps=3, budget_ms=300.0) -> float:
    """Mean device time of ``fn()`` in ms by CUDA events: one warm call,
    then as many calls as fit in ``budget_ms`` (at least ``min_reps``)."""
    fn()
    a, b = (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))
    a.record()
    fn()
    b.record()
    torch.cuda.synchronize()
    reps = max(min_reps, min(200, int(budget_ms / max(a.elapsed_time(b),
                                                      1e-3))))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def graph_ms(fn, reps=100) -> float:
    """Device time of ``fn``'s launches in ms: a CUDA graph of one call,
    captured after a warm call, replayed ``reps`` times between two
    events (so the host's call rate does not count)."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    g.replay()
    a, b = (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))
    a.record()
    for _ in range(reps):
        g.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def same_bits(got, want) -> bool:
    """Equal as f32 bits, NaN in the same places."""
    nan = torch.isnan(want)
    return torch.equal(torch.isnan(got), nan) and torch.equal(
        got.view(torch.int32)[~nan], want.view(torch.int32)[~nan])


def check(name, got, want, tol) -> float:
    """Max |got - want|; raises unless it is at most tol x max(1, max
    |want|) and NaN sits in the same places."""
    got, want = got.float(), want.float()
    if not torch.equal(torch.isnan(got), torch.isnan(want)):
        raise AssertionError(f"{name}: NaN in different places")
    err = float((got - want).abs().nan_to_num(0.0).max())
    scale = max(1.0, float(want.nan_to_num(0.0).abs().max()))
    if err > tol * scale:
        raise AssertionError(f"{name}: max |d| {err} > {tol} x {scale}")
    return err


def scaled_err(got, want) -> tuple[float, float]:
    """(max |got - want|, the largest |got - want| / (|want| + median
    |want|) over the entries): elementwise, an entry near 0 held to the
    output's typical size rather than to its largest."""
    got, want = got.double(), want.double()
    if got.shape != want.shape:
        raise AssertionError(f"shape {got.shape} != {want.shape}")
    d = (got - want).abs()
    tol = want.abs() + float(want.abs().median())
    return float(d.max()), float(torch.where(d == 0, 0.0, d / tol).max())


def check_close(name, got, want, rtol) -> tuple[float, float]:
    """``scaled_err``, raising unless the scaled error is at most rtol."""
    err, rel = scaled_err(got, want)
    if not rel <= rtol:
        raise AssertionError(f"{name}: an entry is off by {rel:.3g} of "
                             f"|ref| + median |ref| (limit {rtol}; max |d| "
                             f"{err})")
    return err, rel


def f64_forward(cfg, params, g):
    """GraphCast's ``gnn_forward`` on the CPU in float64, its segment sums
    too (the port's sums run in f32, as the kernel's do).  Its MLPs run in
    the activations' dtype and it has no layer norm, so nothing else
    rounds to f32; a built graph's destinations are all in range, so a
    plain ``index_add_`` sums them."""
    assert cfg.kind == "graphcast"

    def sum64(msgs, edge_index, n_nodes, rowptr=None):
        out = torch.zeros((n_nodes, *msgs.shape[1:]), dtype=msgs.dtype)
        return out.index_add_(0, edge_index[1].long(), msgs)

    with mock.patch.object(gnn, "scatter_sum", sum64):
        return gnn.gnn_forward(
            dataclasses.replace(cfg, compute_dtype=torch.float64), params, g)


def vs_cpu(arch, cfg, params, g, out) -> tuple[dict, str]:
    """Hold the card's forward ``out`` to the CPU's, elementwise: within
    1e-4 of |ref| + median |ref|.  GraphCast's 16 unnormalised residual
    blocks reach 1e10 at random init, and its f32 function is then no
    more accurate than that allows, on any device: it is held to its f64
    forward instead, no farther from it than 1e-4 or twice the CPU's f32
    forward, whichever is more."""
    cpu_p, cpu_g = to_cpu(params), gnn.Graph(*to_cpu(tuple(g)))
    want = gnn.gnn_forward(cfg, cpu_p, cpu_g)
    if arch != "graphcast":
        err, rel = check_close(f"{arch} vs CPU", out.cpu(), want, 1e-4)
        return (dict(vs_cpu_max_abs_err=err, vs_cpu_scaled_err=rel),
                f"== CPU forward elementwise (scaled error {rel:.3g} <= "
                f"1e-4; max |d| {err:.3g})")
    err, rel = scaled_err(out.cpu(), want)
    want64 = f64_forward(cfg, cpu_p, cpu_g)
    _, card64 = scaled_err(out.cpu(), want64)
    _, cpu64 = scaled_err(want, want64)
    limit = max(1e-4, 2 * cpu64)
    if not card64 <= limit:
        raise AssertionError(f"graphcast: the card is off its f64 forward "
                             f"by {card64:.3g}, the CPU's f32 forward by "
                             f"{cpu64:.3g} (limit {limit:.3g})")
    return (dict(vs_cpu_max_abs_err=err, vs_cpu_scaled_err=rel,
                 vs_f64_scaled_err=card64, cpu_vs_f64_scaled_err=cpu64),
            f"off the f64 forward by {card64:.3g} (scaled), the CPU's f32 "
            f"forward by {cpu64:.3g} (limit max(1e-4, 2x that)); card vs "
            f"CPU f32 {rel:.3g} (max |d| {err:.3g} on max |ref| "
            f"{float(want.abs().max()):.4g})")


def forward_wall(fn, reps) -> tuple[float, int, int, object]:
    """(mean host seconds per call, each ending in synchronize; peak bytes
    allocated during the calls, resident inputs included; that peak less
    what was resident before the calls; the last output), after one warm
    call."""
    out = fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    t0 = time.time()
    for _ in range(reps):
        out = fn()
        torch.cuda.synchronize()
    wall = (time.time() - t0) / reps
    peak = torch.cuda.max_memory_allocated()
    return wall, peak, peak - resident, out


def to_cpu(tree):
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_cpu(v) for v in tree)
    return None if tree is None else tree.cpu()


def spmm_phases(smi: str, dev: torch.device) -> dict:
    """Phases 8 and 9: the scatter-SpMM kernel against its plain version
    and the library call, then the GNN serving forwards through it."""
    shapes = {s.name: s for s in gnn_shapes()}
    gen = torch.Generator(device=dev)

    # ---- 8. kernel vs plain at the main path's shapes ----
    t0 = time.time()
    d_feat = shapes["full_graph_sm"].dim("d_feat")   # d_in, as launch/steps
    cora_cfg = dataclasses.replace(gnn_archs.GCN_CORA, d_in=d_feat)
    ogb_cfg = dataclasses.replace(cora_cfg, d_in=shapes["ogb_products"].dim(
        "d_feat"))
    g_cora = build_graph(cora_cfg, shapes["full_graph_sm"], device=dev)
    g_ogb = build_graph(ogb_cfg, shapes["ogb_products"], device=dev)
    gc_cfg = dataclasses.replace(gnn_archs.GRAPHCAST, d_in=d_feat)
    g_gc = build_graph(gc_cfg, shapes["full_graph_sm"], device=dev)
    torch.cuda.synchronize()
    print(f"[8] graphs built in {time.time() - t0:.1f}s: full_graph_sm "
          f"{g_cora.edge_index.shape[1]} edges, ogb_products "
          f"{g_ogb.edge_index.shape[1]} edges, multimesh "
          f"{g_gc.mesh_edge_index.shape[1]} edges", flush=True)
    rows, worst = [], 0.0
    # (shape, edge set, D, gather): every aggregation shape of phase 9's
    # forwards: gcn's two layers (gather and coeff fused), gatedgcn's and
    # meshgraphnet's edge messages, graphcast's three edge sets
    cases = [("full_graph_sm", g_cora, "edge_index", 16, True),
             ("full_graph_sm", g_cora, "edge_index", 7, True),
             ("full_graph_sm", g_cora, "edge_index", 70, False),
             ("full_graph_sm", g_cora, "edge_index", 128, False),
             ("ogb_products", g_ogb, "edge_index", 16, True),
             ("ogb_products", g_ogb, "edge_index", 7, True),
             ("multimesh_r6", g_gc, "mesh_edge_index", 512, False),
             ("grid2mesh", g_gc, "g2m_edge_index", 512, False),
             ("mesh2grid", g_gc, "m2g_edge_index", 512, False)]
    for name, g, key, D, gather in cases:
        gen.manual_seed(D)
        ei, rowptr = getattr(g, key), g.rowptr[key]   # built once per graph
        n, E = rowptr.shape[0] - 1, ei.shape[1]
        src, dst = ei[0].contiguous(), ei[1].contiguous()
        if gather:                     # spmm_sorted_coo, GCN layer shape
            x = torch.randn((n, D), generator=gen, device=dev)
            coeff = sym_norm_coeff(ei, n)
            wrapper = lambda: spmm_ops.spmm_sorted_coo(  # noqa: E731
                x, src, dst, n, coeff, rowptr)
            plain = lambda: spmm_sorted_coo_ref(  # noqa: E731
                x, src, dst, n, coeff)
            # the library's CSR: columns sorted within each row
            o = torch.argsort(dst.long() * n + src.long())
            col, vals, dense, n_in = src[o], coeff[o], x, n
            # src, coeff, rowptr, x, out; a multiply and an add an entry
            nbytes, nops = E * 8 + (n + 1) * 4 + n * D * 8, 2 * E * D
            # the gather floor: the 32-byte sectors of x each edge's row
            # touches, none found in L2, beside src, coeff, rowptr and out
            first = src.long() * D * 4
            sectors = int(((first + D * 4 - 1) // 32 - first // 32 + 1).sum())
            floor_bytes = 32 * sectors + nbytes - n * D * 4
            del first
        else:                          # scatter_spmm of edge messages
            msgs = torch.randn((E, D), generator=gen, device=dev)
            src = coeff = None
            wrapper = lambda: spmm_ops.scatter_spmm(  # noqa: E731
                msgs, dst, n, rowptr)
            plain = lambda: scatter_spmm_ref(msgs, dst, n)  # noqa: E731
            col = torch.arange(E, dtype=torch.int32, device=dev)
            vals = torch.ones(E, device=dev)
            dense, n_in = msgs, E
            # msgs, rowptr, out; an add an entry
            nbytes, nops = E * D * 4 + (n + 1) * 4 + n * D * 4, E * D
            floor_bytes = nbytes     # the messages stream in order
        # the kernel alone, over the graph's row pointers, in the warp
        # shape the wrapper picks, and in the wide shape (lanes over the
        # columns, the kernel's only shape before the narrow ones) for the
        # old kernel's time
        shape = spmm_ops.geometry(D, dense.data_ptr() % 16 == 0)
        kern = lambda: spmm_ops.launch(  # noqa: E731
            dense, src, coeff, rowptr, n)
        old = lambda: spmm_ops.launch(  # noqa: E731
            dense, src, coeff, rowptr, n, shape=spmm_ops.WIDE)
        with warnings.catch_warnings():   # "sparse CSR is in beta", ...
            warnings.simplefilter("ignore", UserWarning)
            csr = torch.sparse_csr_tensor(rowptr, col, vals, size=(n, n_in))
        got, want = wrapper(), plain()
        torch.cuda.synchronize()
        err = check(f"spmm {name} D={D}", got, want, 1e-4)
        if not torch.equal(kern(), got):
            raise AssertionError("a second launch gave other bits")
        # the kernel's own order of sums, in plain PyTorch: the same bits
        if not torch.equal(got, spmm_ordered(dense, src, dst, n, coeff,
                                             32 // shape[0])):
            raise AssertionError(f"spmm {name} D={D}: not the bits of its "
                                 f"order ({shape})")
        old_err = check(f"spmm wide shape {name} D={D}", old(), want, 1e-4)
        # twice old, new, new, old: the small shapes are host-bound, and
        # their times spread by some 10% from one turn to the next
        turns = {"old": [], "new": []}
        for which in ("old", "new", "new", "old") * 2:
            turns[which].append(cuda_ms(kern if which == "new" else old))
        lib_err = check(f"torch.sparse.mm {name} D={D}",
                        torch.sparse.mm(csr, dense), want, 1e-4)
        worst = max(worst, err)
        bytes_ms = 1e3 * nbytes / H100_BYTES_PER_S
        ops_ms = 1e3 * nops / H100_F32_FLOPS
        floor_ms = 1e3 * floor_bytes / H100_BYTES_PER_S
        row = dict(shape=name, D=D, nodes=n, edges=E, gather=gather,
                   geometry=list(shape), max_abs_err=err,
                   ms=float(np.mean(turns["new"])), ms_turns=turns["new"],
                   old_ms=float(np.mean(turns["old"])),
                   old_ms_turns=turns["old"], old_max_abs_err=old_err,
                   equal_to_ordered=True,
                   wrapper_ms=cuda_ms(wrapper),
                   row_pointers_ms=cuda_ms(
                       lambda: spmm_ops.row_pointers(dst, n)),
                   plain_ms=cuda_ms(plain),
                   library_ms=cuda_ms(lambda: torch.sparse.mm(csr, dense)),
                   bound_ms=max(bytes_ms, ops_ms),
                   bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                   bytes=nbytes, ops=nops, library_max_abs_err=lib_err)
        rows.append(row)
        print(f"[8] spmm {name} D={D} ({n} nodes, {E} edges, "
              f"{'gather x coeff' if gather else 'messages'}): kernel "
              f"(lanes, vec) = {shape} "
              f"{' / '.join(f'{t:.4f}' for t in turns['new'])} ms, the old "
              f"wide shape in turns "
              f"{' / '.join(f'{t:.4f}' for t in turns['old'])} ms "
              f"({row['old_ms'] / row['ms']:.2f}x); bits == its ordered "
              f"sum; gather floor {floor_ms:.4f} ms ({floor_bytes / 1e9:.4f} "
              f"GB of sectors and streams over 3.35 TB/s) (wrapper over the "
              f"row pointers "
              f"{row['wrapper_ms']:.4f} ms; building them, once per graph, "
              f"{row['row_pointers_ms']:.4f} ms), plain "
              f"{row['plain_ms']:.4f} ms, torch.sparse.mm "
              f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
              f"by {row['bound_by']} ({nbytes / 1e9:.4f} GB over 3.35 TB/s,"
              f" {nops / 1e9:.4f} Gflop over 67 TFLOP/s); max |d| "
              f"{err:.3g}", flush=True)
        del got, want, csr, col, vals
    print(f"[8] done in {time.time() - t0:.1f}s", flush=True)

    # ---- 9. GNN serving on the card at published widths ----
    t0 = time.time()
    runs = [("gcn-cora", cora_cfg, g_cora, 2),
            ("gcn-cora", ogb_cfg, g_ogb, 2),
            ("gatedgcn", dataclasses.replace(gnn_archs.GATEDGCN,
                                             d_in=d_feat), g_cora, 32),
            ("meshgraphnet", dataclasses.replace(gnn_archs.MESHGRAPHNET,
                                                 d_in=d_feat), g_cora, 15),
            ("graphcast", gc_cfg, g_gc, 18)]
    spmm_ops.launches = 0
    serving = []
    for i, (arch, cfg, g, per_fwd) in enumerate(runs):
        shape_name = "ogb_products" if g is g_ogb else "full_graph_sm"
        params = gnn.init_gnn_params(cfg, gen.manual_seed(100 + i))
        before = spmm_ops.launches
        with torch.no_grad():
            out = gnn.gnn_forward(cfg, params, g)
            torch.cuda.synchronize()
            if spmm_ops.launches - before != per_fwd:
                raise AssertionError(f"{arch}: {spmm_ops.launches - before} "
                                     f"spmm launches, expected {per_fwd}")
            if not bool(torch.isfinite(out).all()):
                raise AssertionError(f"{arch} {shape_name}: non-finite")
            cpu, note = {}, ""
            if g is not g_ogb:
                tc = time.time()
                cpu, note = vs_cpu(arch, cfg, params, g, out)
                note = f"; {note}; CPU {time.time() - tc:.1f}s"
            reps = 3 if g is g_ogb or arch == "graphcast" else 10
            wall, peak, peak_fwd, _ = forward_wall(
                lambda: gnn.gnn_forward(cfg, params, g), reps)
        serving.append(dict(arch=arch, shape=shape_name, wall_s=wall,
                            peak_bytes=peak, peak_forward_bytes=peak_fwd,
                            spmm_launches=per_fwd, out=list(out.shape),
                            **cpu))
        print(f"[9] {arch} on {shape_name}: out {list(out.shape)} finite; "
              f"{per_fwd} spmm launches per forward; wall "
              f"{1e3 * wall:.3f} ms per forward (host clock, ends in "
              f"synchronize, mean of {reps}); peak {peak / 2**20:.1f} MiB "
              f"({peak_fwd / 2**20:.1f} MiB above the resident graphs)"
              f"{note}", flush=True)
        del params, out
    launches = spmm_ops.launches
    if launches == 0:
        raise AssertionError("the GNN path launched no spmm kernel")
    print(f"[9] done in {time.time() - t0:.1f}s: {launches} spmm launches",
          flush=True)
    head = next(r for r in rows if r["shape"] == "ogb_products"
                and r["D"] == 16)      # GCN layer 1
    return {"name": "scatter_spmm", "route": "cuda",
            "source": "src/repro_torch/kernels/spmm/csrc/spmm.cu",
            "replaces": "src/repro/kernels/spmm/kernel.py:51",
            "replaces_wrapper": "repro/kernels/spmm/ops.py::spmm_sorted_coo",
            "launches": launches, "equal_to_plain": True,
            "geometry": head["geometry"], "old_ms": head["old_ms"],
            "max_abs_err": worst, "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "library": "torch.sparse.mm (CSR)",
            "headline_shape": "ogb_products D=16", "shapes": rows,
            "serving": serving, "card": smi}


def dlrm_phases(smi: str, dev: torch.device) -> dict:
    """Phases 10 and 11: the EmbeddingBag kernel against its plain version
    and the library call on the full RM2 tables, then DLRM serving."""
    cfg = DLRM_RM2
    shapes = {s.name: s for s in recsys_shapes()}
    gen = torch.Generator(device=dev).manual_seed(7)

    # ---- 10. kernel vs plain at RM2 widths, on the full tables ----
    t0 = time.time()
    torch.cuda.reset_peak_memory_stats()
    params = dlrm.prepare_dlrm_params(dlrm.init_dlrm_params(cfg, gen))
    tables = params["tables"]          # checked once: a BagTables
    torch.cuda.synchronize()
    table_bytes = sum(t.numel() * 4 for t in tables)
    print(f"[10] {len(tables)} tables, {sum(t.shape[0] for t in tables)} "
          f"rows x {cfg.embed_dim} f32 = {table_bytes / 1e9:.2f} GB drawn "
          f"on the card in {time.time() - t0:.3f}s", flush=True)

    def batch(name):
        b = recsys_batch(RecSysBatchSpec(
            shapes[name].dim("batch"), cfg.n_dense, cfg.n_sparse,
            cfg.lookups_per_field, cfg.resolved_vocabs()), 0)
        return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}

    batches = {name: batch(name) for name in ("serve_p99", "serve_bulk")}
    rows, worst = [], 0.0
    for name, b in batches.items():
        idx = b["sparse"]
        B, Fn, L = idx.shape
        kern = lambda: bag_ops.embedding_bags(tables, idx)  # noqa: E731
        plain = lambda: embedding_bags_ref(tables, idx)  # noqa: E731
        fields = [idx[:, f].long() for f in range(Fn)]

        def library():
            return [F.embedding_bag(fields[f], t, mode="sum")
                    for f, t in enumerate(tables)]

        before = dict(bag_ops.shape_launches)
        got, want = kern(), plain()
        shape = [g for g, n in bag_ops.shape_launches.items()
                 if n != before.get(g, 0)]
        if len(shape) != 1:
            raise AssertionError(f"bag {name}: launches on {shape}")
        shape = shape[0]
        err = check(f"embedding bag {name}", got, want, 1e-5)
        # the kernel's own order of sums, in plain PyTorch: the same bits
        if not same_bits(got, embedding_bags_ordered(tables, idx)):
            raise AssertionError(f"embedding bag {name}: not the bits of "
                                 f"its ordered sum ({shape})")
        check(f"F.embedding_bag {name}", torch.stack(library(), 1), want,
              1e-5)
        worst = max(worst, err)
        # the bound counts each distinct row once; the gather floor every
        # lookup into a table larger than the L2 (no reuse found there)
        distinct = floor_rows = 0
        for f, t in zip(fields, tables):
            n = int(torch.unique(f).numel())
            distinct += n
            floor_rows += f.numel() if t.numel() * 4 > H100_L2_BYTES else n
        row_bytes = cfg.embed_dim * 4
        nbytes = idx.numel() * 4 + distinct * row_bytes + got.numel() * 4
        floor_bytes = nbytes + (floor_rows - distinct) * row_bytes
        nops = idx.numel() * cfg.embed_dim       # an add a gathered entry
        bytes_ms = 1e3 * nbytes / H100_BYTES_PER_S
        ops_ms = 1e3 * nops / H100_F32_FLOPS
        row = dict(shape=name, B=B, F=Fn, L=L, D=cfg.embed_dim,
                   geometry=list(shape), distinct_rows=distinct,
                   max_abs_err=err, equal_to_ordered=True,
                   ms=cuda_ms(kern), graph_ms=graph_ms(kern),
                   plain_ms=cuda_ms(plain), library_ms=cuda_ms(library),
                   bound_ms=max(bytes_ms, ops_ms),
                   bound_by="bytes" if bytes_ms >= ops_ms else "operations")
        floor_ms = 1e3 * floor_bytes / H100_BYTES_PER_S
        share = row["bound_ms"] / row["ms"]
        rows.append(row)
        print(f"[10] embedding bag {name} (B={B}, F={Fn}, L={L}, D="
              f"{cfg.embed_dim}; {distinct} distinct rows): kernel "
              f"(lanes, vec, lt, rounds) = {tuple(shape)}, "
              f"{shape.bags} bags a warp; {row['ms']:.4f} ms by the call "
              f"rate, {row['graph_ms']:.4f} ms of device time (a CUDA "
              f"graph of the launch replayed); bits == its ordered sum; "
              f"plain {row['plain_ms']:.4f} ms, F.embedding_bag x{Fn} "
              f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
              f"by {row['bound_by']} ({nbytes / 1e9:.4f} GB over 3.35 TB/s, "
              f"{nops / 1e9:.4f} Gflop over 67 TFLOP/s; "
              f"{100 * share:.1f}% of the kernel's time), "
              f"gather floor {floor_ms:.4f} ms "
              f"({floor_bytes / 1e9:.4f} GB: every lookup into a table "
              f"above the 50 MB L2 from memory); max |d| {err:.3g}",
              flush=True)
        del got, want
    print(f"[10] done in {time.time() - t0:.1f}s", flush=True)

    # ---- 11. DLRM-RM2 serving at full width ----
    t0 = time.time()
    gen.manual_seed(8)
    cand = torch.randn((shapes["retrieval_cand"].dim("n_candidates"),
                        cfg.embed_dim), generator=gen, device=dev)
    q = batch("serve_p99")
    query = dict(dense=q["dense"][:1], sparse=q["sparse"][:1].contiguous(),
                 candidates=cand)
    bag_ops.launches = 0
    bag_ops.shape_launches.clear()
    serving = []
    with torch.no_grad():
        for name, fn, reps in (
                ("serve_p99",
                 lambda: dlrm.dlrm_forward(cfg, params, batches["serve_p99"]),
                 20),
                ("serve_bulk",
                 lambda: dlrm.dlrm_forward(cfg, params,
                                           batches["serve_bulk"]), 5),
                ("retrieval_cand",
                 lambda: dlrm.retrieval_score(cfg, params, query), 10)):
            before = bag_ops.launches
            wall, peak, peak_fwd, out = forward_wall(fn, reps)
            per_fwd = (bag_ops.launches - before) / (reps + 1)
            if per_fwd < 1:
                raise AssertionError(f"{name}: no EmbeddingBag launch")
            if name == "retrieval_cand":
                scores, ids = out
                assert scores.shape == ids.shape == (1, 100)
                ok = bool(torch.isfinite(scores).all())
            else:
                assert out.shape == (batches[name]["dense"].shape[0],)
                ok = bool(torch.isfinite(out).all())
            if not ok:
                raise AssertionError(f"{name}: non-finite output")
            serving.append(dict(shape=name, wall_s=wall, peak_bytes=peak,
                                peak_forward_bytes=peak_fwd,
                                launches_per_forward=per_fwd))
            shp = [list(o.shape) for o in out] \
                if name == "retrieval_cand" else list(out.shape)
            print(f"[11] {name}: out {shp} finite; {per_fwd:g} "
                  f"EmbeddingBag launches per forward; "
                  f"wall {1e3 * wall:.3f} ms per forward (host clock, ends "
                  f"in synchronize, mean of {reps}); peak "
                  f"{peak / 2**30:.2f} GiB allocated "
                  f"({peak_fwd / 2**20:.1f} MiB above the resident tables "
                  f"and batches)", flush=True)
        launches = bag_ops.launches
        by_shape = dict(bag_ops.shape_launches)
        main_shape = bag_ops.geometry(cfg.embed_dim, cfg.lookups_per_field)
        if by_shape != {main_shape: launches}:
            raise AssertionError(f"main-path bag launches by shape "
                                 f"{by_shape}, not all on {main_shape}")
        # the same forwards on the CPU over the rows the batch touches
        sub = cpu_subtables(tables, q["sparse"])
        cpu_params = dict(tables=sub[0], bot=to_cpu(params["bot"]),
                          top=to_cpu(params["top"]))
        want = dlrm.dlrm_forward(cfg, cpu_params, dict(
            dense=q["dense"].cpu(), sparse=sub[1]))
        got = dlrm.dlrm_forward(cfg, params, q)
        err, used = check_close("serve_p99 logits vs CPU", got.cpu(), want,
                                1e-4)
        w_scores, w_ids = dlrm.retrieval_score(cfg, cpu_params, dict(
            dense=q["dense"][:1].cpu(), sparse=sub[1][:1].contiguous(),
            candidates=cand.cpu()))
        g_scores, g_ids = dlrm.retrieval_score(cfg, params, query)
        s_err, s_used = check_close("retrieval scores vs CPU",
                                    g_scores.cpu(), w_scores, 1e-4)
        same_ids = float((g_ids.cpu() == w_ids).float().mean())
        if same_ids < 0.95:
            raise AssertionError(f"retrieval ids agree on {same_ids:.2%}")
    print(f"[11] serve_p99 logits == CPU forward over the touched rows, "
          f"elementwise (scaled error {used:.3g} <= 1e-4; max |d| "
          f"{err:.3g}); retrieval top-100 scores == CPU (scaled error "
          f"{s_used:.3g}; max |d| {s_err:.3g}), ids equal on "
          f"{same_ids:.0%}; {launches} bag launches, all in the shape "
          f"{tuple(main_shape)}; done in {time.time() - t0:.1f}s",
          flush=True)
    del params, tables, cand, batches
    torch.cuda.empty_cache()
    head, p99 = rows[1], rows[0]      # serve_bulk, serve_p99
    return {"name": "embedding_bag_fwd", "route": "cuda",
            "source": "src/repro_torch/kernels/embedding_bag/csrc/"
                      "embedding_bag.cu",
            "replaces": "src/repro/kernels/embedding_bag/kernel.py:38",
            "launches": launches, "launches_by_shape": {
                str(tuple(k)): v for k, v in by_shape.items()},
            "equal_to_plain": True, "equal_to_ordered": True,
            "geometry": head["geometry"],
            "graph_ms": head["graph_ms"], "p99_ms": p99["ms"],
            "p99_graph_ms": p99["graph_ms"],
            "max_abs_err": worst, "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "library": "torch.nn.functional.embedding_bag, one call per "
                       "table (26)",
            "headline_shape": "serve_bulk", "shapes": rows,
            "serving": serving, "table_bytes": table_bytes, "card": smi}


def cpu_subtables(tables, sparse):
    """The rows of each table that ``sparse`` [B, F, L] touches, on the
    CPU, and the indices renumbered into them."""
    subs, idx = [], []
    for f, t in enumerate(tables):
        rows, inv = torch.unique(sparse[:, f], return_inverse=True)
        subs.append(t[rows.long()].cpu())
        idx.append(inv.to(torch.int32).cpu())
    return subs, torch.stack(idx, 1).contiguous()


FLASH_SHAPES = [   # (config, B, T, H, Kh, dh): the dense LMs' attention
    ("llama3.2-1b", 1, 4096, 32, 8, 64),
    ("qwen3-1.7b", 1, 4096, 16, 8, 128),
    ("starcoder2-3b", 1, 4096, 24, 2, 128)]
FLASH_TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}


def flash_excess(got, want, dtype) -> tuple[float, float]:
    """(max |got - want|, the largest |got - want| over its limit), entry
    by entry; above 1 fails.  The limit is tol x (|want| + a): in f32 a = 1,
    as ``tests/test_kernels.py`` holds the Pallas kernel (the 3xTF32
    kernel's split operands and order of sums put it a few 1e-6 off,
    whatever the entry's size; one TF32 product would be ~40-90x the
    limit, ``tests/test_torch_flash_tf32.py``); in bf16
    a = median |want|, as the two differ by the output's one rounding (at
    most 2^-7 |want|) and a row t averages some t / e keys, so at
    T = 32768 a typical |out| is ~0.01 while the first rows reach 3 to 4:
    a limit scaled by the largest |want| would pass a wrong kernel."""
    d = (got.double() - want.double()).abs()
    w = want.double().abs()
    a = float(w.median()) if dtype == torch.bfloat16 else 1.0
    return float(d.max()), float((d / (FLASH_TOL[dtype] * (w + a))).max())


def flash_bound(B, T, H, Kh, dh, dtype) -> tuple[float, str, int, int]:
    """(bound ms, what bounds it, bytes, flops) of a causal forward: q, k
    and v read once, o written once; 4 dh flops a head and (row, col <=
    row) pair, over the best rate at which the card reaches the inputs'
    accuracy: the bf16 tensor cores, or for f32 three TF32 tensor-core
    products (165 TFLOP/s; the CUDA cores' 67 are printed beside it)."""
    nbytes = 2 * B * T * (H + Kh) * dh * (torch.finfo(dtype).bits // 8)
    flops = 4 * B * H * dh * (T * (T + 1) // 2)
    peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_F32_TC_FLOPS
    bytes_ms, ops_ms = 1e3 * nbytes / H100_BYTES_PER_S, 1e3 * flops / peak
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations", nbytes, flops)


def banded_ref(q, k, v, window):
    """The plain version with each row's keys more than ``window`` back
    masked too: a planted fault, a kernel that drops the far keys of the
    late rows (rows within ``window`` of the start are unchanged)."""
    B, T, H, dh = q.shape
    G = H // k.shape[2]
    qf = (q.float() * (1.0 / dh ** 0.5)).reshape(B, T, -1, G, dh)
    s = torch.einsum("btkgd,bskd->bkgts", qf, k.float())
    rows = torch.arange(T, device=q.device)[:, None]
    cols = torch.arange(T, device=q.device)[None, :]
    s = s.masked_fill((cols > rows) | (cols <= rows - window), -1e30)
    out = torch.einsum("bkgts,bskd->btkgd", torch.softmax(s, dim=-1),
                       v.float())
    return out.reshape(B, T, H, dh).to(q.dtype)


def flash_case(name, B, T, H, Kh, dh, dtype, gen, dev) -> dict:
    """Phase 13 at one shape: the kernel against its plain version (head
    by head above T = 8192, where the plain score matrix would not fit),
    timed beside them, SDPA and the bound."""
    q = torch.randn((B, T, H, dh), generator=gen, device=dev).to(dtype)
    k, v = (torch.randn((B, T, Kh, dh), generator=gen, device=dev).to(dtype)
            for _ in range(2))
    G = H // Kh
    kern = lambda: fa_ops.flash_attention(q, k, v)  # noqa: E731
    by_head = T > 8192

    def plain_of(q, k, v, fn=flash_attention_ref, *a):
        if not by_head:
            return fn(q, k, v, *a)
        return torch.cat([fn(q[:, :, h:h + 1], k[:, :, h // G:h // G + 1],
                             v[:, :, h // G:h // G + 1], *a)
                          for h in range(H)], dim=2)

    plain = lambda: plain_of(q, k, v)  # noqa: E731
    # the yardstick, on K/V repeated to the query heads beforehand
    qs, ks, vs = (t.transpose(1, 2) for t in (
        q, k.repeat_interleave(G, dim=2), v.repeat_interleave(G, dim=2)))
    library = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qs, ks, vs, is_causal=True).transpose(1, 2)

    def efficient():      # SDPA held to its memory-efficient backend
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return library()
    before = dict(fa_ops.path_launches)
    got, want = kern(), plain()
    torch.cuda.synchronize()
    path = [p for p, n in fa_ops.path_launches.items() if n != before[p]]
    tag = f"flash {name} T={T} {dtype}"
    want_path = ("tensor_core" if dtype == torch.bfloat16
                 else "tensor_core_tf32x3")
    if path != [want_path]:
        raise AssertionError(f"{tag}: launched on {path}, not {want_path}")
    if not torch.equal(torch.isnan(got), torch.isnan(want)):
        raise AssertionError(f"{tag}: NaN in different places")
    err, excess = flash_excess(got, want, dtype)
    if not excess <= 1:
        raise AssertionError(f"{tag}: an entry is off by {excess:.3g} x its "
                             f"limit (max |d| {err})")
    if not torch.equal(kern(), got):
        raise AssertionError("a second launch gave other bits")
    # planted faults the limit must reject: each query head reading the next
    # KV head, and each row past T/2 blind to the keys more than T/2 back
    faults = {"next_kv_head": plain_of(q, k.roll(1, dims=2),
                                       v.roll(1, dims=2)),
              "far_keys_dropped": plain_of(q, k, v, banded_ref, T // 2)}
    fault_excess = {f: flash_excess(out, want, dtype)[1]
                    for f, out in faults.items()}
    # the same faults against a limit scaled by max(1, max |want|)
    top = FLASH_TOL[dtype] * max(1.0, float(want.float().abs().max()))
    fault_max_scaled = {f: float((out.float() - want.float()).abs().max())
                        / top for f, out in faults.items()}
    del faults
    if not min(fault_excess.values()) > 1:
        raise AssertionError(f"{tag}: the limit passes a planted fault "
                             f"({fault_excess})")
    lib_out = library()
    lib_err = check(f"sdpa {name} T={T} {dtype}", lib_out, want, 2e-2)
    # the yardstick's own precision, under the kernel's limit, and the
    # backend the dispatcher picks
    lib_excess = flash_excess(lib_out, want, dtype)[1]
    eff_excess = flash_excess(efficient(), want, dtype)[1]
    backend = sdpa_backend(qs, ks, vs)
    del got, want, lib_out
    bound, by, nbytes, flops = flash_bound(B, T, H, Kh, dh, dtype)
    row = dict(shape=name, B=B, T=T, H=H, Kh=Kh, dh=dh,
               dtype=str(dtype).split(".")[-1], max_abs_err=err,
               excess=excess, fault_excess=fault_excess,
               fault_max_scaled=fault_max_scaled,
               plain_by_head=by_head, ms=cuda_ms(kern),
               plain_ms=cuda_ms(plain, min_reps=1),
               library_ms=cuda_ms(library), bound_ms=bound, bound_by=by,
               bytes=nbytes, flops=flops, library_max_abs_err=lib_err,
               library_excess=lib_excess, sdpa_backend=backend,
               efficient_ms=cuda_ms(efficient), efficient_excess=eff_excess,
               path=want_path)
    if dtype == torch.float32:     # the CUDA cores' bound, named as such
        row["cuda_core_bound_ms"] = 1e3 * flops / H100_F32_FLOPS
    row.update(tflops=flops / row["ms"] / 1e9,
               vs_library=row["ms"] / row["library_ms"],
               bound_share=bound / row["ms"])
    print(f"[13] flash {name} (B={B}, T={T}, H={H}, Kh={Kh}, dh={dh}, "
          f"{row['dtype']}, {want_path}): kernel {row['ms']:.4f} ms "
          f"({row['tflops']:.2f} TFLOP/s, {row['vs_library']:.3f}x SDPA, "
          f"{100 * row['bound_share']:.1f}% of the bound), plain "
          f"{row['plain_ms']:.4f} ms{' (head by head)' if by_head else ''}, "
          f"SDPA {row['library_ms']:.4f} ms ({backend}; under "
          f"EFFICIENT_ATTENTION {row['efficient_ms']:.4f} ms), bound "
          f"{bound:.4f} ms by {by} ({nbytes / 1e9:.4f} GB over 3.35 TB/s, "
          f"{flops / 1e9:.1f} Gflop over "
          f"{'989' if dtype == torch.bfloat16 else '165 (3xTF32)'} TFLOP/s"
          + (f"; CUDA-core bound at 67 TFLOP/s {row['cuda_core_bound_ms']:.4f}"
             f" ms" if dtype == torch.float32 else "") + "); "
          f"max |d| {err:.3g}, {excess:.3g} x the elementwise limit; planted "
          f"faults at {fault_excess['next_kv_head']:.3g} x (next KV head) and "
          f"{fault_excess['far_keys_dropped']:.3g} x (far keys dropped) "
          f"(against max(1, max |ref|) x tol: "
          f"{fault_max_scaled['next_kv_head']:.3g} x and "
          f"{fault_max_scaled['far_keys_dropped']:.3g} x); "
          f"SDPA max |d| {lib_err:.3g}, {lib_excess:.3g} x the elementwise "
          f"limit (EFFICIENT_ATTENTION {eff_excess:.3g} x)", flush=True)
    return row


def sdpa_backend(q, k, v) -> str:
    """The name of the backend SDPA's dispatcher picks for these inputs
    (causal), by ``torch._fused_sdp_choice``."""
    names = {b.value: n for n, b in SDPBackend.__members__.items()}
    return names[int(torch._fused_sdp_choice(q, k, v, is_causal=True))]


def prefill_run(tag, cfg, params, tokens, reps) -> dict:
    """Phase 14 at one config: ``prefill`` through the kernel, its
    launches, finite logits, the attention share by CUDA events, wall and
    peak memory."""
    B, T = tokens.shape
    before = fa_ops.launches
    logits = lm_serve.prefill(cfg, params, tokens)
    torch.cuda.synchronize()
    per_fwd = fa_ops.launches - before
    if per_fwd != cfg.n_layers:
        raise AssertionError(f"{tag}: {per_fwd} flash launches a forward, "
                             f"not {cfg.n_layers}")
    if logits.shape != (B, cfg.vocab) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"{tag}: logits {list(logits.shape)} "
                             f"not finite or not [B, vocab]")
    events = []

    def timed(*a, **kw):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = fa_ops.flash_attention(*a, **kw)
        ev[1].record()
        events.append(ev)
        return out

    whole = (torch.cuda.Event(enable_timing=True),
             torch.cuda.Event(enable_timing=True))
    with mock.patch.object(transformer, "flash_attention", timed):
        whole[0].record()
        lm_serve.prefill(cfg, params, tokens)
        whole[1].record()
    torch.cuda.synchronize()
    attn_ms = sum(a.elapsed_time(b) for a, b in events)
    device_ms = whole[0].elapsed_time(whole[1])
    wall, peak, peak_fwd, _ = forward_wall(
        lambda: lm_serve.prefill(cfg, params, tokens), reps)
    row = dict(config=cfg.name, B=B, T=T, wall_s=wall,
               tok_per_s=B * T / wall, flash_launches_per_forward=per_fwd,
               attention_ms=attn_ms, prefill_device_ms=device_ms,
               attention_share=attn_ms / device_ms, peak_bytes=peak,
               peak_forward_bytes=peak_fwd)
    print(f"[14] {tag}: logits {list(logits.shape)} finite; {per_fwd} flash "
          f"launches a forward; wall {wall:.4f} s a prefill (host clock, "
          f"ends in synchronize, mean of {reps}) = {B * T / wall:.1f} "
          f"tokens/s; attention {attn_ms:.1f} of {device_ms:.1f} ms by CUDA "
          f"events ({100 * attn_ms / device_ms:.1f}%); peak "
          f"{peak / 2**30:.2f} GiB ({peak_fwd / 2**30:.2f} GiB above the "
          f"resident weights)", flush=True)
    return row


def lm_phases(smi: str, dev: torch.device, ptxas: list) -> dict:
    """Phases 13 to 15: the flash kernel against its plain version and
    SDPA, prefill at full width through it, and serving at full width."""
    gen = torch.Generator(device=dev)

    # ---- 13. flash kernel vs plain at the LMs' attention shapes ----
    t0 = time.time()
    rows = [flash_case(*shp, dtype, gen.manual_seed(13), dev)
            for shp in FLASH_SHAPES
            for dtype in (torch.bfloat16, torch.float32)]
    rows.append(flash_case("llama3.2-1b", 1, 32768, 32, 8, 64,
                           torch.bfloat16, gen.manual_seed(13), dev))
    torch.cuda.empty_cache()
    print(f"[13] done in {time.time() - t0:.1f}s", flush=True)

    # ---- 14. prefill at full width ----
    t0 = time.time()
    shapes = {s.name: s for s in lm_shapes()}
    cfg = lm_archs.LLAMA32_1B
    T = shapes["prefill_32k"].dim("seq_len")        # B = 1; B = 16 once
    params = transformer.init_lm_params(cfg, gen.manual_seed(14))
    tokens = torch.randint(0, cfg.vocab, (1, T), generator=gen, device=dev,
                           dtype=torch.int32)
    fa_ops.launches = 0     # the main path: this run's forwards
    fa_ops.path_launches = dict.fromkeys(fa_ops.PATHS, 0)
    prefills = [prefill_run(f"{cfg.name} prefill_32k B=1 T={T}", cfg,
                            params, tokens, 2)]
    launches, by_path = fa_ops.launches, dict(fa_ops.path_launches)
    # prefill_run's forwards: a check, a timed one, a warm one and 2 reps
    if launches != 5 * cfg.n_layers or by_path["tensor_core"] != launches:
        raise AssertionError(f"the main path made {launches} flash launches "
                             f"({by_path}), not {5 * cfg.n_layers} on the "
                             f"tensor-core path")
    # the kernel path against an f32 forward and the plain attention, T=2048
    tok = tokens[:, :2048].contiguous()
    with mock.patch.object(transformer, "flash_attention",
                           flash_attention_ref):
        ref = transformer.lm_forward(dataclasses.replace(
            cfg, compute_dtype=torch.float32), params, tok)[0]
        base = transformer.lm_forward(cfg, params, tok)[0]
    got = transformer.lm_forward(cfg, params, tok)[0]
    scale = max(1.0, float(ref.abs().max()))
    d_got = float((got.float() - ref).abs().max()) / scale
    d_base = float((base.float() - ref).abs().max()) / scale
    limit = max(1e-3, 2 * d_base)
    if not d_got <= limit:
        raise AssertionError(f"kernel path off the f32 forward by {d_got:.3g}"
                             f", plain attention by {d_base:.3g}")
    del ref, base, got
    print(f"[14] T=2048: bf16 logits through the kernel off the f32 forward "
          f"by {d_got:.3g} x max |ref| ({scale:.3g}), through the plain "
          f"attention by {d_base:.3g} (limit max(1e-3, 2x) = {limit:.3g})",
          flush=True)
    # prefill's last-token logits against 128 decode steps, T = 128
    tok = tokens[:, :128].contiguous()
    want = lm_serve.prefill(cfg, params, tok).float()
    cache = transformer.init_kv_cache(cfg, 1, 128, device=dev)
    lengths = torch.zeros(1, dtype=torch.int32, device=dev)
    for t in range(128):
        logits, cache = transformer.lm_decode_step(cfg, params,
                                                   tok[:, t:t + 1], cache,
                                                   lengths)
        lengths += 1
    # both bf16 paths, rounding at other places (the decode rounds q * scale
    # and p to bf16, the kernel keeps f32): at reduced widths on the CPU
    # they differ by 1.0-1.5e-2 x max |logit|, as much as either differs
    # from its f32 forward
    dec_err = check("decode vs prefill", logits[:, -1], want, 5e-2)
    print(f"[14] T=128: prefill's last-token logits == 128 decode steps "
          f"within 5e-2 x max(1, max |ref|) (max |d| {dec_err:.3g} on max "
          f"|ref| {float(want.abs().max()):.3g})", flush=True)
    del cache, logits, want
    # prefill_32k at the largest power-of-two batch that fits, once: its
    # own B = 32 runs out of the card's memory (the gated FFN's four
    # [B, T, 8192] bf16 temporaries alone are 64 GiB); the timings above
    # run at B = 1, as at ~2.6 s a sequence five forwards at B = 16 would
    # take some three and a half minutes
    Bp = shapes["prefill_32k"].dim("global_batch") // 2
    toks = torch.randint(0, cfg.vocab, (Bp, T), generator=gen, device=dev,
                         dtype=torch.int32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before, t1 = fa_ops.launches, time.time()
    logits = lm_serve.prefill(cfg, params, toks)
    torch.cuda.synchronize()
    wall = time.time() - t1
    per_fwd = fa_ops.launches - before
    if per_fwd != cfg.n_layers or logits.shape != (Bp, cfg.vocab) or not (
            bool(torch.isfinite(logits).all())):
        raise AssertionError(f"prefill_32k B={Bp}: {per_fwd} flash launches, "
                             f"logits {list(logits.shape)} not all finite")
    full_batch = dict(config=cfg.name, B=Bp, T=T, wall_s=wall,
                      tok_per_s=Bp * T / wall, flash_launches=per_fwd,
                      peak_bytes=torch.cuda.max_memory_allocated())
    print(f"[14] {cfg.name} prefill_32k B={Bp} T={T}, one forward: logits "
          f"{list(logits.shape)} finite; {per_fwd} flash launches; wall "
          f"{wall:.3f} s (host clock, ends in synchronize) = "
          f"{Bp * T / wall:.1f} tokens/s; peak "
          f"{full_batch['peak_bytes'] / 2**30:.2f} GiB", flush=True)
    del params, tokens, toks, logits
    torch.cuda.empty_cache()
    qcfg = lm_archs.QWEN3_1P7B
    params = transformer.init_lm_params(qcfg, gen.manual_seed(15))
    tokens = torch.randint(0, qcfg.vocab, (1, 4096), generator=gen,
                           device=dev, dtype=torch.int32)
    prefills.append(prefill_run(f"{qcfg.name} B=1 T=4096", qcfg, params,
                                tokens, 3))
    del params, tokens
    torch.cuda.empty_cache()
    print(f"[14] done in {time.time() - t0:.1f}s: {launches} flash launches "
          f"in the main path's prefill_32k B=1 run "
          f"({launches // cfg.n_layers} forwards), by path {by_path}",
          flush=True)

    # ---- 15. serving at full width ----
    t0 = time.time()
    dec = shapes["decode_32k"]                      # 128 slots cut to 32
    torch.cuda.reset_peak_memory_stats()
    out, tput, metrics = lm_serve.serve(cfg, 64, 32, prompt_len=16,
                                        gen_len=24,
                                        max_len=dec.dim("seq_len"), seed=16,
                                        device=dev)
    peak = torch.cuda.max_memory_allocated()
    if sorted(out) != list(range(64)) or any(
            len(v) != 24 or not all(0 <= x < cfg.vocab for x in v)
            for v in out.values()):
        raise AssertionError("serve did not answer every request with 24 "
                             "tokens of the vocabulary")
    serving = dict(metrics, requests=64, slots=32, max_len=dec.dim("seq_len"),
                   peak_bytes=peak, wall_s=time.time() - t0)
    print(f"[15] {cfg.name} serve: 64 requests answered (24 tokens each) "
          f"through 32 slots, max_len {dec.dim('seq_len')}: "
          f"{metrics['steps']} steps, decode step p50 {metrics['p50']:.2f} "
          f"ms, p99 {metrics['p99']:.2f} ms (first "
          f"{metrics['first_step_ms']:.1f} ms), {tput:.1f} tokens/s; peak "
          f"{peak / 2**30:.2f} GiB; "
          f"{serving['wall_s']:.1f}s", flush=True)
    torch.cuda.empty_cache()
    head = rows[-1]         # llama3.2-1b at prefill_32k's T, bf16
    return {"name": "flash_attention_fwd", "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention/csrc/"
                      "flash_attention_tc.cuh",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:71",
            "path": "tensor_core", "launches": launches,
            "launches_by_path": by_path,
            "f32_source": "src/repro_torch/kernels/flash_attention/csrc/"
                          "flash_attention_tf32.cuh",
            "f32_path": "tensor_core_tf32x3",
            "launches_per_forward": prefills[0]["flash_launches_per_forward"],
            "equal_to_plain": True,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "excess": max(r["excess"] for r in rows),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "tflops": head["tflops"],
            "vs_library": head["vs_library"],
            "bound_share": head["bound_share"], "ptxas": ptxas,
            "library": "torch.nn.functional.scaled_dot_product_attention "
                       "(causal, K/V repeated to the query heads)",
            "headline_shape": "llama3.2-1b T=32768 bf16", "shapes": rows,
            "prefill": prefills, "prefill_full_batch": full_batch,
            "serving": serving, "card": smi}


def main() -> None:
    t_start = time.time()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda is not "
                         "available); the port's smoke runs on the card")

    # ---- 1. device ----
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    print(smi)
    print(f"[device] {kind} x{count}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)

    # ---- 2. build: one nvcc per kernel, all started together ----
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 products in f32
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.time()
    builds = kernels.build_all()      # in the order of kernels.KERNELS
    build_s = time.time() - t0
    (lib, report) = builds[0]
    print(f"[build] {', '.join(b[0].name for b in builds)} in "
          f"{build_s:.1f}s (in parallel)")
    cca_ptxas = cycle_ptxas(report)

    # ---- 3a. kernel vs plain, pinned 8x8, chunk by chunk ----
    t0 = time.time()
    pinned = json.loads((ROOT / "tests" / "data"
                         / "pre_lanes_reference.json").read_text())
    eng = StreamingEngine(EngineConfig(**pinned["cfg"]), "bfs")
    eng.seed(0, 0.0)
    cfg, st, chunks, worst = eng.cfg, eng.state, 0, 0.0
    before = dict(ops.path_launches)
    for e in make_stream(StreamSpec(**pinned["spec"])):
        st, spill = load_stream(cfg, st, e)
        assert len(spill) == 0
        st, q = fresh_stats(st), False
        while not q:
            d, st, q = kernel_vs_plain(cfg, BFS, st, plain_on_cpu=True)
            worst, chunks = max(worst, d), chunks + 1
    on_path(before, "cluster", chunks)
    print(f"[3a] 8x8 pinned, cluster kernel {ops.cluster_geometry(cfg)} "
          f"(n_ctas, rows, bytes a CTA): kernel == plain on every leaf over "
          f"{chunks} chunks (max |d| {worst}; {time.time() - t0:.1f}s)",
          flush=True)

    # ---- 3b. kernel vs plain, 32x32 paper config, mid-stream states ----
    ci = dict(n_vertices=2000, n_edges=20_000)
    cfg_ci = paper_cfg(**ci)
    incs = make_stream(StreamSpec(increments=10, sampling="edge", seed=1,
                                  **ci))
    eng = StreamingEngine(cfg_ci, "bfs")
    eng.seed(0, 0.0)
    for i, e in enumerate(incs):
        if i in (2, 5, 8):
            st, _ = load_stream(eng.cfg, clone(eng.state), e)
            t0 = time.time()
            before = dict(ops.path_launches)
            d, sr, q = kernel_vs_plain(eng.cfg, BFS, fresh_stats(st), 512,
                                       ("cluster", "block"))
            if {p: ops.path_launches[p] - before[p] for p in ops.PATHS} \
                    != {"cluster": 1, "block": 1}:
                raise AssertionError("3b: not one launch on each kernel")
            worst = max(worst, d)
            print(f"[3b] 32x32 ci increment {i}: one K=512 chunk, the "
                  f"cluster kernel and the one-block kernel == plain on "
                  f"every leaf (cycle {int(sr.cycle)}, quiescent {q}, "
                  f"{time.time() - t0:.1f}s)", flush=True)
        eng.run_increment(e, max_cycles=2_000_000)
    want = bfs_levels(ci["n_vertices"], np.concatenate(incs), 0)
    assert (eng.values() == want).all(), "32x32 ci BFS != oracle"

    # ---- 4. fingerprints through the kernel ----
    t0 = time.time()
    before = dict(ops.path_launches)
    rows, vals = replay(pinned)
    assert rows == pinned["backends"]["jnp"]["increments"]
    assert (vals == np.float32(pinned["backends"]["jnp"]["values"])).all()
    print("[4] pinned 8x8 fingerprint reproduced exactly")
    fp = json.loads((ROOT / "src" / "repro_torch" / "data"
                     / "fingerprint_32x32.json").read_text())
    rows, vals = replay(fp)
    want_rows = [{k: r[k] for k in ("cycles", "hops", "execs", "stalls",
                                     "allocs")} for r in fp["increments"]]
    assert rows == want_rows, rows
    assert (vals == np.float32(fp["values"])).all()
    on_path(before, "cluster", None)
    print(f"[4] 32x32 fingerprint reproduced exactly "
          f"({sum(r['cycles'] for r in rows)} cycles; both fingerprints "
          f"{time.time() - t0:.1f}s, every launch on the cluster kernel)",
          flush=True)

    # ---- 5. the paper's stream at full size, through the kernel ----
    t0 = time.time()
    incs = make_stream(StreamSpec(increments=10, sampling="edge", seed=1,
                                  **PAPER_FULL))
    print(f"[5] stream generated in {time.time() - t0:.1f}s: "
          f"{sum(len(e) for e in incs)} edges", flush=True)
    cfg_p = paper_cfg(**PAPER_FULL)
    geometry = ops.cluster_geometry(cfg_p)
    eng = StreamingEngine(cfg_p, "bfs")
    eng.seed(0, 0.0)
    events = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with timed_launches(events):
        ops.launches = 0
        ops.path_launches = dict.fromkeys(ops.PATHS, 0)
        t0 = time.time()
        cycles = 0
        snapshot = None
        plain_rows = []
        for i, e in enumerate(incs):
            if i == len(incs) - 1:
                snapshot = clone(eng.state)
            r = eng.run_increment(e, max_cycles=2_000_000)
            cycles += r.cycles
            plain_rows.append(dict(cycles=r.cycles, hops=r.hops,
                                   execs=r.execs, stalls=r.stalls,
                                   allocs=r.allocs))
            print(f"  increment {i}: {len(e)} edges, {r.cycles} cycles, "
                  f"{r.hops} hops, {r.execs} execs, {r.stalls} stalls, "
                  f"{r.allocs} allocs", flush=True)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches, by_path = ops.launches, dict(ops.path_launches)
    if launches == 0:
        raise AssertionError("the main path launched no cycle kernel")
    if by_path != {"block": 0, "cluster": launches}:
        raise AssertionError(f"main-path launches by kernel {by_path}: not "
                             f"all on the cluster kernel")
    if (launches, cycles) != (102, 50_030):
        raise AssertionError(f"{launches} launches, {cycles} cycles: the "
                             f"paper stream runs 50,030 cycles in 102")
    kern_ms = sum(a.elapsed_time(b) for a, b in events)
    peak = torch.cuda.max_memory_allocated()
    got = eng.values()
    want = bfs_levels(PAPER_FULL["n_vertices"], np.concatenate(incs), 0)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert (got == want).all(), "paper-scale BFS != oracle"
    cells = cfg_p.n_cells
    print(f"[5] 50K/1M paper stream: {cycles} cycles in {wall:.3f}s wall "
          f"(host clock, ends in synchronize) = "
          f"{cycles * cells / wall:.4g} cell-cycles/s; {launches} launches "
          f"{by_path}, {kern_ms / launches:.4f} ms per launch by CUDA events "
          f"({1e6 * kern_ms / cycles:.1f} ns per machine cycle; kernel "
          f"{kern_ms / 1e3:.4f}s of the wall); peak "
          f"{peak / 2**20:.1f} MiB allocated; BFS == oracle", flush=True)

    # ---- 6. one K=512 chunk at full size: both kernels, plain, bound ----
    st, _ = load_stream(cfg_p, snapshot, incs[-1])
    st = fresh_stats(st)
    mutable = sum(t.numel() * t.element_size()
                  for k, t in st._asdict().items() if k != "io_edges")

    def time_chunk(fn, **kw):
        s = clone(st)
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        a.record()
        s2, qr = fn(cfg_p, BFS, s, 512, **kw)
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b), s2, qr

    t_plain, s_plain, q_plain = time_chunk(cca_cycle_chunk_ref)
    times, d = {"cluster": [], "block": []}, 0.0
    for path in ("cluster", "block", "block", "cluster"):
        before = dict(ops.path_launches)
        t, s_kern, q_kern = time_chunk(ops.cca_cycle_chunk, path=path)
        on_path(before, path, 1)
        assert torch.equal(q_kern, q_plain)
        d = max(d, leaf_diff(s_kern, s_plain))
        times[path].append(t)
    ran = int(q_kern[1])
    t_kern, t_block = (float(np.mean(times[p])) for p in ("cluster",
                                                          "block"))
    consumed = int((s_kern.io_pos - st.io_pos).sum()) * 3 * 4
    bound_ms = 1e3 * (2 * mutable + consumed) / H100_BYTES_PER_S
    print(f"[6] full-size chunk ({ran} cycles), in turns cluster, block, "
          f"block, cluster: cluster kernel {geometry} (n_ctas, rows, bytes "
          f"a CTA) {times['cluster'][0]:.4f} / {times['cluster'][1]:.4f} ms "
          f"({1e6 * t_kern / ran:.1f} ns a cycle), one-block kernel "
          f"{times['block'][0]:.4f} / {times['block'][1]:.4f} ms "
          f"({1e6 * t_block / ran:.1f} ns a cycle; {t_block / t_kern:.2f}x "
          f"the cluster kernel), plain {t_plain:.1f} ms, bound "
          f"{bound_ms:.4f} ms (2 x {mutable / 2**20:.1f} MiB mutable state "
          f"over 3.35 TB/s); both kernels == plain (max |d| {d})",
          flush=True)

    # ---- 16-18. the paper experiments' branches, the experiments, replays
    worst = max(worst, branch_phases(pinned))
    experiments = experiment_phases(smi)
    pe._CACHE.clear()                 # seven engines' 0.8 GB IO buffers
    torch.cuda.empty_cache()
    engine_bench = replay_phases()

    # ---- 19. the trace rows' cost: the K=512 chunk of phase 6, in turns ----
    trace = torch.empty((512, 2), dtype=torch.int32, device=st.aq.device)
    turns = {"untraced": [], "traced": []}
    for which in ("untraced", "traced", "traced", "untraced"):
        before = dict(ops.path_launches)
        t, s_kern, q_kern = time_chunk(
            ops.cca_cycle_chunk, path="cluster",
            trace=trace if which == "traced" else None)
        on_path(before, "cluster", 1)
        assert torch.equal(q_kern, q_plain)
        d = max(d, leaf_diff(s_kern, s_plain))
        turns[which].append(t)
    want_rows = torch.full_like(trace, -1)
    cca_cycle_chunk_ref(cfg_p, BFS, clone(st), 512, want_rows)
    if not torch.equal(trace[:ran], want_rows[:ran]):
        raise AssertionError("19: the full-size chunk's trace rows differ "
                             "from the plain version's")
    t_traced, t_untraced = (float(np.mean(turns[k]))
                            for k in ("traced", "untraced"))
    print(f"[19] full-size chunk ({ran} cycles), in turns untraced, traced, "
          f"traced, untraced on the cluster kernel: untraced "
          f"{turns['untraced'][0]:.4f} / {turns['untraced'][1]:.4f} ms, "
          f"traced {turns['traced'][0]:.4f} / {turns['traced'][1]:.4f} ms "
          f"({t_traced / t_untraced:.4f}x); both == plain on every leaf, "
          f"the trace rows == the plain version's", flush=True)

    # ---- 20-22. lanes, parking, rhizomes and the max apps; the skew and
    # lanes experiments ----
    worst = max(worst, lane_rhizome_phases(), skew_state_phase())
    skew_replay = skew_replay_phases()
    skew_paper = skew_paper_phases()

    # ---- 23-26. telemetry: the kernels' telemetry instances, the
    # fingerprint, the three paths at full width, the cost ----
    d_tm, (cfg_t, st_t, s_plain_t) = telemetry_phase_kernels(pinned, cfg_p,
                                                             st)
    worst = max(worst, d_tm)
    telemetry_phase_replay()
    tm_paths = telemetry_phase_paths(incs, cfg_p, plain_rows, want)
    tm_cost = telemetry_phase_cost(cfg_t, st_t, s_plain_t, cfg_p, st,
                                   s_plain)
    del st_t, s_plain_t

    # ---- 27-30. faults, seals and repair: the kernels' fault instances,
    # the fingerprint, the paper stream under faults, the cost ----
    d_flt, (cfg_f, st_f, s_plain_f) = fault_phase_kernels(pinned, cfg_p, st)
    worst = max(worst, d_flt)
    flt_smokes = fault_phase_replay()
    flt_paths = fault_phase_paths(cfg_p, incs, want)
    flt_cost = fault_phase_cost(incs, cfg_p, st, s_plain, cfg_f, st_f,
                                s_plain_f)
    del st_f, s_plain_f

    cca_entry = {
        "name": "cca_cycle_chunk", "route": "cuda",
        "source": "src/repro_torch/kernels/cca_cycle/csrc/"
                  "cca_cycle_cluster.cuh",
        "source_block": "src/repro_torch/kernels/cca_cycle/csrc/"
                        "cca_cycle.cu",
        "replaces": "src/repro/kernels/cca_cycle/kernel.py:43",
        "replaces_wrapper": "repro/kernels/cca_cycle/ops.py::cca_cycle_chunk",
        "path": "cluster", "n_ctas": geometry[0], "rows_per_cta": geometry[1],
        "smem_bytes_per_cta": geometry[2], "launches": launches,
        "launches_by_path": by_path, "equal_to_plain": True,
        "max_abs_err": max(worst, d), "ms": t_kern,
        "ms_per_launch": kern_ms / launches, "block_ms": t_block,
        "plain_ms": t_plain, "bound_ms": bound_ms, "bound_by": "bytes",
        "library_ms": None, "chunk_cycles": ran, "ptxas": cca_ptxas,
        "branches": ["traces", "ingest_only", "random_allocator", "lanes",
                     "park", "rhizomes", "widest", "reliable", "telemetry",
                     "faults"],
        "telemetry": dict(tm_paths, **tm_cost),
        "faults": dict(
            smokes=flt_smokes,
            paper_stream={k: {m: v[m] for m in (
                "cycles", "launches", "wall_s", "increments", "livelock")
                if m in v} for k, v in flt_paths.items()},
            **flt_cost),
        "traced_ms": t_traced, "untraced_ms_in_turns": t_untraced,
        "paper_experiments": {
            "launches": experiments["launches"],
            "streams": [{k: v for k, v in r.items() if k != "per_increment"}
                        for r in experiments["streams"]]},
        "engine_bench": {k: {m: v[m] for m in ("cycles", "wall_s")}
                         for k, v in engine_bench.items()},
        "skew_fingerprint": skew_replay,
        "skew_paper": {f"rhizome_cap={R}": {
            k: r[k] for k in ("status", "all_cycles", "hops", "stalls",
                              "launches", "wall_s", "kernel_ms",
                              "ms_per_launch", "bound_ms", "livelock",
                              "vertex_object_stats") if k in r}
            for R, r in skew_paper.items()},
        "card": smi}
    del eng, snapshot, st, s_kern, s_plain
    torch.cuda.empty_cache()

    # ---- 7. the new kernels' ptxas reports (built in phase 2) ----
    print(f"[7] {builds[1][0].name} (built with the others in "
          f"{build_s:.1f}s)")
    print_ptxas(builds[1][1])
    bag_ptxas(builds[2][0].name, builds[2][1])

    spmm_entry = spmm_phases(smi, torch.device("cuda"))
    torch.cuda.empty_cache()
    bag_entry = dlrm_phases(smi, torch.device("cuda"))
    torch.cuda.empty_cache()          # DLRM's ~42 GiB freed before the LM

    # ---- 12. the flash-attention kernels' ptxas reports ----
    print(f"[12] {builds[3][0].name} (built with the others in "
          f"{build_s:.1f}s)")
    ptxas = flash_ptxas(builds[3][1])
    flash_entry = lm_phases(smi, torch.device("cuda"), ptxas)
    print(f"[done] all phases in {time.time() - t_start:.1f}s", flush=True)
    print(json.dumps({"kernels": [cca_entry, spmm_entry, bag_entry,
                                  flash_entry]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind, "count": count}}))


if __name__ == "__main__":
    main()
