"""The sharded engine, the pipeline and the partitioned SpMM over NCCL, one
process a card (four cards of one host):

    PYTHONPATH=src torchrun --standalone --nproc_per_node 4 \\
        tools/dist_nccl_smoke.py

Each rank joins the process group (``env://``, as torchrun sets it) on
its own card, and the phases run, then it stops:

  a. the JAX parity config (8x8, 64 vertices, 160 edges, chunk 32) tiled
     over (4, 1) and (2, 2), chunk by chunk every leaf of the gathered
     state equal to the unsharded kernel's run on the rank's card; BFS ==
     oracle
  c. the paper config's state (50K / 1M, the last increment loaded) over
     (4, 1): four K=128 chunks, each equal to the unsharded kernel; the ms
     a cycle by CUDA events, the halo exchange and the flag reduction
     alone, ms a cycle
  p. ``pipelined_apply`` at 4 stages on ``tests/test_pipeline_parallel``'s
     network, every rank's outputs equal to the sequential branch
  s. ``spmm_partitioned`` on ogb_products-sized random features (N =
     2,449,028, ogb_products' node count cut to a multiple of 4; E =
     61,859,140; D = 16), each rank's block within 1e-5 x max(1, |ref|)
     of the scatter-SpMM kernel's unsharded sum on the bf16-rounded
     features; timed
  d. ``launch.dist_bench``'s paper row
  m. phi3.5-moe whole (32 layers, f32, ``moe_impl="ep"``) by expert
     parallelism at (1, 4), the forward over the mesh: each card draws
     its blocks of every leaf from the seed (``init_lm_params(mesh=,
     rank=)``: its 4 experts, its heads, its vocabulary rows), and each
     layer's combine is a bf16 ``all_reduce`` over the four; ``prefill``
     at B = 1, T = 4,096: finite logits, 32 flash launches a card, the
     wall, each card's peak memory and the sums' share by CUDA events.
     Then the same config cut to 8 layers over NCCL against the same
     layout over ``LocalTiles`` on rank 0's card alone (every rank's
     blocks drawn there, 42.7 GB): the last-token logits within 3e-2 x
     max(1, max |ref|) (the bf16 LM tolerance)

  t. the tenant layer over the mesh: ``serve_bench.serve_batch("paper")``
     (Q = 8 ``QUERY_MIX`` on the 32x32 serving preset) with the session's
     state sharded over (4, 1) once the CC tenant is admitted, every beat
     through ``FrontDesk.step``: the batch cycles, every receipt, the
     deferrals and every tenant's values equal to the same batch
     unsharded on the rank's card, exactly; ms a 4-tile cycle, the wall
  l. llama3.2-1b whole (16 layers, full width) at (2, 2): each card draws
     its blocks of every leaf (``init_lm_params(mesh=, rank=)``), the
     prefill at B = 2, T = 4,096 and 4 decode steps at 8 slots, each
     card's logits within 3e-2 x max(1, max |ref|) of the same (2, 2)
     layout over ``LocalTiles`` on rank 0's card; the walls, each card's
     peak memory
  m2. phi3.5-moe whole (32 layers, f32) by FSDP x TP x EP at (2, 2): the
     MoE FFN's expert parallelism over processes at ``data`` 2, each card
     drawing its blocks; the prefill at B = 2, T = 4,096: finite logits,
     the wall, each card's peak memory and the collectives' share (the
     sums over ``model`` and the gathers over ``data``) by CUDA events.
     Then the same cut to 8 layers against the same (2, 2) layout over
     ``LocalTiles`` on rank 0's card, within 3e-2 x max(1, max |ref|)

``--phases`` picks phases (default all, in the order above).  Rank 0
prints the card's name and power limit, each phase's line and one JSON
line of the numbers.  ``--cpu`` runs the same over gloo on the CPU at
small sizes (the parity config, a 2,000-vertex / 20K-edge 32x32 state,
N = 4,096 / E = 100K; phase m on phi3.5-moe's smoke config at 16
experts, 4 and 2 layers, T = 64; phase t at ci scale; phases l and m2 on
the smoke configs, T = 64), to check the script before a call on four
cards:

    PYTHONPATH=src torchrun --standalone --nproc_per_node 4 \\
        tools/dist_nccl_smoke.py --cpu
"""
import argparse
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import BFS, StreamingEngine  # noqa: E402
from repro_torch.core.ingest import load_stream  # noqa: E402
from repro_torch.core.reference import bfs_levels  # noqa: E402
from repro_torch.dist import cca  # noqa: E402
from repro_torch.dist.ctx import Mesh  # noqa: E402
from repro_torch.dist.pipeline import pipelined_apply, split_stages  # noqa
from repro_torch.dist.transport import ProcessGroupTiles  # noqa: E402
from repro_torch.graph.partition import (partition_edges,  # noqa: E402
                                         spmm_partitioned)
from repro_torch.graph.segment_ops import spmm  # noqa: E402
from repro_torch.graph.streams import StreamSpec, make_stream  # noqa: E402
from repro_torch.kernels.cca_cycle import ops  # noqa: E402
from repro_torch.launch import dist_bench  # noqa: E402
from repro_torch.configs import lm_archs  # noqa: E402
from repro_torch.dist import ctx  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.launch import serve as lm_serve  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.dist.sharding import (Placed, gather_placed,  # noqa: E402
                                       tree_leaves)
from repro_torch.launch import serve_bench as sb  # noqa: E402


def say(tr, *a):
    if tr.rank == 0:
        print(*a, flush=True)


def same(a, b, where):
    for name in a._fields:
        x, y = getattr(a, name), getattr(b, name)
        if not torch.equal(x, y):
            raise AssertionError(f"{where}: leaf {name!r} differs")


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def chunk_run(cfg, st, mesh, n_chunks, n_cycles, tag):
    """Shard ``st`` over ``mesh`` and run ``n_chunks`` chunks beside the
    unsharded run, every leaf equal each chunk.  Returns the sharded
    state, the chunks' ms and the cycles run."""
    sst = cca.shard_state(cfg, st, mesh)
    one = st._replace(**{k: v.clone() for k, v in st._asdict().items()})
    times, cycles = [], 0
    for k in range(n_chunks):
        sync(sst.device)
        t0 = time.perf_counter()
        sst, kr = cca.run_chunk(cfg, BFS, sst, n_cycles=n_cycles)
        sync(sst.device)
        times.append(1e3 * (time.perf_counter() - t0))
        one, r1 = ops.cca_cycle_chunk(cfg, BFS, one, n_cycles)
        same(cca.gather_state(sst), one, f"{tag} chunk {k}")
        if not torch.equal(kr, r1):
            raise AssertionError(f"{tag}: record {kr.tolist()} != "
                                 f"{r1.tolist()}")
        cycles += int(kr[1])
        if bool(kr[0]) and n_cycles is None:
            break
    return sst, times, cycles


def phase_parity(tr, dev) -> dict:
    out = {}
    for shape in ((4, 1), (2, 2)):
        cfg, app, st, edges = dist_bench.loaded_state("ci", dev)
        mesh = Mesh(shape, ("data", "model"), tr)
        sst, times, cycles = chunk_run(cfg, st, mesh, 70, None,
                                       f"parity {shape}")
        g = cca.gather_state(sst)
        eng = StreamingEngine(cfg, "bfs", device=dev)
        eng.state = g
        assert (eng.values() == bfs_levels(64, edges, 0)).all()
        out[f"{shape[0]}x{shape[1]}"] = dict(cycles=cycles,
                                             chunks=len(times))
        say(tr, f"[a] parity config over {shape}: {cycles} cycles in "
                f"{len(times)} chunks, == the unsharded kernel on every "
                f"leaf each chunk; BFS == oracle")
    return out


def paper_state(dev, small):
    n, m = (2_000, 20_000) if small else (50_000, 1_000_000)
    incs = make_stream(StreamSpec(increments=10, sampling="edge", seed=1,
                                  n_vertices=n, n_edges=m))
    ghosts = max(64, 2 * m // (8 * 1024), 3 * n // 1024)
    from repro_torch.core import EngineConfig
    cfg = EngineConfig(height=32, width=32, n_vertices=n, edge_cap=8,
                       ghost_slots=ghosts, queue_cap=64, chan_cap=16,
                       futq_cap=16, io_stream_cap=2 ** 21, chunk=512)
    eng = StreamingEngine(cfg, "bfs", device=dev)
    eng.seed(0, 0.0)
    for e in incs[:-1]:
        eng.run_increment(e, max_cycles=2_000_000)
    st, _ = load_stream(eng.cfg, eng.state, incs[-1])
    zero = {k: torch.zeros_like(getattr(st, k)) for k in cca.COUNTERS[1:]}
    return eng.cfg, st._replace(**zero)


def timed(dev, fn) -> float:
    if dev.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return 1e3 * (time.perf_counter() - t0)
    a, b = (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))
    a.record()
    fn()
    b.record()
    torch.cuda.synchronize(dev)
    return a.elapsed_time(b)


def phase_paper(tr, dev, small) -> dict:
    cfg, st = paper_state(dev, small)
    mesh = Mesh((4, 1), ("data", "model"), tr)
    sst, times, cycles = chunk_run(cfg, st, mesh, 4, 128, "paper")
    tr.barrier()
    ex = timed(dev, lambda: [sst.exchange() for _ in range(128)]) / 128
    red = timed(dev, lambda: [sst.reduce_quiet() for _ in range(128)]) / 128
    ms = sum(times) / max(cycles, 1)
    say(tr, f"[c] paper state over (4, 1): 4 K=128 chunks == the unsharded "
            f"kernel; {', '.join(f'{t:.3f}' for t in times)} ms, "
            f"{ms:.4f} ms a cycle; exchange {ex:.4f} ms a cycle, flag "
            f"reduction {red:.4f} ms; tile launches {ops.tile_launches}")
    return dict(chunk_ms=times, ms_per_cycle=ms, exchange_ms=ex,
                reduce_ms=red, cycles=cycles)


def phase_pipeline(tr, dev) -> dict:
    rng = np.random.default_rng(0)
    w = torch.from_numpy((rng.standard_normal((8, 16, 16)) * 0.3)
                         .astype(np.float32)).to(dev)
    b = torch.from_numpy((rng.standard_normal((8, 16)) * 0.1)
                         .astype(np.float32)).to(dev)
    xs = torch.from_numpy(rng.standard_normal((6, 4, 16))
                          .astype(np.float32)).to(dev)

    def stage(p, x):
        for l in range(p["w"].shape[0]):
            x = torch.tanh(x @ p["w"][l] + p["b"][l])
        return x

    stages = split_stages(dict(w=w, b=b), 4)
    got = pipelined_apply(stage, stages, xs, Mesh((4,), ("pipe",), tr))
    want = pipelined_apply(stage, stages, xs, None)
    err = float((got - want).abs().max())
    assert err <= 1e-6, err
    say(tr, f"[p] GPipe over 4 stages == sequential (max |d| {err})")
    return dict(max_abs_err=err)


def phase_spmm(tr, dev, small) -> dict:
    N, E, D = (4_096, 100_000, 16) if small else (2_449_028, 61_859_140, 16)
    rng = np.random.default_rng(7)
    src = rng.integers(0, N, E).astype(np.int32)
    dst = rng.integers(0, N, E).astype(np.int32)
    x = torch.from_numpy(rng.standard_normal((N, D), dtype=np.float32))
    t0 = time.perf_counter()
    part = partition_edges(np.stack([src, dst]), N, tr.world)
    part_s = time.perf_counter() - t0
    blk = N // tr.world
    r = tr.rank
    x_l = x[r * blk:(r + 1) * blk].to(dev)
    ei = torch.from_numpy(part).to(dev)
    mesh = Mesh((tr.world, 1), ("data", "model"), tr)
    spmm_partitioned(x_l, ei, N, None, mesh)          # warm
    tr.barrier()
    box = {}
    ms = timed(dev, lambda: box.update(
        out=spmm_partitioned(x_l, ei, N, None, mesh)))
    o = np.argsort(dst, kind="stable")
    xb = x.to(torch.bfloat16).float().to(dev)
    sorted_ei = torch.from_numpy(np.ascontiguousarray(
        np.stack([src, dst])[:, o])).to(dev)
    want = spmm(xb, sorted_ei, N, None, "sum")[r * blk:(r + 1) * blk]
    err = float((box["out"] - want).abs().max())
    tol = 1e-5 * max(1.0, float(want.abs().max()))
    assert err <= tol, (err, tol)
    say(tr, f"[s] spmm_partitioned N={N} E={E} D={D} over {tr.world} "
            f"ranks: {ms:.3f} ms (partition_edges {part_s:.1f}s on the "
            f"host), each block == the unsharded kernel on bf16 x within "
            f"1e-5 (max |d| {err:.3g})")
    return dict(ms=ms, max_abs_err=err, n=N, e=E, d=D)


def moe_config(small, layers):
    if small:
        return dataclasses.replace(lm_archs._smoke(lm_archs.PHI35_MOE),
                                   n_experts=16, n_layers=layers,
                                   moe_impl="ep")
    return dataclasses.replace(lm_archs.PHI35_MOE, n_layers=layers,
                               moe_impl="ep")


def moe_prefill(cfg, params, tokens, dev, tr) -> tuple:
    """(last-token logits, wall s, device ms, ms in the sums over
    ``model``): ``timed_forward`` of ``serve.prefill``."""
    out, wall, device_ms, sum_ms, _ = timed_forward(
        lambda: lm_serve.prefill(cfg, params, tokens), dev, tr)
    return gather_placed(out), wall, device_ms, sum_ms


def phase_moe(tr, dev, small) -> dict:
    """Phase m: phi3.5-moe by expert parallelism over the four ranks."""
    rank = tr.rank
    mesh = Mesh((1, tr.world), ("data", "model"), tr)
    if dev.type == "cuda":
        torch.cuda.empty_cache()          # the earlier phases' blocks
    T = 64 if small else 4096
    tokens = torch.randint(0, moe_config(small, 1).vocab, (1, T),
                           generator=torch.Generator().manual_seed(7),
                           dtype=torch.int32).to(dev)
    out = {}
    for layers in ((4, 2) if small else (32, 8)):
        cfg = moe_config(small, layers)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.time()
        params = Placed(mesh, transformer.lm_param_specs(cfg, mesh), [
            transformer.init_lm_params(
                cfg, torch.Generator(device=dev).manual_seed(46), mesh,
                rank)])
        sync(dev)
        draw_s = time.time() - t0
        ctx.set_dist_mesh(mesh)
        try:
            before = fa_ops.launches
            logits, wall, device_ms, reduce_ms = moe_prefill(
                cfg, params, tokens, dev, tr)
            launches = fa_ops.launches - before
        finally:
            ctx.set_dist_mesh(None)
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"rank {rank}: logits not finite")
        if dev.type == "cuda" and launches != 2 * layers:
            raise AssertionError(f"rank {rank}: {launches} flash launches in "
                                 f"two prefills, not {2 * layers}")
        peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
                else 0)
        peaks = tr.all_gather([torch.tensor([float(peak)], device=dev)])
        row = dict(layers=layers, T=T, draw_s=draw_s, wall_s=wall,
                   device_ms=device_ms, all_reduce_ms=reduce_ms,
                   all_reduce_share=reduce_ms / device_ms,
                   peak_bytes_by_card=[float(p) for p in peaks],
                   flash_launches=launches // 2)
        say(tr, f"[m] {cfg.name} {layers} layers over (1, {tr.world}) by "
                f"expert parallelism, B=1 T={T}: logits finite; its "
                f"blocks drawn in {draw_s:.1f}s; wall {wall:.4f} s a prefill"
                f" (host clock, ends in synchronize), {T / wall:.1f} "
                f"tokens/s; device {device_ms:.1f} ms, the all_reduce over "
                f"model {reduce_ms:.1f} ms ({100 * reduce_ms / device_ms:.1f}"
                f"%); peak by card "
                f"{[round(float(p) / 2**30, 2) for p in peaks]} GiB")
        del params
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        out[f"{layers}_layers"] = row
    # the 8-layer config over LocalTiles on rank 0's card alone
    if rank == 0:
        want = local_tiles_ref(cfg, dev, 46, lambda p: gather_placed(
            lm_serve.prefill(cfg, p, tokens)), (1, tr.world))
        d = float((logits.float() - want.float()).abs().max())
        scale = max(1.0, float(want.float().abs().max()))
        if not d <= 3e-2 * scale:
            raise AssertionError(f"NCCL EP off LocalTiles EP by {d}")
        out["vs_local_tiles"] = dict(layers=cfg.n_layers, max_abs_err=d,
                                     equal_bits=bool(torch.equal(logits,
                                                                 want)),
                                     scale=scale)
        say(tr, f"[m] {cfg.n_layers} layers: {tr.backend} EP's last-token "
                f"logits == LocalTiles EP on one card within 3e-2 x max(1, "
                f"max |ref|)"
                f" (max |d| {d:.3g} on {scale:.3g}; equal bits "
                f"{out['vs_local_tiles']['equal_bits']})")
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    tr.barrier()
    return out


def phase_tenants(tr, dev, small) -> dict:
    """Phase t: phase 57's batch over the process group at (4, 1)."""
    scale = "ci" if small else "paper"
    mesh = Mesh((tr.world, 1), ("data", "model"), tr)

    def place(ses):
        ses.eng.state = cca.shard_state(ses.eng.cfg, ses.eng.state, mesh)
    ops.launches = 0
    ops.tile_launches = {}
    sync(dev)
    t0 = time.time()
    ses, fd, cycles, values, wall = sb.serve_batch(scale, device=dev,
                                                   _place=place)
    tiles = dict(ops.tile_launches)
    _, fd1, cycles1, values1, wall1 = sb.serve_batch(scale, device=dev)
    receipts = json.loads(json.dumps(fd.receipts, default=int))
    if (cycles, fd.deferrals, receipts) != (
            cycles1, fd1.deferrals,
            json.loads(json.dumps(fd1.receipts, default=int))):
        raise AssertionError(f"rank {tr.rank}: the sharded batch's cycles, "
                             f"deferrals or receipts differ")
    for q, v in values.items():
        if not np.array_equal(v.view(np.int32), values1[q].view(np.int32)):
            raise AssertionError(f"rank {tr.rank}: slot {q}'s values differ")
    stepped = sum(tiles.values())
    say(tr, f"[t] serve_batch('{scale}') over ({tr.world}, 1) on "
            f"{tr.backend}: {cycles} cycles, {len(receipts)} receipts, "
            f"{fd.deferrals} deferrals and every slot's values == the "
            f"unsharded batch on the card exactly; tile launches {tiles} on "
            f"rank 0, {1e3 * wall / max(1, stepped):.4f} ms a cycle on the "
            f"host clock (wall {wall:.3f}s; unsharded {wall1:.3f}s)")
    return dict(scale=scale, cycles=cycles, receipts=len(receipts),
                deferrals=fd.deferrals, tile_launches=tiles, wall_s=wall,
                unsharded_wall_s=wall1,
                ms_per_cycle=1e3 * wall / max(1, stepped))


def timed_forward(fn, dev, tr) -> tuple:
    """(fn's result, wall s, device ms, ms in the transport's sums, ms in
    its gathers): one call after a warm one, each collective timed by
    CUDA events on the card (the host clock on the CPU)."""
    fn()
    cuda = dev.type == "cuda"

    def mark():
        if not cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def ms(a, b):
        return a.elapsed_time(b) if cuda else 1e3 * (b - a)
    spans = {"axis_sum": [], "axis_gather": []}
    for name, got in spans.items():
        def timed_op(*a, _op=getattr(tr, name), _got=got):
            start = mark()
            out = _op(*a)
            _got.append((start, mark()))
            return out
        setattr(tr, name, timed_op)
    try:
        tr.barrier()
        sync(dev)
        t0 = time.perf_counter()
        start = mark()
        out = fn()
        end = mark()
        sync(dev)
        wall = time.perf_counter() - t0
    finally:
        del tr.axis_sum, tr.axis_gather
    return (out, wall, ms(start, end),
            sum(ms(a, b) for a, b in spans["axis_sum"]),
            sum(ms(a, b) for a, b in spans["axis_gather"]))


def local_tiles_ref(cfg, dev, seed, fn, shape=(2, 2)):
    """``fn(params)`` over the same layout (a ``shape`` mesh) of
    ``LocalTiles`` on this card, every rank's blocks drawn from ``seed``."""
    mesh = make_host_mesh(*shape, device=dev)
    params = Placed(mesh, transformer.lm_param_specs(cfg, mesh), [
        transformer.init_lm_params(
            cfg, torch.Generator(device=dev).manual_seed(seed), mesh, r)
        for r in mesh.local_ranks])
    ctx.set_dist_mesh(mesh)
    try:
        return fn(params)
    finally:
        ctx.set_dist_mesh(None)


def lm_on_mesh(tr, dev, cfg, seed, B, T, decode_steps, compare=True):
    """This card's blocks of ``cfg`` drawn from ``seed`` at (2, 2); the
    last-token logits of a prefill at ``B`` x ``T`` and of
    ``decode_steps`` decode steps at 8 slots, gathered whole, with their
    timings; and, where ``compare``, the same over ``LocalTiles`` on
    rank 0."""
    mesh = Mesh((2, 2), ("data", "model"), tr)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    params = Placed(mesh, transformer.lm_param_specs(cfg, mesh), [
        transformer.init_lm_params(
            cfg, torch.Generator(device=dev).manual_seed(seed), mesh,
            tr.rank)])
    sync(dev)
    draw_s = time.time() - t0
    nbytes = sum(t.numel() * t.element_size()
                 for t in tree_leaves(params.blocks[0]))
    tokens = torch.randint(0, cfg.vocab, (B, T), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(7)
                           ).to(dev)
    feed = torch.randint(0, cfg.vocab, (8, decode_steps), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(8)).to(dev)

    def run(p):
        with torch.no_grad():
            out = [gather_placed(transformer.lm_last_logits(cfg, p, tokens))]
            cache = transformer.init_kv_cache(cfg, 8, 32, device=dev)
            lens = torch.arange(8, dtype=torch.int32, device=dev)
            for s in range(decode_steps):
                lg, cache = transformer.lm_decode_step(
                    cfg, p, feed[:, s:s + 1], cache, lens + s)
                out.append(gather_placed(lg))
        return out
    ctx.set_dist_mesh(mesh)
    try:
        before = fa_ops.launches
        got, wall, device_ms, sum_ms, gather_ms = timed_forward(
            lambda: run(params), dev, tr)
        launches = (fa_ops.launches - before) // 2
    finally:
        ctx.set_dist_mesh(None)
    if not all(bool(torch.isfinite(x).all()) for x in got):
        raise AssertionError(f"rank {tr.rank}: logits not finite")
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    peaks = tr.all_gather([torch.tensor([float(peak)], device=dev)])
    nb = tr.all_gather([torch.tensor([float(nbytes)], device=dev)])
    del params
    row = dict(layers=cfg.n_layers, B=B, T=T, draw_s=draw_s, wall_s=wall,
               device_ms=device_ms, axis_sum_ms=sum_ms,
               axis_gather_ms=gather_ms,
               collective_share=(sum_ms + gather_ms) / device_ms,
               flash_launches=launches,
               peak_bytes_by_card=[float(p) for p in peaks],
               weight_bytes_by_card=[float(n) for n in nb])
    if tr.rank == 0 and compare:
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        want = local_tiles_ref(cfg, dev, seed, run)
        errs = []
        for g, w in zip(got, want):
            limit = 3e-2 * max(1.0, float(w.float().abs().max()))
            d = float((g.float() - w.float()).abs().max())
            if not d <= limit:
                raise AssertionError(f"{cfg.name}: {tr.backend} off "
                                     f"LocalTiles by {d}, over {limit}")
            errs.append(d / max(1.0, float(w.float().abs().max())))
        row["vs_local_tiles_rel"] = max(errs)
        row["equal_bits"] = all(torch.equal(g, w) for g, w in zip(got, want))
        del want
    tr.barrier()
    return row


def phase_lm(tr, dev, small) -> dict:
    """Phase l: llama3.2-1b whole at (2, 2)."""
    cfg = lm_archs._smoke(lm_archs.LLAMA32_1B) if small \
        else lm_archs.LLAMA32_1B
    row = lm_on_mesh(tr, dev, cfg, 58, 2, 64 if small else 4096, 4)
    if tr.rank == 0:
        print(f"[l] {cfg.name} {cfg.n_layers} layers at (2, 2) over "
              f"{tr.backend}: prefill B=2 T={row['T']} and 4 decode steps "
              f"== the same layout over LocalTiles on one card within 3e-2 "
              f"x max(1, max |ref|) (worst {row['vs_local_tiles_rel']:.3g},"
              f" equal bits {row['equal_bits']}); weights by card "
              f"{[round(b / 2**30, 3) for b in row['weight_bytes_by_card']]}"
              f" GiB; wall {row['wall_s']:.4f} s, device "
              f"{row['device_ms']:.1f} ms, the collectives "
              f"{100 * row['collective_share']:.1f}%; "
              f"{row['flash_launches']} flash launches a card; peak by card "
              f"{[round(p / 2**30, 2) for p in row['peak_bytes_by_card']]} "
              f"GiB", flush=True)
    return row


def phase_moe_fsdp(tr, dev, small) -> dict:
    """Phase m2: phi3.5-moe whole by FSDP x TP x EP at (2, 2), then cut to
    8 layers against ``LocalTiles``."""
    out = {}
    T = 64 if small else 4096
    for layers, whole in (((4, True), (2, False)) if small
                          else ((32, True), (8, False))):
        cfg = moe_config(small, layers)
        row = lm_on_mesh(tr, dev, cfg, 46, 2, T, 0 if whole else 2,
                         compare=not whole)
        out[f"{layers}_layers"] = row
        say(tr, f"[m2] {cfg.name} {layers} layers by FSDP x TP x EP at "
                f"(2, 2) over {tr.backend}, B=2 T={row['T']}: logits finite"
                + (f", == LocalTiles within 3e-2 x max(1, max |ref|) (worst "
                   f"{row['vs_local_tiles_rel']:.3g})"
                   if "vs_local_tiles_rel" in row else "")
                + f"; weights by card "
                f"{[round(b / 2**30, 2) for b in row['weight_bytes_by_card']]}"
                f" GiB, drawn in {row['draw_s']:.1f}s; wall "
                f"{row['wall_s']:.4f} s, device {row['device_ms']:.1f} ms, "
                f"sums over model {row['axis_sum_ms']:.1f} ms, gathers over "
                f"data {row['axis_gather_ms']:.1f} ms "
                f"({100 * row['collective_share']:.1f}%); peak by card "
                f"{[round(p / 2**30, 2) for p in row['peak_bytes_by_card']]}"
                f" GiB")
    return out


PHASES = ("a", "c", "p", "s", "d", "m", "t", "l", "m2")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="gloo on the CPU at small sizes")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated, of {PHASES}")
    args = ap.parse_args()
    phases = args.phases.split(",")
    if set(phases) - set(PHASES):
        raise SystemExit(f"unknown phases {set(phases) - set(PHASES)}")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if world != 4:
        raise SystemExit("dist_nccl_smoke runs on 4 ranks")
    t_start = time.time()
    tr = ProcessGroupTiles.connect("env://", rank, world,
                                   backend="gloo" if args.cpu else "nccl")
    try:
        dev = tr.device
        if not args.cpu:
            # rank 0 builds the kernels, the others load its build
            if rank == 0:
                from repro_torch import kernels
                t0 = time.time()
                kernels.build_all()
                print(f"[build] {time.time() - t0:.1f}s", flush=True)
            tr.barrier()
        if rank == 0 and not args.cpu:
            print(subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                check=True).stdout.strip(), flush=True)
        say(tr, f"[device] {dev} x{world}, backend {tr.backend}")
        out = {}
        runs = dict(
            a=("parity", lambda: phase_parity(tr, dev)),
            c=("paper", lambda: phase_paper(tr, dev, args.cpu)),
            p=("pipeline", lambda: phase_pipeline(tr, dev)),
            s=("spmm", lambda: phase_spmm(tr, dev, args.cpu)),
            d=("dist_bench", lambda: dist_bench.process_group_row(
                "ci" if args.cpu else "paper")),
            m=("moe", lambda: phase_moe(tr, dev, args.cpu)),
            t=("tenants", lambda: phase_tenants(tr, dev, args.cpu)),
            l=("lm", lambda: phase_lm(tr, dev, args.cpu)),
            m2=("moe_fsdp", lambda: phase_moe_fsdp(tr, dev, args.cpu)))
        for p in phases:
            name, fn = runs[p]
            t0 = time.time()
            out[name] = fn()
            if p == "d":
                say(tr, f"[d] dist_bench: {json.dumps(out['dist_bench'])}")
            say(tr, f"[{p}] {time.time() - t0:.1f}s")
        if rank == 0:
            print(f"[done] {time.time() - t_start:.1f}s")
            print(json.dumps(out), flush=True)
    finally:
        ProcessGroupTiles.close()


if __name__ == "__main__":
    main()
