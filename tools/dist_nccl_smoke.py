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
     parallelism at (1, 4): each card draws only its 4 experts' blocks of
     every layer from the seed (``init_lm_params(mesh=, rank=)``; 46.7 GB
     a card with the replicated attention and embeddings), and each
     layer's combine is a bf16 ``all_reduce`` over the four; ``prefill``
     at B = 1, T = 4,096: finite logits, 32 flash launches a card, the
     wall, each card's peak memory and the ``all_reduce``'s share by CUDA
     events.  Then the same config cut to 8 layers over NCCL against the
     same EP over ``LocalTiles`` on rank 0's card alone (all 16 experts
     drawn whole there, 42.7 GB): the last-token logits within 3e-2 x
     max(1, max |ref|) (the bf16 LM tolerance; equal bits expected, as
     each token's sum over ``model`` has at most its two experts' nonzero
     terms)

Rank 0 prints the card's name and power limit, each phase's line and one
JSON line of the numbers.  ``--cpu`` runs the same over gloo on the CPU at
small sizes (the parity config, a 2,000-vertex / 20K-edge 32x32 state,
N = 4,096 / E = 100K; phase m on phi3.5-moe's smoke config at 16
experts, 4 and 2 layers, T = 64), to check the script before a call on
four cards:

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
    """(last-token logits, wall s, device ms, all_reduce ms): one prefill
    after a warm one, the prefill and each of the transport's sums over
    ``model`` timed by CUDA events on the card (the host clock on the
    CPU), read after it."""
    lm_serve.prefill(cfg, params, tokens)
    cuda = dev.type == "cuda"

    def mark():
        if not cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def ms(a, b):
        return a.elapsed_time(b) if cuda else 1e3 * (b - a)
    sums = []
    axis_sum = tr.axis_sum

    def timed_sum(*a):
        start = mark()
        out = axis_sum(*a)
        sums.append((start, mark()))
        return out
    tr.axis_sum = timed_sum
    try:
        tr.barrier()
        sync(dev)
        t0 = time.perf_counter()
        start = mark()
        logits = lm_serve.prefill(cfg, params, tokens)
        end = mark()
        sync(dev)
        wall = time.perf_counter() - t0
    finally:
        del tr.axis_sum
    return (logits, wall, ms(start, end),
            sum(ms(a, b) for a, b in sums))


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
        params = transformer.init_lm_params(
            cfg, torch.Generator(device=dev).manual_seed(46), mesh, rank)
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
                f"expert parallelism, B=1 T={T}: logits finite; expert "
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
        params = transformer.init_lm_params(
            cfg, torch.Generator(device=dev).manual_seed(46))
        ctx.set_dist_mesh(make_host_mesh(1, tr.world, device=dev))
        try:
            want = lm_serve.prefill(cfg, params, tokens)
        finally:
            ctx.set_dist_mesh(None)
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
        del params
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    tr.barrier()
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="gloo on the CPU at small sizes")
    args = ap.parse_args()
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
        out = dict(parity=phase_parity(tr, dev),
                   paper=phase_paper(tr, dev, args.cpu),
                   pipeline=phase_pipeline(tr, dev),
                   spmm=phase_spmm(tr, dev, args.cpu))
        out["dist_bench"] = dist_bench.process_group_row(
            "ci" if args.cpu else "paper")
        say(tr, f"[d] dist_bench: {json.dumps(out['dist_bench'])}")
        out["moe"] = phase_moe(tr, dev, args.cpu)
        if rank == 0:
            print(f"[done] {time.time() - t_start:.1f}s")
            print(json.dumps(out), flush=True)
    finally:
        ProcessGroupTiles.close()


if __name__ == "__main__":
    main()
