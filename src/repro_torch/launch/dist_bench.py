"""Chunk throughput of the sharded engine against the number of ranks (the
port of ``benchmarks/dist_scaling.py``: the same scales, streams and row
fields).

Each row times ``timed_chunks`` fixed-length chunks (``dist.cca.
run_chunk_body``) of the scale's BFS stream (seed 0) on a ``(devices, 1)``
mesh, after one untimed chunk whose seconds, the kernel build included,
are ``compile_s``:

    # tiles of one process on one card (LocalTiles), 1/2/4/8 ranks
    PYTHONPATH=src python -m repro_torch.launch.dist_bench --scale mid
    # the same on the CPU, the plain version
    PYTHONPATH=src python -m repro_torch.launch.dist_bench --device cpu
    # one process a rank over gloo on the CPU (spawned here)
    PYTHONPATH=src python -m repro_torch.launch.dist_bench --gloo 4
    # one process a card over NCCL
    PYTHONPATH=src torchrun --standalone --nproc_per_node 4 \\
        -m repro_torch.launch.dist_bench --torchrun --scale paper

Rows print as JSON lines; a file is written only under ``--out``.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# scale -> (height, width, n_vertices, stream_edges, chunk, timed_chunks)
SCALES = {
    "ci": (8, 8, 64, 160, 32, 6),
    "mid": (16, 16, 1024, 4096, 64, 8),
    "paper": (32, 32, 50_000, 102_000, 128, 8),
}


def scale_config(scale: str):
    """``(cfg, edges)``: the scale's config and its stream, as
    ``benchmarks/dist_scaling.py::worker`` builds them (the ci scale is
    ``tests/test_dist_cca_parity.py``'s config and stream)."""
    from repro_torch.core import EngineConfig
    H, W, V, E, chunk, _ = SCALES[scale]
    cfg = EngineConfig(height=H, width=W, n_vertices=V,
                       ghost_slots=max(16, 4 * V // (H * W)),
                       io_stream_cap=max(256, 2 * E // W), chunk=chunk)
    rng = np.random.default_rng(0)
    one = np.float32(1.0).view(np.int32)
    edges = np.stack([rng.integers(0, V, E), rng.integers(0, V, E),
                      np.full(E, one)], 1).astype(np.int32)
    return cfg, edges


def loaded_state(scale: str, device):
    """``(cfg, app, state, edges)``: the engine seeded at vertex 0 with
    the scale's stream loaded, on ``device``."""
    from repro_torch.core import StreamingEngine
    from repro_torch.core.ingest import load_stream
    cfg, edges = scale_config(scale)
    eng = StreamingEngine(cfg, "bfs", device=device)
    eng.seed(0, 0.0)
    st, spill = load_stream(eng.cfg, eng.state, edges)
    if len(spill):
        raise AssertionError(f"{scale}: the stream spills")
    return eng.cfg, eng.app, st, edges


def card_name() -> str:
    return torch.cuda.get_device_name(0) if torch.cuda.is_available() \
        else "cpu"


def time_rows(scale: str, mesh) -> dict:
    """One row: the scale's stream sharded over ``mesh`` (a ``(devices,
    1)`` mesh with a transport)."""
    from repro_torch.dist import cca
    dev = mesh.transport.device
    cfg, app, st, _ = loaded_state(scale, dev)
    H, W, _, _, chunk, timed = SCALES[scale]

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    sst = cca.shard_state(cfg, st, mesh)
    sst = cca.run_chunk_body(cfg, app, sst)       # build + warm
    sync()
    compile_s = time.perf_counter() - t0
    mesh.transport.barrier()
    t0 = time.perf_counter()
    for _ in range(timed):
        sst = cca.run_chunk_body(cfg, app, sst)
    sync()
    mesh.transport.barrier()
    wall = time.perf_counter() - t0
    cycles = timed * cfg.chunk
    return dict(devices=mesh.size, grid=f"{H}x{W}", chunk=cfg.chunk,
                timed_chunks=timed, compile_s=round(compile_s, 4),
                wall_s=round(wall, 6),
                cell_cycles_per_s=round(H * W * cycles / wall, 1),
                card=card_name(), transport=mesh.transport.name)


def run_local(scale: str, device_counts=(1, 2, 4, 8), device=None) -> list:
    """Rows for ``LocalTiles`` meshes of each count, in this process."""
    from repro_torch.launch.mesh import make_host_mesh
    return [time_rows(scale, make_host_mesh(d, 1, device=device))
            for d in device_counts]


def process_group_row(scale: str) -> dict | None:
    """This process's share of a row over the default process group
    (joined already); the row on rank 0, ``None`` elsewhere."""
    from repro_torch.dist.ctx import Mesh
    from repro_torch.dist.transport import ProcessGroupTiles
    tr = ProcessGroupTiles()
    row = time_rows(scale, Mesh((tr.world, 1), ("data", "model"), tr))
    return row if tr.rank == 0 else None


def _gloo_worker(scale: str, rank: int, world: int, init: str) -> None:
    from repro_torch.dist.transport import ProcessGroupTiles
    ProcessGroupTiles.connect(init, rank, world, backend="gloo")
    try:
        row = process_group_row(scale)
        if row is not None:
            print(json.dumps(row), flush=True)
    finally:
        ProcessGroupTiles.close()


def run_gloo(scale: str, world: int, timeout_s: float = 900.0) -> dict:
    """One row over ``world`` gloo processes on the CPU, spawned here."""
    with tempfile.TemporaryDirectory() as tmp:
        init = f"file://{tmp}/store"
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
        procs = [subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dist_bench",
             "--scale", scale, "--gloo-rank", str(r), "--gloo", str(world),
             "--init", init], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env=env) for r in range(world)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=timeout_s))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        for p, (o, e) in zip(procs, outs):
            if p.returncode:
                raise RuntimeError(f"gloo rank failed:\n{e[-2000:]}")
        return json.loads(outs[0][0].splitlines()[-1])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", default="ci", choices=sorted(SCALES))
    ap.add_argument("--devices", type=int, nargs="*", default=[1, 2, 4, 8])
    ap.add_argument("--device", default=None,
                    help="LocalTiles' device (default: the card)")
    ap.add_argument("--gloo", type=int, default=0,
                    help="one gloo process a rank on the CPU, this many")
    ap.add_argument("--gloo-rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--init", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--torchrun", action="store_true",
                    help="one NCCL process a card under torchrun")
    ap.add_argument("--out", default=None, help="write the rows here")
    args = ap.parse_args()
    if args.gloo_rank is not None:
        _gloo_worker(args.scale, args.gloo_rank, args.gloo, args.init)
        return
    if args.torchrun:
        from repro_torch.dist.transport import ProcessGroupTiles
        ProcessGroupTiles.connect(
            "env://", int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
            backend="nccl")
        try:
            row = process_group_row(args.scale)
        finally:
            ProcessGroupTiles.close()
        rows = [row] if row is not None else []
    elif args.gloo:
        rows = [run_gloo(args.scale, args.gloo)]
    else:
        rows = run_local(args.scale, tuple(args.devices), args.device)
    for row in rows:
        print(json.dumps(row), flush=True)
    if args.out and rows:
        p = pathlib.Path(args.out)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(dict(scale=args.scale, rows=rows), indent=1))


if __name__ == "__main__":
    main()
