"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's main path -- ``StreamingEngine.seed -> run_increment ->
values`` for BFS, every chunk one launch of the hand-written CUDA cycle
kernel -- and fails (uncaught exception, non-zero exit) if any phase does:

  1. device: the card's name and power limit; no CUDA device -> exit 1
  2. build: nvcc for sm_90a, with the ptxas register/spill report
  3. kernel vs plain PyTorch version on the card, every leaf and the
     launch record exactly equal (tolerance 0): (a) the pinned 8x8 config
     chunk by chunk to quiescence, (b) three mid-stream states of the
     2000-vertex stream on the 32x32 paper config, one K=512 chunk each
  4. fingerprints through the kernel: tests/data/pre_lanes_reference.json
     and src/repro_torch/data/fingerprint_32x32.json, exactly
  5. the paper's 50K-vertex / 1M-edge stream (10 edge-sampled increments)
     on the paper config, BFS values exactly the oracle's
  6. the kernels line (JSON), then the ok line (JSON, last)
"""
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import EngineConfig, StreamingEngine  # noqa: E402
from repro_torch.core.apps import BFS  # noqa: E402
from repro_torch.core.ingest import load_stream  # noqa: E402
from repro_torch.core.reference import bfs_levels  # noqa: E402
from repro_torch.graph.streams import StreamSpec, make_stream  # noqa: E402
from repro_torch.kernels.cca_cycle import ops  # noqa: E402
from repro_torch.kernels.cca_cycle.ref import cca_cycle_chunk_ref  # noqa: E402

H100_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (data sheet, 700 W)
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


def kernel_vs_plain(cfg, app, st, n_cycles=None):
    """One chunk through the kernel and the plain version from the same
    input; returns the max abs difference (0) or raises."""
    sk, ck = ops.cca_cycle_chunk(cfg, app, clone(st), n_cycles)
    sr, cr = cca_cycle_chunk_ref(cfg, app, st, n_cycles)
    torch.cuda.synchronize()
    if not torch.equal(ck, cr):
        raise AssertionError(f"launch record {ck.tolist()} != {cr.tolist()}")
    return leaf_diff(sk, sr), sr, bool(cr[0])


def fresh_stats(st):
    z = torch.zeros((), dtype=torch.int32, device=st.aq.device)
    return st._replace(stat_hops=z.clone(), stat_exec=z.clone(),
                       stat_stall=z.clone(), stat_allocs=z.clone())


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


def main() -> None:
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

    # ---- 2. build ----
    t0 = time.time()
    lib, report = ops.build()
    print(f"[build] {lib.name} in {time.time() - t0:.1f}s")
    for line in report.splitlines():
        if any(w in line for w in ("registers", "spill", "smem", "stack")):
            print("  ptxas:", line.strip())

    # ---- 3a. kernel vs plain, pinned 8x8, chunk by chunk ----
    pinned = json.loads((ROOT / "tests" / "data"
                         / "pre_lanes_reference.json").read_text())
    eng = StreamingEngine(EngineConfig(**pinned["cfg"]), "bfs")
    eng.seed(0, 0.0)
    cfg, st, chunks, worst = eng.cfg, eng.state, 0, 0.0
    for e in make_stream(StreamSpec(**pinned["spec"])):
        st, spill = load_stream(cfg, st, e)
        assert len(spill) == 0
        st, q = fresh_stats(st), False
        while not q:
            d, st, q = kernel_vs_plain(cfg, BFS, st)
            worst, chunks = max(worst, d), chunks + 1
    print(f"[3a] 8x8 pinned: kernel == plain on every leaf over {chunks} "
          f"chunks (max |d| {worst})", flush=True)

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
            d, sr, q = kernel_vs_plain(eng.cfg, BFS, fresh_stats(st), 512)
            worst = max(worst, d)
            print(f"[3b] 32x32 ci increment {i}: one K=512 chunk, kernel == "
                  f"plain on every leaf (cycle {int(sr.cycle)}, quiescent "
                  f"{q}, {time.time() - t0:.1f}s)", flush=True)
        eng.run_increment(e, max_cycles=2_000_000)
    want = bfs_levels(ci["n_vertices"], np.concatenate(incs), 0)
    assert (eng.values() == want).all(), "32x32 ci BFS != oracle"

    # ---- 4. fingerprints through the kernel ----
    rows, vals = replay(pinned)
    assert rows == pinned["backends"]["jnp"]["increments"], rows
    assert (vals == np.float32(pinned["backends"]["jnp"]["values"])).all()
    print("[4] pinned 8x8 fingerprint reproduced exactly")
    fp = json.loads((ROOT / "src" / "repro_torch" / "data"
                     / "fingerprint_32x32.json").read_text())
    rows, vals = replay(fp)
    want_rows = [{k: r[k] for k in ("cycles", "hops", "execs", "stalls",
                                     "allocs")} for r in fp["increments"]]
    assert rows == want_rows, rows
    assert (vals == np.float32(fp["values"])).all()
    print(f"[4] 32x32 fingerprint reproduced exactly "
          f"({sum(r['cycles'] for r in rows)} cycles)", flush=True)

    # ---- 5. the paper's stream at full size, through the kernel ----
    t0 = time.time()
    incs = make_stream(StreamSpec(increments=10, sampling="edge", seed=1,
                                  **PAPER_FULL))
    print(f"[5] stream generated in {time.time() - t0:.1f}s: "
          f"{sum(len(e) for e in incs)} edges", flush=True)
    cfg_p = paper_cfg(**PAPER_FULL)
    eng = StreamingEngine(cfg_p, "bfs")
    eng.seed(0, 0.0)
    events = []
    launch = ops.cca_cycle_chunk

    def timed_chunk(*a, **kw):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = launch(*a, **kw)
        ev[1].record()
        events.append(ev)
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.cca_cycle_chunk = timed_chunk
    ops.launches = 0
    t0 = time.time()
    cycles = 0
    snapshot = None
    for i, e in enumerate(incs):
        if i == len(incs) - 1:
            snapshot = clone(eng.state)
        r = eng.run_increment(e, max_cycles=2_000_000)
        cycles += r.cycles
        print(f"  increment {i}: {len(e)} edges, {r.cycles} cycles, "
              f"{r.hops} hops, {r.execs} execs, {r.stalls} stalls, "
              f"{r.allocs} allocs", flush=True)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = ops.launches
    ops.cca_cycle_chunk = launch
    if launches == 0:
        raise AssertionError("the main path launched no cycle kernel")
    kern_ms = sum(a.elapsed_time(b) for a, b in events)
    peak = torch.cuda.max_memory_allocated()
    got = eng.values()
    want = bfs_levels(PAPER_FULL["n_vertices"], np.concatenate(incs), 0)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert (got == want).all(), "paper-scale BFS != oracle"
    cells = cfg_p.n_cells
    print(f"[5] 50K/1M paper stream: {cycles} cycles in {wall:.3f}s wall "
          f"(host clock, ends in synchronize) = "
          f"{cycles * cells / wall:.4g} cell-cycles/s; {launches} launches, "
          f"{kern_ms / launches:.4f} ms per launch by CUDA events "
          f"({1e6 * kern_ms / cycles:.1f} ns per machine cycle); peak "
          f"{peak / 2**20:.1f} MiB allocated; BFS == oracle", flush=True)

    # ---- 6. one K=512 chunk at full size: kernel, plain, bound ----
    st, _ = load_stream(cfg_p, snapshot, incs[-1])
    st = fresh_stats(st)
    mutable = sum(t.numel() * t.element_size()
                  for k, t in st._asdict().items() if k != "io_edges")

    def time_chunk(fn):
        s = clone(st)
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        a.record()
        s2, qr = fn(cfg_p, BFS, s, 512)
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b), s2, qr

    t_plain, s_plain, q_plain = time_chunk(cca_cycle_chunk_ref)
    t_kern, s_kern, q_kern = time_chunk(launch)
    ran = int(q_kern[1])
    d = leaf_diff(s_kern, s_plain)
    assert torch.equal(q_kern, q_plain)
    consumed = int((s_kern.io_pos - st.io_pos).sum()) * 3 * 4
    bound_ms = 1e3 * (2 * mutable + consumed) / H100_BYTES_PER_S
    print(f"[6] full-size chunk ({ran} cycles): kernel {t_kern:.4f} ms, "
          f"plain {t_plain:.1f} ms, bound {bound_ms:.4f} ms (2 x "
          f"{mutable / 2**20:.1f} MiB mutable state over 3.35 TB/s); "
          f"kernel == plain (max |d| {d})", flush=True)

    print(json.dumps({"kernels": [{
        "name": "cca_cycle_chunk", "route": "cuda",
        "source": "src/repro_torch/kernels/cca_cycle/csrc/cca_cycle.cu",
        "replaces": "src/repro/kernels/cca_cycle/kernel.py:43",
        "replaces_wrapper": "repro/kernels/cca_cycle/ops.py::cca_cycle_chunk",
        "launches": launches, "equal_to_plain": True,
        "max_abs_err": max(worst, d), "ms": t_kern,
        "ms_per_launch": kern_ms / launches, "plain_ms": t_plain,
        "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None,
        "chunk_cycles": ran, "card": smi}]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind, "count": count}}))


if __name__ == "__main__":
    main()
