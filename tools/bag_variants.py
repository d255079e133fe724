"""The old and the new EmbeddingBag kernel, timed in turns on one NVIDIA
card at DLRM-RM2's shapes.

    python3 tools/bag_variants.py

Builds ``csrc/embedding_bag.cu`` five ways, with one nvcc each, started
together, the last three from a copy of ``csrc/`` under
``build/bag_variants/`` with its text patched:

  new          as committed: the tile kernel, several bags a warp, every
               row load of a tile in flight before the first add, the
               tiles field by field
  old          with ``-DBAG_WARP_PER_BAG``: the first port's kernel (one
               warp a bag, lanes over the columns, one lookup at a time),
               the only way to reach it
  batch order  the tiles in memory order (bag b F + f), every field at
               once
  load16, load64
               ``LOAD_FLOATS`` 16 and 64: a half and twice the committed
               32 row floats in flight a lane (2 and 8 bags a tile at
               D = 64, L = 4, against 4; more cannot add a bag there, a
               tile holding at most 32 indices)

draws DLRM-RM2's 26 full tables on the card (36.8 GB, as
``chip_smoke.py``'s phase 10) and, at serve_p99 (B = 512) and serve_bulk
(B = 262,144), holds every variant to the plain version (1e-5 x max(1,
max |ref|)) and to ``ref.embedding_bags_ordered`` bit for bit (so old and
new are equal bit for bit), then times old and new in turns (old, new,
new, old), and each other variant in turns with new: the tuning builds,
and the new kernel in the other warp shapes the C entry takes at D = 64,
L = 4 (float2 on a warp, scalar lanes, the chunked kernel).  Beside them:
each one's device time from a CUDA graph of its one launch replayed, the
plain version, ``F.embedding_bag`` once a table (26 calls), the byte
bound and the gather floor; at serve_p99 the wrapper's host time a call
over prepared tables (``ops.prepare_tables``, as DLRM serves) and over a
list of them, and its parts (the list's key, the cached checks, the
output's allocation, the stream, the C entry through ctypes).  Prints the ptxas
registers and spills of
each build's kernel at RM2's shape, and ends with one JSON line of the
numbers.  Needs one card; about two minutes.
"""
import functools
import json
import pathlib
import re
import shutil
import subprocess
import sys
import time
from unittest import mock

import torch
import torch.nn.functional as F

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs.base import recsys_shapes  # noqa: E402
from repro_torch.configs.recsys_archs import DLRM_RM2  # noqa: E402
from repro_torch.data.pipeline import (RecSysBatchSpec,  # noqa: E402
                                       recsys_batch)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.embedding_bag import ops  # noqa: E402
from repro_torch.kernels.embedding_bag.ref import (  # noqa: E402
    embedding_bags_ordered, embedding_bags_ref)
from repro_torch.models import dlrm  # noqa: E402

BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (data sheet, 700 W)
L2_BYTES = 50e6              # H100 L2
LOAD = "constexpr int LOAD_FLOATS = 32;"
PATCHES = {   # variant: [(text in the source, its replacement), ...]
    "batch order": [
        ("  return F * ((n_bags / F + NB - 1) / NB);",
         "  return (n_bags + NB - 1) / NB;"),
        ("""  const long long B = n_bags / F, per_field = (B + NB - 1) / NB;
  const int f = (int)(t / per_field);
  const long long b0 = (t - f * per_field) * NB;
  return {b0 * F + f, F, min((long long)NB, B - b0), f};""",
         """  const long long first = t * NB;
  return {first, 1, min((long long)NB, n_bags - first), (int)(first % F)};"""),
        ("""  const float* const tab = tables[tl.f];
  const long long V = vocabs[tl.f];
  bool live[R];""", """  const float* tab[R];
  long long V[R];
  bool live[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int f = (tl.f + r * G + g) % F;
    tab[r] = tables[f];
    V[r] = vocabs[f];
  }"""),
        ("take_row(ix, V) : -1;", "take_row(ix, V[r]) : -1;"),
        ("gather<VEC>(tab, row,", "gather<VEC>(tab[r], row,"),
        ("""  const float* table = tables[tl.f];
  const long long V = vocabs[tl.f];""", """  const int f = (tl.f + g) % F;
  const float* table = tables[f];
  const long long V = vocabs[f];""")],
    "load16": [(LOAD, "constexpr int LOAD_FLOATS = 16;")],
    "load64": [(LOAD, "constexpr int LOAD_FLOATS = 64;")],
}


def variant_source(name: str) -> pathlib.Path:
    """A copy of ``csrc/`` with ``PATCHES[name]`` applied; its .cu path."""
    csrc = ROOT / "build" / "bag_variants" / name.replace(" ", "_") / "csrc"
    if csrc.exists():
        shutil.rmtree(csrc)
    shutil.copytree(ops.SOURCE.parent, csrc)
    text = (csrc / ops.SOURCE.name).read_text()
    for old, new in PATCHES[name]:
        if text.count(old) != 1:
            raise SystemExit(f"{name}: {old!r} is not in the source once")
        text = text.replace(old, new)
    (csrc / ops.SOURCE.name).write_text(text)
    return csrc / ops.SOURCE.name


def builders() -> dict:
    """{variant: a function that builds its library}."""
    return {"new": functools.partial(ops.build, ()),
            "old": functools.partial(ops.build, ("-DBAG_WARP_PER_BAG",)),
            **{name: functools.partial(_build.build, variant_source(name),
                                       ops.NVCC_FLAGS) for name in PATCHES}}


def with_load_floats(g: "ops.Geometry", n: int) -> "ops.Geometry":
    """``g`` with the rounds a tile of a build whose LOAD_FLOATS is n."""
    with mock.patch.object(ops, "LOAD_FLOATS", n):
        return g._replace(rounds=ops.tile_rounds(g.lanes, g.vec, g.lt))


def cuda_ms(fn, reps=20) -> float:
    fn()
    a, b = (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))
    torch.cuda.synchronize()
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def graph_ms(fn, reps=50) -> float:
    """Device time of ``fn``'s launch: a CUDA graph of one call, captured
    after a warm call, replayed ``reps`` times between two events."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    return cuda_ms(g.replay, reps)


def in_turns(old, new) -> dict:
    """{"old": [ms, ms], "new": [ms, ms]}, timed old, new, new, old."""
    out = {"old": [], "new": []}
    for which in ("old", "new", "new", "old"):
        out[which].append(cuda_ms(old if which == "old" else new))
    return out


def same_bits(name, got, want) -> None:
    nan = torch.isnan(want)
    if not (torch.equal(torch.isnan(got), nan) and torch.equal(
            got.view(torch.int32)[~nan], want.view(torch.int32)[~nan])):
        raise AssertionError(f"{name}: not the bits of the ordered sum")


def runner(lib, tables, idx, shape=None):
    """One launch of ``ops.launch`` through the library ``lib``."""
    def run():
        with mock.patch.object(ops, "_library", lambda: lib):
            return ops.launch(tables, idx, shape=shape)
    return run


def host_us(fn, reps=2000) -> float:
    """Host microseconds a call of ``fn``, by the host clock over ``reps``
    calls that do not wait for the card."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * dt / reps


def host_breakdown(tables, idx) -> dict:
    """The wrapper's host time a call at ``idx``'s shape, and its parts."""
    dev = idx.device
    B, Fn, L = idx.shape
    meta, D = tables.meta, tables.D
    listed = list(tables)
    out = torch.empty((B, Fn, D), device=dev)
    g = ops.geometry(D, L)
    lib = ops._library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    c_entry = functools.partial(
        lib.embedding_bag_launch, meta.data_ptr(), meta.data_ptr() + 8 * Fn,
        idx.data_ptr(), None, out.data_ptr(), B * Fn, Fn, L, D, 0, *g,
        stream)
    return {"call": host_us(lambda: ops.embedding_bags(tables, idx)),
            "call over a list": host_us(
                lambda: ops.embedding_bags(listed, idx)),
            "all checks": host_us(
                lambda: ops._check(tables, idx, None, "sum")),
            "a list's key": host_us(lambda: ops._key(listed)),
            "a list's key and cached checks": host_us(
                lambda: ops._checked(ops._key(listed), dev)),
            "torch.empty": host_us(
                lambda: torch.empty((B, Fn, D), device=dev)),
            "current_stream": host_us(
                lambda: torch.cuda.current_stream(dev).cuda_stream),
            "current_device": host_us(torch.cuda.current_device),
            "C entry (ctypes, launch)": host_us(c_entry)}


def ptxas_line(name, report) -> dict:
    """The registers and spills of the build's kernel at RM2's shape."""
    pat = r"bag_kernelILb0E" if name == "old" else \
        r"bag_tile_kernelILi16ELi4ELi4E"
    for fn, info in _build.ptxas_functions(report).items():
        if re.search(pat, fn):
            print(f"{name}: {fn}: {info.get('registers')} registers, "
                  f"{info.get('spill_stores')} / {info.get('spill_loads')} "
                  f"bytes spill stores / loads", flush=True)
            return info
    raise AssertionError(f"{name}: no ptxas report for {pat}")


def bag_bytes(tables, idx) -> tuple[int, int, int]:
    """(the bound's bytes: indices, the distinct rows, the output; the
    gather floor's: the same with every lookup into a table larger than
    the L2 counted; the distinct rows)."""
    B, Fn, L = idx.shape
    D = tables[0].shape[1]
    distinct = floor_rows = 0
    for f, t in enumerate(tables):
        n = int(torch.unique(idx[:, f]).numel())
        distinct += n
        floor_rows += B * L if t.numel() * 4 > L2_BYTES else n
    common = idx.numel() * 4 + B * Fn * D * 4
    return common + distinct * D * 4, common + floor_rows * D * 4, distinct


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("bag_variants: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    todo = builders()
    builds = _build.build_all(list(todo.values()))
    libs = {n: ops.load(b[0]) for n, b in zip(todo, builds)}
    ptxas = {n: ptxas_line(n, b[1]) for n, b in zip(todo, builds)}

    dev = torch.device("cuda")
    cfg = DLRM_RM2
    params = dlrm.prepare_dlrm_params(dlrm.init_dlrm_params(
        cfg, torch.Generator(device=dev).manual_seed(7)))
    tables = params["tables"]
    shapes = {s.name: s for s in recsys_shapes()}
    D, L = cfg.embed_dim, cfg.lookups_per_field
    geo = ops.geometry(D, L)
    others = {"float2 warp": ops.geometry(D, L, 8),
              "scalar lanes": ops.geometry(D, L, 4),
              "chunked": ops.Geometry(16, 4, 0, 1)}
    rows = []
    for name in ("serve_p99", "serve_bulk"):
        b = recsys_batch(RecSysBatchSpec(
            shapes[name].dim("batch"), cfg.n_dense, cfg.n_sparse, L,
            cfg.resolved_vocabs()), 0)
        idx = torch.from_numpy(b["sparse"]).to(dev)
        want = embedding_bags_ref(tables, idx)
        ordered = embedding_bags_ordered(tables, idx)
        scale = max(1.0, float(want.abs().max()))
        runs = {"old": runner(libs["old"], tables, idx),
                "new": runner(libs["new"], tables, idx),
                "batch order": runner(libs["batch order"], tables, idx),
                **{k: runner(libs[k], tables, idx,
                             with_load_floats(geo, int(k[4:])))
                   for k in ("load16", "load64")}}
        runs.update({k: runner(libs["new"], tables, idx, g)
                     for k, g in others.items()})
        for k, fn in runs.items():
            got = fn()
            err = float((got - want).abs().max())
            if not err <= 1e-5 * scale:
                raise AssertionError(f"{k} {name}: max |d| {err}")
            same_bits(f"{k} {name}", got, ordered)
            del got
        del want, ordered
        turns = in_turns(runs["old"], runs["new"])
        tuned = {k: in_turns(runs[k], runs["new"]) for k in runs
                 if k not in ("old", "new")}
        graph = {k: graph_ms(fn) for k, fn in runs.items()}
        fields = [idx[:, f].long() for f in range(idx.shape[1])]
        lib_ms = cuda_ms(lambda: [F.embedding_bag(fields[f], t, mode="sum")
                                  for f, t in enumerate(tables)])
        plain_ms = cuda_ms(lambda: embedding_bags_ref(tables, idx), 3)
        nbytes, floor_bytes, distinct = bag_bytes(tables, idx)
        new = sum(turns["new"]) / 2
        row = dict(shape=name, B=idx.shape[0], geometry=list(geo),
                   distinct_rows=distinct, ms=turns, tuning=tuned,
                   graph_ms=graph, plain_ms=plain_ms, library_ms=lib_ms,
                   bound_ms=1e3 * nbytes / BYTES_PER_S,
                   gather_floor_ms=1e3 * floor_bytes / BYTES_PER_S,
                   equal_bits=True)
        rows.append(row)
        print(f"{name} (B={idx.shape[0]}, {distinct} distinct rows): old "
              f"{turns['old'][0]:.4f} / {turns['old'][1]:.4f} ms, new "
              f"{tuple(geo)} {turns['new'][0]:.4f} / {turns['new'][1]:.4f} "
              f"ms ({sum(turns['old']) / 2 / new:.2f}x), equal bit for bit "
              f"(and to the ordered sum); bound {row['bound_ms']:.4f} ms "
              f"({100 * row['bound_ms'] / new:.1f}% of it), gather floor "
              f"{row['gather_floor_ms']:.4f} ms; plain {plain_ms:.3f} ms, "
              f"F.embedding_bag x{len(tables)} {lib_ms:.4f} ms", flush=True)
        for k, t in tuned.items():
            print(f"  {k}: {t['old'][0]:.4f} / {t['old'][1]:.4f} ms against "
                  f"new {t['new'][0]:.4f} / {t['new'][1]:.4f}", flush=True)
        print("  device time, a CUDA graph of one launch replayed: "
              + ", ".join(f"{k} {v:.4f}" for k, v in graph.items()) + " ms",
              flush=True)
        if name == "serve_p99":
            row["host_us"] = host_breakdown(tables, idx)
            print("  host us a call: " + ", ".join(
                f"{k} {v:.2f}" for k, v in row["host_us"].items()),
                flush=True)
        del runs, fields
        torch.cuda.empty_cache()
    print(json.dumps({"card": smi, "ptxas": ptxas, "shapes": rows}))


if __name__ == "__main__":
    main()
