"""Where a machine cycle's time goes in the cycle kernels, on one NVIDIA card.

    python3 tools/cca_cycle_variants.py [--configs paper,ci,fingerprint,pinned]
                                        [--paths block,cluster] [--faults]

Builds ``src/repro_torch/kernels/cca_cycle/csrc/`` six ways, one nvcc
each, started together (the last three from a patched copy of ``csrc/``
under ``build/cca_cycle_variants/``, git-ignored):

  kernel         as committed
  clocks         -DCCA_PHASE_CLOCKS: thread 0 of each CTA sums clock64()
                 stamps over the phases of a launch: the quiescence test,
                 the read and the write of each hop direction N, S, W, E,
                 exec (staging, phase 0, io), and the prologue / epilogue
  skeleton       -DCCA_PHASE_CLOCKS -DCCA_SKELETON: the same loop with its
                 phases emptied (no cell work, every barrier kept), run
                 for all K cycles: the floor of the barrier schedule
  pow2_div       floor division and modulo by a power of two as a shift
                 and a mask (the grid width, Q, LC and FQ of the paper
                 config): what the integer divisions cost
  prefetch_exec  at the start of each cycle, an L1 prefetch of the slot
                 lines exec will read: what exec's device-memory latency
                 costs
  no_unroll      the four hop rounds as a loop, not unrolled: what the
                 code size costs

and runs each on one K-cycle chunk of each config's state: the first
three for the one-block kernel and the chosen cluster geometry, the
design patches for the chosen cluster geometry, the committed kernel for
every other cluster size that fits:

  paper        the 50K-vertex / 1M-edge paper stream's last increment,
               loaded into the state the first nine left (as
               ``chip_smoke.py``'s phase 6), K = 512
  ci           the 2000-vertex ci stream at increment 5 (phase 3b), K = 512
  fingerprint  the 32x32 fingerprint config (``src/repro_torch/data/
               fingerprint_32x32.json``) at the middle increment, K = 512
  pinned       the pinned 8x8 config (``tests/data/
               pre_lanes_reference.json``) at its first increment, K = 64

Every kernel and clocks variant is held equal to the plain version
(every leaf, the launch record) before it is timed; the skeleton computes
nothing and must run all K cycles.  Times are CUDA events around single
launches from fresh copies of the state, in two passes (the variants in
turn, then in reverse).  Prints the card's name and power limit, each
variant's ms a launch and ns a machine cycle, and the mean SM clocks a
cycle in each phase (CTA 0's thread 0; phase sums over the launch divided
by the cycles run; the quiescence test runs once more than the cycles).
Ends with one JSON line of the numbers.  ``--faults`` runs every config
under a zero-rate fault plan (``FaultPlan(seed=7)``: the kernels' fault
instances, every message sealed and checked, nothing injected), for the
phases the fault branch costs against a run without it.  Needs one card.
"""
import argparse
import ctypes
import dataclasses
import json
import pathlib
import shutil
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import (PAPER_FULL, clone, fresh_stats,  # noqa: E402
                        leaf_diff, paper_cfg)
from repro_torch.core import EngineConfig, StreamingEngine  # noqa: E402
from repro_torch.core.apps import BFS  # noqa: E402
from repro_torch.core.ingest import load_stream  # noqa: E402
from repro_torch.graph.streams import StreamSpec, make_stream  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.cca_cycle import ops  # noqa: E402
from repro_torch.kernels.cca_cycle.ref import cca_cycle_chunk_ref  # noqa: E402
from repro_torch.resilience import FaultPlan  # noqa: E402

POW2_DIV = [
    ("__device__ __forceinline__ int fdiv(int a, int b) {\n",
     "__device__ __forceinline__ int fdiv(int a, int b) {\n"
     "  if (b > 0 && (b & (b - 1)) == 0) return a >> (__ffs(b) - 1);\n"),
    ("__device__ __forceinline__ int fmod_(int a, int b) {\n",
     "__device__ __forceinline__ int fmod_(int a, int b) {\n"
     "  if (b > 0 && (b & (b - 1)) == 0) return a & (b - 1);\n")]
PREFETCH_FN = """template <class T>
__device__ __forceinline__ void pf(const T* p) {
  asm volatile("prefetch.global.L1 [%0];" :: "l"(p));
}
template <class C>
__device__ void prefetch_exec(const Dims& D, const Leaves& P, const C& X,
                              int c) {
  int l = X.l(c), dst;
  if (X.cvalid[l]) dst = X.cmsg[l * MSGW + 1];
  else if (X.aq_n[l] > 0)
    dst = X.aq[((size_t)l * D.Q + fmod_(X.aq_head[l], D.Q)) * MSGW + 1];
  else return;
  size_t idx = (size_t)c * D.S + fmod_(dst, D.S);
  pf(P.vals + idx); pf(P.nedges + idx); pf(P.gstate + idx);
  pf(P.gaddr + idx); pf(P.rstate + idx); pf(P.fq_n + idx);
  pf(P.fq_head + idx); pf(P.rhz_on + idx); pf(P.fwd_pending + idx);
  pf(P.fwd_val + idx); pf(P.edst + idx * D.E); pf(P.ew + idx * D.E);
}

"""
CYCLE_TOP = "    if (quiet || ran == D.n_cycles) break;\n"
PREFETCH_EXEC = [
    ("// Sum over cell c's slots", PREFETCH_FN + "// Sum over cell c's slots"),
    (CYCLE_TOP, CYCLE_TOP + "    for (int c = first; c < end; c += nt) "
                            "prefetch_exec(D, P, X, c);\n")]
NO_UNROLL = [("#pragma unroll\n    for (int d = 0; d < 4; ++d) {",
              "#pragma unroll 1\n    for (int d = 0; d < 4; ++d) {")]
# build: (extra nvcc flags, text patches of cca_cycle.cu)
BUILDS = {"kernel": ((), []),
          "clocks": (("-DCCA_PHASE_CLOCKS",), []),
          "skeleton": (("-DCCA_PHASE_CLOCKS", "-DCCA_SKELETON"), []),
          "pow2_div": ((), POW2_DIV),
          "prefetch_exec": ((), PREFETCH_EXEC),
          "no_unroll": ((), NO_UNROLL)}
PROBES = ("kernel", "clocks", "skeleton")
PHASES = ("quiescence", "N read", "N write", "S read", "S write", "W read",
          "W write", "E read", "E write", "exec", "prologue", "epilogue")
N_CTAS, N_PHASES = 16, 12


def source(name: str) -> pathlib.Path:
    """The .cu file of build ``name``: the committed one, or a patched
    copy of ``csrc/``."""
    patches = BUILDS[name][1]
    if not patches:
        return ops.SOURCE
    csrc = ROOT / "build" / "cca_cycle_variants" / name / "csrc"
    if csrc.exists():
        shutil.rmtree(csrc)
    shutil.copytree(ops.SOURCE.parent, csrc)
    cu = csrc / ops.SOURCE.name
    text = cu.read_text()
    for old, new in patches:
        if text.count(old) != 1:
            raise SystemExit(f"{name}: the patched text is not in "
                             f"{cu.name} once")
        text = text.replace(old, new)
    cu.write_text(text)
    return cu


def libraries() -> dict:
    """{build name: (ctypes library, ptxas report)}."""
    srcs = {name: source(name) for name in BUILDS}
    built = _build.build_all([
        lambda n=n: _build.build(srcs[n], ops.NVCC_FLAGS + BUILDS[n][0])
        for n in BUILDS])
    out = {}
    for name, (path, report) in zip(BUILDS, built):
        lib = ops.load(path)
        if BUILDS[name][0]:
            lib.cca_cycle_clocks.argtypes = [ctypes.c_void_p]
            lib.cca_cycle_clocks.restype = ctypes.c_int
        out[name] = (lib, report)
    return out


def json_cfg(path: pathlib.Path):
    ref = json.loads(path.read_text())
    fields = EngineConfig.__dataclass_fields__
    return ref, EngineConfig(**{k: v for k, v in ref["cfg"].items()
                                if k in fields})


def engine_state(cfg, incs, at, dev):
    """The state after increments ``[0, at)``, with increment ``at``
    loaded and the stats zeroed."""
    eng = StreamingEngine(cfg, "bfs", device=dev)
    eng.seed(0, 0.0)
    for e in incs[:at]:
        eng.run_increment(e, max_cycles=2_000_000)
    st, _ = load_stream(cfg, clone(eng.state), incs[at])
    return fresh_stats(st)


def config_states(names, dev, faults=None) -> dict:
    """{config: (cfg, state, K)} for the named configs, built on the card
    through the one-block kernel, each under the fault plan ``faults``."""
    out = {}

    def with_faults(cfg):
        return dataclasses.replace(cfg, faults=faults)

    with mock.patch.object(ops, "cluster_geometry", lambda *a, **k: None):
        if "paper" in names:
            incs = make_stream(StreamSpec(increments=10, sampling="edge",
                                          seed=1, **PAPER_FULL))
            cfg = with_faults(paper_cfg(**PAPER_FULL))
            out["paper"] = (cfg, engine_state(cfg, incs, 9, dev), 512)
        if "ci" in names:
            ci = dict(n_vertices=2000, n_edges=20_000)
            incs = make_stream(StreamSpec(increments=10, sampling="edge",
                                          seed=1, **ci))
            cfg = with_faults(paper_cfg(**ci))
            out["ci"] = (cfg, engine_state(cfg, incs, 5, dev), 512)
        if "fingerprint" in names:
            ref, cfg = json_cfg(ROOT / "src" / "repro_torch" / "data"
                                / "fingerprint_32x32.json")
            cfg = with_faults(cfg)
            incs = make_stream(StreamSpec(**ref["spec"]))
            out["fingerprint"] = (cfg, engine_state(cfg, incs,
                                                    len(incs) // 2, dev),
                                  512)
        if "pinned" in names:
            ref, cfg = json_cfg(ROOT / "tests" / "data"
                                / "pre_lanes_reference.json")
            cfg = with_faults(cfg)
            incs = make_stream(StreamSpec(**ref["spec"]))
            out["pinned"] = (cfg, engine_state(cfg, incs, 0, dev), 64)
    return out


def launch(lib, cfg, st, K, path, n_ctas):
    """One launch through ``lib`` from a copy of ``st``: (state, record,
    ms by CUDA events)."""
    s = clone(st)
    a, b = (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))
    torch.cuda.synchronize()
    before = dict(ops.path_launches)
    with mock.patch.object(ops, "_library", lambda: lib):
        a.record()
        s, rec = ops.cca_cycle_chunk(cfg, BFS, s, K, path=path,
                                     n_ctas=n_ctas)
        b.record()
    torch.cuda.synchronize()
    if ops.path_launches[path] != before[path] + 1:
        raise RuntimeError(f"the launch did not take the {path} path")
    return s, rec, a.elapsed_time(b)


def phase_clocks(lib, n_ctas) -> np.ndarray:
    buf = (ctypes.c_longlong * (N_CTAS * N_PHASES))()
    err = lib.cca_cycle_clocks(buf)
    if err:
        raise RuntimeError(f"cca_cycle_clocks failed ({err})")
    return np.array(buf, dtype=np.int64).reshape(N_CTAS, N_PHASES)[
        :max(n_ctas, 1)]


def run_config(name, cfg, st, K, libs, paths) -> dict:
    t0 = time.time()
    sr, qr = cca_cycle_chunk_ref(cfg, BFS, st, K)
    plain_s = time.time() - t0
    ran = int(qr[1])
    geos = [g for n in range(1, N_CTAS + 1)
            if (g := ops.cluster_geometry(cfg, n))] if "cluster" in paths \
        else []
    chosen = ops.cluster_geometry(cfg)
    # (label, build, path, n_ctas)
    variants = []
    if "block" in paths:
        variants += [("block", b, "block", None) for b in PROBES]
    for n, rows, nbytes in geos:
        builds = BUILDS if chosen and n == chosen[0] else ("kernel",)
        variants += [(f"cluster{n}", b, "cluster", n) for b in builds]
    print(f"{name}: {cfg.height}x{cfg.width}, K={K}, the plain version "
          f"ran {ran} cycles (quiescent {bool(qr[0])}) in {plain_s:.1f}s; "
          f"cluster geometries that fit (n_ctas, rows, bytes a CTA): "
          f"{geos}; chosen {chosen}", flush=True)
    rows = {}
    for label, build, path, n in variants:
        lib = libs[build][0]
        s, rec, ms = launch(lib, cfg, st, K, path, n)
        row = dict(variant=label, build=build, n_ctas=n, ms=[ms])
        if build == "skeleton":
            if int(rec[1]) != K:
                raise AssertionError(f"{label} skeleton ran {rec.tolist()}")
            row["cycles"] = K
        else:
            if not torch.equal(rec.cpu(), qr.cpu()):
                raise AssertionError(f"{name} {label}/{build}: record "
                                     f"{rec.tolist()} != {qr.tolist()}")
            leaf_diff(s, sr)
            row["cycles"] = ran
            row["equal_to_plain"] = True
        if BUILDS[build][0]:
            clk = phase_clocks(lib, n or 1)
            cyc = max(row["cycles"], 1)
            row["clocks_per_cycle_cta0"] = dict(zip(
                PHASES[:10], (clk[0, :10] / cyc).round(1).tolist()))
            row["clocks_per_cycle_mean"] = dict(zip(
                PHASES[:10], (clk[:, :10].mean(0) / cyc).round(1).tolist()))
            row["prologue_epilogue_clocks"] = clk[0, 10:].tolist()
            row["clocks_total_cta0"] = int(clk[0].sum())
        rows[(label, build)] = row
    for order in (list(rows)[::-1], list(rows)):
        for key in order:
            label, build = key
            n = rows[key]["n_ctas"]
            path = "block" if label == "block" else "cluster"
            rows[key]["ms"].append(launch(libs[build][0], cfg, st, K,
                                          path, n)[2])
    for row in rows.values():
        best = min(row["ms"][1:])
        row["ns_per_cycle"] = 1e6 * best / max(row["cycles"], 1)
        line = (f"  {row['variant']:9s} {row['build']:13s} "
                f"{' / '.join(f'{m:.4f}' for m in row['ms'][1:])} ms "
                f"({row['ns_per_cycle']:.1f} ns a cycle)")
        if "clocks_total_cta0" in row:
            ghz = row["clocks_total_cta0"] / (best * 1e6)
            row["implied_sm_ghz"] = ghz
            line += f"; {ghz:.3f} SM clocks a ns"
        print(line, flush=True)
        if "clocks_per_cycle_cta0" in row:
            print("      clocks a cycle (CTA 0): " + ", ".join(
                f"{k} {v}" for k, v in row["clocks_per_cycle_cta0"].items()),
                flush=True)
            print(f"      prologue / epilogue clocks (CTA 0): "
                  f"{row['prologue_epilogue_clocks']}", flush=True)
    return dict(cfg=f"{cfg.height}x{cfg.width} Q={cfg.queue_cap} "
                    f"LC={cfg.lane_capacity} S={cfg.slots}",
                K=K, cycles=ran, plain_s=plain_s, geometries=geos,
                chosen=chosen, variants=list(rows.values()))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--configs", default="paper,ci,fingerprint,pinned")
    ap.add_argument("--paths", default="block,cluster")
    ap.add_argument("--faults", action="store_true",
                    help="every config under a zero-rate fault plan")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("cca_cycle_variants: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    t0 = time.time()
    libs = libraries()
    print(f"built {', '.join(BUILDS)} in {time.time() - t0:.1f}s",
          flush=True)
    for name, (_, report) in libs.items():
        for fn, info in _build.ptxas_functions(report).items():
            if "cca_cycle" in fn:
                print(f"  {name} {fn}: {info}", flush=True)
    names = args.configs.split(",")
    paths = args.paths.split(",")
    dev = torch.device("cuda")
    t0 = time.time()
    states = config_states(names, dev,
                           FaultPlan(seed=7) if args.faults else None)
    print(f"states built in {time.time() - t0:.1f}s", flush=True)
    result = {"card": smi, "faults": args.faults, "configs": {}}
    for name in names:
        cfg, st, K = states[name]
        result["configs"][name] = run_config(name, cfg, st, K, libs, paths)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
