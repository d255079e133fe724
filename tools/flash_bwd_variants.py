"""Register variants of the flash backward's dK/dV kernel, on one NVIDIA
card.

    python3 tools/flash_bwd_variants.py

Builds the flash-attention library as committed and three variants of
its backward (``src/repro_torch/kernels/flash_attention/csrc/
flash_attention_bwd.cuh``), each a text patch of a copy of ``csrc/``
under ``build/flash_bwd_variants/`` (git-ignored), one nvcc each, started
together:

  kernel          as committed: fa_bwd_dkdv is 8 warps, launch bound 256
  warps_9         fa_bwd_dkdv's launch bound 288 threads (the 9th warp a
                  producer warp would add; still launched with 256)
  setmaxnreg_240  launch bound 384 (a producer warpgroup's) and the
                  consumers' `setmaxnreg.inc 240` at their start, as a
                  producer warpgroup would hand them its registers; built
                  for ptxas's report only (with no warp giving registers
                  up, a launch would wait on the increase for ever)
  generic_loads   each column's lse and delta read through a generic
                  pointer instead of a 32-bit shared address

and prints, for each: ptxas's registers and spill bytes of fa_bwd_dkdv at
dh 16, 32, 64 and 128; for each but setmaxnreg_240, at the heads of
llama3.2-1b (32/8, dh 64) and phi3.5-moe (32/8, dh 128), B = 1, T =
4096, causal, bf16: the largest
entrywise excess of dq, dk and dv over the forward's bf16 limit (2e-2 x
(|ref| + median |ref|) against ``ref.flash_attention_bwd_ref``), and by
CUDA events the whole backward and its dK/dV launch alone, in two passes
(the variants in turn, then in reverse).  Ends with one JSON line of the
numbers.  Needs one card; about two minutes.
"""
import json
import pathlib
import re
import shutil
import subprocess
import sys
from unittest import mock

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_bwd_ref, flash_attention_fwd_ref)

HEADER = "flash_attention_bwd.cuh"
BOUND = "__global__ void __launch_bounds__(CONSUMERS, 1)\nfa_bwd_dkdv("
CONSUMER = "  // ---- two warpgroups, 64 keys each ----\n"
LOADS = ("            const float2 l2 = lds2(vl + 32 * c8), "
         "dl = lds2(vl + 4 * BN + 32 * c8);\n")
PATCHES = {   # variant: [(text in the header, its replacement)]
    "kernel": [],
    "warps_9": [(BOUND, BOUND.replace("CONSUMERS,", "CONSUMERS + 32,"))],
    "setmaxnreg_240": [
        (BOUND, BOUND.replace("CONSUMERS,", "CONSUMERS + 128,")),
        (CONSUMER, CONSUMER + '  asm volatile("setmaxnreg.inc.sync.aligned'
                              '.u32 240;\\n");\n')],
    "generic_loads": [(LOADS, (
        "            const float2* v2 = reinterpret_cast<const float2*>(\n"
        "                smem_raw + (vl - smem_u32(smem_raw)));\n"
        "            const float2 l2 = v2[4 * c8], dl = v2[BN / 2 + 4 * c8];\n"
    ))],
}
BUILT_ONLY = ("setmaxnreg_240",)
SHAPES = [("llama3.2-1b", 1, 4096, 32, 8, 64),
          ("phi3.5-moe", 1, 4096, 32, 8, 128)]


def variant_sources() -> dict:
    """A copy of ``csrc/`` per variant, patched; {name: .cu path}."""
    out = {}
    for name, patches in PATCHES.items():
        csrc = ROOT / "build" / "flash_bwd_variants" / name / "csrc"
        if csrc.exists():
            shutil.rmtree(csrc)
        shutil.copytree(fa.SOURCE.parent, csrc)
        text = (csrc / HEADER).read_text()
        for old, new in patches:
            if text.count(old) != 1:
                raise SystemExit(f"{name}: the patched text is not in "
                                 f"{HEADER} once")
            text = text.replace(old, new)
        (csrc / HEADER).write_text(text)
        out[name] = csrc / fa.SOURCE.name
    return out


def dkdv_ptxas(report: str) -> dict:
    """{dh: (registers, spill stores + loads in bytes)} of fa_bwd_dkdv."""
    out = {}
    for name, f in _build.ptxas_functions(report).items():
        if m := re.search(r"fa_bwd_dkdvILi(\d+)E", name):
            out[int(m[1])] = (f["registers"],
                              f["spill_stores"] + f["spill_loads"])
    return dict(sorted(out.items()))


def excess(got, want) -> float:
    d = (got.double() - want.double()).abs()
    w = want.double().abs()
    return float((d / (2e-2 * (w + float(w.median())))).max())


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


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("flash_bwd_variants: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    srcs = variant_sources()
    built = _build.build_all([lambda s=s: _build.build(s, fa.NVCC_FLAGS)
                              for s in srcs.values()])
    libs, result = {}, {"card": smi, "variants": {}}
    for name, (lib, report) in zip(srcs, built):
        if name not in BUILT_ONLY:
            libs[name] = fa.load(lib)
        result["variants"][name] = {"dkdv_ptxas": dkdv_ptxas(report),
                                    "shapes": []}
        print(f"{name}: fa_bwd_dkdv (registers, spill bytes) by dh "
              f"{result['variants'][name]['dkdv_ptxas']}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    for label, B, T, H, Kh, dh in SHAPES:
        gen.manual_seed(27)
        q, do = (torch.randn((B, T, H, dh), generator=gen, device=dev)
                 .bfloat16() for _ in range(2))
        k, v = (torch.randn((B, T, Kh, dh), generator=gen, device=dev)
                .bfloat16() for _ in range(2))
        o, lse = flash_attention_fwd_ref(q, k, v)
        want = flash_attention_bwd_ref(q, k, v, o, lse, do)
        runs, ex = {}, {}
        for name, lib in libs.items():
            with mock.patch.object(fa, "_library", lambda lib=lib: lib):
                bufs = fa.bwd_buffers(q, k, v)
            runs[name] = bufs
            with mock.patch.object(fa, "_library", lambda lib=lib: lib):
                fa.bwd_launch(q, k, v, o, lse, do, True, bufs)
            ex[name] = max(excess(a, w) for a, w in zip(bufs[:3], want))
        del want
        order = list(libs)
        ms = {n: {"all": [], "dkdv": []} for n in order}
        for names in (order, order[::-1]):
            for n in names:
                with mock.patch.object(fa, "_library", lambda n=n: libs[n]):
                    for part, bit in (("all", fa.BWD_ALL),
                                      ("dkdv", fa.BWD_DKDV)):
                        ms[n][part].append(cuda_ms(
                            lambda b=bit, n=n: fa.bwd_launch(
                                q, k, v, o, lse, do, True, runs[n], b)))
        print(f"{label} (B={B}, T={T}, H={H}, Kh={Kh}, dh={dh}):", flush=True)
        for n in order:
            row = dict(shape=label, dh=dh, excess=ex[n], ms=ms[n]["all"],
                       dkdv_ms=ms[n]["dkdv"])
            result["variants"][n]["shapes"].append(row)
            print(f"  {n}: backward {ms[n]['all'][0]:.4f} / "
                  f"{ms[n]['all'][1]:.4f} ms, dK/dV {ms[n]['dkdv'][0]:.4f} "
                  f"/ {ms[n]['dkdv'][1]:.4f} ms, {ex[n]:.3f} x the entrywise "
                  f"limit", flush=True)
        del q, k, v, o, lse, do, runs
        torch.cuda.empty_cache()
    print(json.dumps(result))


if __name__ == "__main__":
    main()
