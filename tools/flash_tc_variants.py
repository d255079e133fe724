"""Design variants of the tensor-core flash kernel, on one NVIDIA card.

    python3 tools/flash_tc_variants.py

Builds the bf16 kernel (``src/repro_torch/kernels/flash_attention/csrc/
flash_attention_tc.cuh``) as committed and three variants of it, each a
text patch of a copy of ``csrc/`` under ``build/flash_tc_variants/``
(git-ignored), all four with one nvcc each, started together:

  kernel          as committed
  one_bf16_p      P V from one bf16 term of P (the lo products dropped)
  fence_per_tile  all 8 P V steps of a tile made, then one wgmma fence,
                  at every head width
  fence_per_step  one fence a P V step at every head width

and prints, for each: ptxas's spills at dh 16, 32, 64 and 128; at the
bf16 shapes of ``chip_smoke.py``'s phase 13 (the heads of llama3.2-1b,
qwen3-1.7b and starcoder2-3b at T = 4096, llama's at T = 32768) the
largest entrywise excess over its limit (2e-2 x (|ref| + median |ref|)
against the plain version, as phase 13 holds the kernel) and the time by
CUDA events in two passes, the variants in turn and then in reverse,
beside ``F.scaled_dot_product_attention`` (yardstick only).  Ends with
one JSON line of the numbers.  Needs one card; about a minute.
"""
import json
import pathlib
import re
import shutil
import subprocess
import sys
from unittest import mock

import torch
import torch.nn.functional as F

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_ref)

HEADER = "flash_attention_tc.cuh"
FENCE = "    constexpr int FENCE_STEPS = DH == 32 || DH == 128 ? 1 : BK / 16;\n"
PATCHES = {   # variant: (text in the header, its replacement)
    "kernel": None,
    "one_bf16_p": ("          wgmma_rs<DH>(acc, lo[u], dv);\n", ""),
    "fence_per_tile": (FENCE, "    constexpr int FENCE_STEPS = BK / 16;\n"),
    "fence_per_step": (FENCE, "    constexpr int FENCE_STEPS = 1;\n"),
}
SHAPES = [("llama3.2-1b", 1, 4096, 32, 8, 64),
          ("qwen3-1.7b", 1, 4096, 16, 8, 128),
          ("starcoder2-3b", 1, 4096, 24, 2, 128),
          ("llama3.2-1b", 1, 32768, 32, 8, 64)]


def variant_sources() -> dict:
    """A copy of ``csrc/`` per variant, patched; {name: .cu path}."""
    out = {}
    for name, patch in PATCHES.items():
        csrc = ROOT / "build" / "flash_tc_variants" / name / "csrc"
        if csrc.exists():
            shutil.rmtree(csrc)
        shutil.copytree(fa.SOURCE.parent, csrc)
        if patch:
            text = (csrc / HEADER).read_text()
            if text.count(patch[0]) != 1:
                raise SystemExit(f"{name}: the patched text is not in "
                                 f"{HEADER} once")
            (csrc / HEADER).write_text(text.replace(*patch))
        out[name] = csrc / fa.SOURCE.name
    return out


def spills(report: str) -> dict:
    """{dh: spill stores + loads in bytes} of the tensor-core kernels (the
    larger of the serving instance's and the lse store's)."""
    out: dict = {}
    for name, f in _build.ptxas_functions(report).items():
        if m := re.search(r"fa_fwd_tcILi(\d+)E", name):
            out[int(m[1])] = max(out.get(int(m[1]), 0),
                                 f["spill_stores"] + f["spill_loads"])
    return out


def launcher(lib_path):
    """``flash_attention`` through the library at ``lib_path``: the
    wrapper's checks and launch, this build's kernel."""
    lib = fa.load(lib_path)

    def run(q, k, v):
        with mock.patch.object(fa, "_library", lambda: lib):
            before = fa.path_launches["tensor_core"]
            out = fa.flash_attention(q, k, v)
        if fa.path_launches["tensor_core"] != before + 1:
            raise RuntimeError("the bf16 call did not take the tensor cores")
        return out
    return run


def excess(got, want) -> float:
    d = (got.double() - want.double()).abs()
    w = want.double().abs()
    return float((d / (2e-2 * (w + float(w.median())))).max())


def cuda_ms(fn, reps=10) -> float:
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
        raise SystemExit("flash_tc_variants: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    srcs = variant_sources()
    built = _build.build_all([lambda s=s: _build.build(s, fa.NVCC_FLAGS)
                              for s in srcs.values()])
    result = {"card": smi, "variants": {}}
    runs = {}
    for (name, _), (lib, report) in zip(srcs.items(), built):
        result["variants"][name] = {"spill_bytes": spills(report),
                                    "shapes": []}
        runs[name] = launcher(lib)
        print(f"{name}: spill bytes (stores + loads) by dh "
              f"{result['variants'][name]['spill_bytes']}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    for label, B, T, H, Kh, dh in SHAPES:
        gen.manual_seed(13)
        q = torch.randn((B, T, H, dh), generator=gen, device=dev).bfloat16()
        k, v = (torch.randn((B, T, Kh, dh), generator=gen,
                            device=dev).bfloat16() for _ in range(2))
        G = H // Kh
        if T > 8192:      # the plain version head by head, as phase 13
            want = torch.cat([flash_attention_ref(
                q[:, :, h:h + 1], k[:, :, h // G:h // G + 1],
                v[:, :, h // G:h // G + 1]) for h in range(H)], dim=2)
        else:
            want = flash_attention_ref(q, k, v)
        ex = {n: excess(run(q, k, v), want) for n, run in runs.items()}
        del want
        qs, ks, vs = (t.transpose(1, 2) for t in (
            q, k.repeat_interleave(G, dim=2), v.repeat_interleave(G, dim=2)))
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qs, ks, vs, is_causal=True)
        order = list(runs)
        ms = {n: [] for n in order}
        sdpa_ms = [cuda_ms(sdpa)]
        for names in (order, order[::-1]):
            for n in names:
                ms[n].append(cuda_ms(lambda r=runs[n]: r(q, k, v)))
        sdpa_ms.append(cuda_ms(sdpa))
        flops = 4 * B * H * dh * (T * (T + 1) // 2)
        print(f"{label} T={T} (SDPA {min(sdpa_ms):.4f} ms):", flush=True)
        for n in order:
            best = min(ms[n])
            row = dict(shape=label, T=T, excess=ex[n], ms=ms[n],
                       tflops=flops / best / 1e9, sdpa_ms=sdpa_ms,
                       vs_sdpa=best / min(sdpa_ms))
            result["variants"][n]["shapes"].append(row)
            print(f"  {n}: {ms[n][0]:.4f} / {ms[n][1]:.4f} ms "
                  f"({row['tflops']:.1f} TFLOP/s, {row['vs_sdpa']:.3f}x "
                  f"SDPA), {ex[n]:.3f} x the entrywise limit", flush=True)
        del q, k, v, qs, ks, vs
        torch.cuda.empty_cache()
    print(json.dumps(result))


if __name__ == "__main__":
    main()
