"""The old and the new kernel of each pair redesigned for Hopper in this
slice, timed in turns on one NVIDIA card.

    python3 tools/flash_spmm_variants.py

Builds, from the repo's sources, with one nvcc each, started together:

  flash  the flash-attention library as committed (f32 on the 3xTF32
         tensor-core kernel, ``csrc/flash_attention_tf32.cuh``), again
         with ``-DFA_CUDA_CORE_F32`` (f32 on the CUDA-core kernel of
         ``csrc/flash_attention.cu``, the kernel it replaces), and a copy
         of ``csrc/`` under ``build/flash_spmm_variants/`` (git-ignored)
         patched to return after the split pass over K and V (its time
         alone; its output is not attention)
  spmm   the scatter-SpMM library as committed: its wide warp shape (lanes
         over the columns, ``ops.WIDE``) is the old kernel, launched by
         shape at every width; the shape ``ops.geometry`` picks is the new

and prints, at the f32 shapes of ``chip_smoke.py``'s phase 13 (the heads
of llama3.2-1b, qwen3-1.7b and starcoder2-3b at T = 4096) and at every
shape of its phase 8 (GCN-Cora and ogb_products at D = 16 and 7, the
Cora edge messages at 70 and 128, GraphCast's three edge sets at 512),
the time of each by CUDA events in turns (old, new, new, old; the split
pass once), each held to the plain version first (flash: 2e-5 x (|ref| +
1) entry by entry; spmm: 1e-4 x max(1, max |ref|)), beside SDPA (flash,
yardstick only) and the bound.  Ends with one JSON line of the numbers.
Needs one card; about two minutes.
"""
import dataclasses
import json
import pathlib
import shutil
import subprocess
import sys
from unittest import mock

import torch
import torch.nn.functional as F

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import gnn_archs  # noqa: E402
from repro_torch.configs.base import gnn_shapes  # noqa: E402
from repro_torch.data.graphs import build_graph  # noqa: E402
from repro_torch.graph.segment_ops import sym_norm_coeff  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_ref)
from repro_torch.kernels.spmm import ops as spmm  # noqa: E402
from repro_torch.kernels.spmm.ref import (scatter_spmm_ref,  # noqa: E402
                                          spmm_sorted_coo_ref)

FLASH_SHAPES = [("llama3.2-1b", 1, 4096, 32, 8, 64),
                ("qwen3-1.7b", 1, 4096, 16, 8, 128),
                ("starcoder2-3b", 1, 4096, 24, 2, 128)]
F32_TC_FLOPS = 495e12 / 3    # three TF32 products (data sheet: 495 dense)
F32_FLOPS = 67e12            # f32 outside the tensor cores (data sheet)
BYTES_PER_S = 3.35e12
HEADER = "flash_attention_tf32.cuh"
SPLIT_ONLY = ("  auto kern = fa_fwd_tf32<DH>;\n",
              "  return cudaGetLastError();   // the split pass alone\n"
              "  auto kern = fa_fwd_tf32<DH>;\n")


def split_only_source() -> pathlib.Path:
    """A copy of the flash kernel's ``csrc/`` whose f32 launch returns
    after the split pass; its .cu path."""
    csrc = ROOT / "build" / "flash_spmm_variants" / "split_only" / "csrc"
    if csrc.exists():
        shutil.rmtree(csrc)
    shutil.copytree(fa.SOURCE.parent, csrc)
    text = (csrc / HEADER).read_text()
    if text.count(SPLIT_ONLY[0]) != 1:
        raise SystemExit(f"the patched text is not in {HEADER} once")
    (csrc / HEADER).write_text(text.replace(*SPLIT_ONLY))
    return csrc / fa.SOURCE.name


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


def in_turns(old, new) -> dict:
    """{"old": [ms, ms], "new": [ms, ms]}, timed old, new, new, old."""
    out = {"old": [], "new": []}
    for which in ("old", "new", "new", "old"):
        out[which].append(cuda_ms(old if which == "old" else new))
    return out


def flash_launcher(lib_path, path):
    """``flash_attention`` through the library at ``lib_path``; raises
    unless the launch took ``path``."""
    lib = fa.load(lib_path)

    def run(q, k, v):
        with mock.patch.object(fa, "_library", lambda: lib):
            before = fa.path_launches[path]
            out = fa.flash_attention(q, k, v)
        if fa.path_launches[path] != before + 1:
            raise RuntimeError(f"the f32 call did not take {path}")
        return out
    return run


def flash_rows(libs) -> list[dict]:
    runs = {"old": flash_launcher(libs["old"], "cuda_core"),
            "new": flash_launcher(libs["new"], "tensor_core_tf32x3")}
    split = flash_launcher(libs["split_only"], "tensor_core_tf32x3")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    rows = []
    for label, B, T, H, Kh, dh in FLASH_SHAPES:
        gen.manual_seed(13)
        q = torch.randn((B, T, H, dh), generator=gen, device=dev)
        k, v = (torch.randn((B, T, Kh, dh), generator=gen, device=dev)
                for _ in range(2))
        want = flash_attention_ref(q, k, v).double()
        excess = {}
        for n, run in runs.items():
            d = (run(q, k, v).double() - want).abs()
            excess[n] = float((d / (2e-5 * (want.abs() + 1))).max())
            if not excess[n] <= 1:
                raise AssertionError(f"flash {n} {label}: {excess[n]:.3g} x "
                                     f"the f32 limit")
        del want
        G = H // Kh
        qs, ks, vs = (t.transpose(1, 2) for t in (
            q, k.repeat_interleave(G, dim=2), v.repeat_interleave(G, dim=2)))
        sdpa = cuda_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, is_causal=True))
        turns = in_turns(lambda: runs["old"](q, k, v),
                         lambda: runs["new"](q, k, v))
        split_ms = cuda_ms(lambda: split(q, k, v))
        flops = 4 * B * H * dh * (T * (T + 1) // 2)
        new = sum(turns["new"]) / 2
        row = dict(shape=label, T=T, H=H, Kh=Kh, dh=dh, excess=excess,
                   ms=turns, split_pass_ms=split_ms, sdpa_ms=sdpa,
                   tflops=flops / new / 1e9,
                   bound_ms=1e3 * flops / F32_TC_FLOPS,
                   cuda_core_bound_ms=1e3 * flops / F32_FLOPS)
        rows.append(row)
        print(f"flash f32 {label} T={T}: CUDA cores {turns['old'][0]:.4f} / "
              f"{turns['old'][1]:.4f} ms, 3xTF32 {turns['new'][0]:.4f} / "
              f"{turns['new'][1]:.4f} ms ({row['tflops']:.1f} TFLOP/s, "
              f"{100 * row['bound_ms'] / new:.1f}% of the 165-TFLOP/s bound "
              f"{row['bound_ms']:.4f} ms; CUDA-core bound "
              f"{row['cuda_core_bound_ms']:.4f} ms), the split pass alone "
              f"{split_ms:.4f} ms; SDPA {sdpa:.4f} ms; "
              f"excess {excess['old']:.3g} / {excess['new']:.3g} x the "
              f"limit", flush=True)
        del q, k, v, qs, ks, vs
        torch.cuda.empty_cache()
    return rows


def spmm_rows() -> list[dict]:
    dev = torch.device("cuda")
    shapes = {s.name: s for s in gnn_shapes()}
    d_feat = shapes["full_graph_sm"].dim("d_feat")
    cora = dataclasses.replace(gnn_archs.GCN_CORA, d_in=d_feat)
    ogb = dataclasses.replace(cora, d_in=shapes["ogb_products"].dim("d_feat"))
    gc = dataclasses.replace(gnn_archs.GRAPHCAST, d_in=d_feat)
    g_cora = build_graph(cora, shapes["full_graph_sm"], device=dev)
    g_ogb = build_graph(ogb, shapes["ogb_products"], device=dev)
    g_gc = build_graph(gc, shapes["full_graph_sm"], device=dev)
    cases = [("full_graph_sm", g_cora, "edge_index", 16, True),
             ("full_graph_sm", g_cora, "edge_index", 7, True),
             ("full_graph_sm", g_cora, "edge_index", 70, False),
             ("full_graph_sm", g_cora, "edge_index", 128, False),
             ("ogb_products", g_ogb, "edge_index", 16, True),
             ("ogb_products", g_ogb, "edge_index", 7, True),
             ("multimesh_r6", g_gc, "mesh_edge_index", 512, False),
             ("grid2mesh", g_gc, "g2m_edge_index", 512, False),
             ("mesh2grid", g_gc, "m2g_edge_index", 512, False)]
    gen = torch.Generator(device=dev)
    rows = []
    for name, g, key, D, gather in cases:
        gen.manual_seed(D)
        ei, rowptr = getattr(g, key), g.rowptr[key]
        n, E = rowptr.shape[0] - 1, ei.shape[1]
        src, dst = ei[0].contiguous(), ei[1].contiguous()
        if gather:
            x = torch.randn((n, D), generator=gen, device=dev)
            coeff = sym_norm_coeff(ei, n)
            want = spmm_sorted_coo_ref(x, src, dst, n, coeff)
            nbytes = E * 8 + (n + 1) * 4 + n * D * 8
        else:
            x = torch.randn((E, D), generator=gen, device=dev)
            src = coeff = None
            want = scatter_spmm_ref(x, dst, n)
            nbytes = E * D * 4 + (n + 1) * 4 + n * D * 4
        shape = spmm.geometry(D, x.data_ptr() % 16 == 0)
        old = lambda: spmm.launch(x, src, coeff, rowptr, n,  # noqa: E731
                                  shape=spmm.WIDE)
        new = lambda: spmm.launch(x, src, coeff, rowptr, n)  # noqa: E731
        scale = max(1.0, float(want.abs().max()))
        for label, fn in (("old", old), ("new", new)):
            err = float((fn() - want).abs().max())
            if not err <= 1e-4 * scale:
                raise AssertionError(f"spmm {label} {name} D={D}: max |d| "
                                     f"{err}")
        turns = in_turns(old, new)
        row = dict(shape=name, D=D, edges=E, geometry=list(shape), ms=turns,
                   bound_ms=1e3 * nbytes / BYTES_PER_S)
        rows.append(row)
        print(f"spmm {name} D={D} ({E} edges): wide shape "
              f"{turns['old'][0]:.4f} / {turns['old'][1]:.4f} ms, "
              f"{tuple(shape)} {turns['new'][0]:.4f} / {turns['new'][1]:.4f} "
              f"ms (bound {row['bound_ms']:.4f} ms)", flush=True)
        del x, want
    return rows


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("flash_spmm_variants: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    split_src = split_only_source()
    builds = _build.build_all([
        fa.build,
        lambda: _build.build(fa.SOURCE,
                             fa.NVCC_FLAGS + ("-DFA_CUDA_CORE_F32",)),
        lambda: _build.build(split_src, fa.NVCC_FLAGS),
        spmm.build])
    libs = {"new": builds[0][0], "old": builds[1][0],
            "split_only": builds[2][0]}
    result = {"card": smi, "flash_f32": flash_rows(libs),
              "spmm": spmm_rows()}
    print(json.dumps(result))


if __name__ == "__main__":
    main()
