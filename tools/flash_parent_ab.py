"""The flash kernels against an earlier commit's, on one NVIDIA card: the
forward's serving call and the bf16 backward.

    git archive <commit> | tar -x -C build/parent     # build/ is git-ignored
    python3 tools/flash_parent_ab.py build/parent

Builds the flash-attention library from the source in that checkout (a
commit with the backward kernel: its C entry ``flash_attention_launch``
takes the lse pointer and it has ``flash_attention_bwd_launch``, with or
without the ``parts`` argument) and from this tree's, one nvcc each,
started together.  Then, at the heads of llama3.2-1b (32/8, dh 64) and
phi3.5-moe (32/8, dh 128), B = 1, T = 4096, causal:

* the forward, in bf16 (the tensor-core kernel) and f32 (the 3xTF32
  kernel): this tree's serving call (no lse: the instance without the
  store) and its call with the lse store must give the earlier kernel's
  output bit for bit; the earlier kernel and this tree's serving call are
  timed in turns (earlier, this, this, earlier), the call with the store
  once;
* the backward, in bf16, on this tree's forward output and lse: both
  kernels' dq, dk and dv must be within the forward's bf16 elementwise
  limit of the plain backward (``ref.flash_attention_bwd_ref``; their
  bits may differ, as the order of the sums does), and both are timed in
  turns (earlier, this, this, earlier).

Times are by CUDA events; each timed call allocates its outputs and
scratch, as the wrapper does.  Prints the card, a line a case and, last,
one JSON line of the numbers.  Needs one card; about three minutes, the
builds included.
"""
import ctypes
import json
import math
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_bwd_ref)

SHAPES = [("llama3.2-1b", 1, 4096, 32, 8, 64),
          ("phi3.5-moe", 1, 4096, 32, 8, 128)]
DTYPES = (torch.bfloat16, torch.float32)
REPS = 20
BF16_TOL = 2e-2     # chip_smoke.py's bf16 limit: 2e-2 (|want| + median)


def load_earlier(path: pathlib.Path, source: pathlib.Path) -> ctypes.CDLL:
    """The earlier library with its C entries typed as its source has
    them (the backward's ``parts`` argument only where it has one)."""
    lib = fa.load(path)
    if "int causal, int parts" not in source.read_text():
        lib.flash_attention_bwd_launch.argtypes = [ctypes.c_void_p] * 10 + [
            ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int,
                                 ctypes.c_void_p]
        lib.takes_parts = False
    else:
        lib.takes_parts = True
    return lib


def earlier_forward(lib, q, k, v) -> torch.Tensor:
    """One causal serving launch of the earlier kernel, as its wrapper
    made it."""
    B, Tq, H, dh = q.shape
    Tk, Kh = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    bf16 = int(q.dtype == torch.bfloat16)
    scratch = torch.empty(lib.flash_attention_scratch_bytes(B, Tk, Kh, dh,
                                                            bf16),
                          dtype=torch.uint8, device=q.device)
    path = ctypes.c_int(-1)
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None,
        scratch.data_ptr() if scratch.numel() else None, B, Tq, Tk, H, Kh,
        dh, bf16, 1.0 / math.sqrt(dh), 1,
        torch.cuda.current_stream(q.device).cuda_stream, ctypes.byref(path))
    if err:
        raise RuntimeError(f"the earlier kernel's launch failed ({err})")
    return out


def earlier_backward(lib, q, k, v, o, lse, do):
    """One causal launch of the earlier backward -> (dq, dk, dv)."""
    B, Tq, H, dh = q.shape
    Tk, Kh = k.shape[1], k.shape[2]
    grads = [torch.empty_like(t) for t in (q, k, v)]
    scratch = torch.empty(lib.flash_attention_bwd_scratch_bytes(B, Tq, H),
                          dtype=torch.uint8, device=q.device)
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), do.data_ptr(), *(g.data_ptr() for g in grads),
            scratch.data_ptr(), B, Tq, Tk, H, Kh, dh, 1.0 / math.sqrt(dh), 1]
    if lib.takes_parts:
        args.append(fa.BWD_ALL)
    err = lib.flash_attention_bwd_launch(
        *args, torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"the earlier backward's launch failed ({err})")
    return grads


def excess(got, want) -> float:
    """The largest |got - want| over 2e-2 (|want| + median |want|)."""
    d = (got.double() - want.double()).abs()
    w = want.double().abs()
    return float((d / (BF16_TOL * (w + w.median()))).max())


def cuda_ms(fn) -> float:
    fn()
    a, b = (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))
    torch.cuda.synchronize()
    a.record()
    for _ in range(REPS):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / REPS


def in_turns(old, new) -> dict:
    """{"earlier": [ms, ms], "this": [ms, ms]}, timed earlier, this, this,
    earlier."""
    turns = {"earlier": [], "this": []}
    for which in ("earlier", "this", "this", "earlier"):
        turns[which].append(cuda_ms(old if which == "earlier" else new))
    return turns


def inputs(B, T, H, Kh, dh, dtype, dev):
    gen = torch.Generator(device=dev).manual_seed(48)
    q = torch.randn((B, T, H, dh), generator=gen, device=dev)
    k, v, do = (torch.randn(s, generator=gen, device=dev)
                for s in ((B, T, Kh, dh), (B, T, Kh, dh), (B, T, H, dh)))
    return (t.to(dtype) for t in (q, k, v, do))


def forward_row(earlier, label, B, T, H, Kh, dh, dtype, dev) -> dict:
    q, k, v, _ = inputs(B, T, H, Kh, dh, dtype, dev)
    old = lambda: earlier_forward(earlier, q, k, v)  # noqa: E731
    serve = lambda: fa._forward(q, k, v, True, False)[0]  # noqa: E731
    with_lse = lambda: fa._forward(q, k, v, True, True)[0]  # noqa: E731
    want = old()
    same = {"serving": torch.equal(serve(), want),
            "with_lse": torch.equal(with_lse(), want)}
    if not all(same.values()):
        raise AssertionError(f"{label} {dtype}: not the earlier kernel's "
                             f"bits ({same})")
    turns = in_turns(old, serve)
    row = dict(part="forward", shape=label, B=B, T=T, H=H, Kh=Kh, dh=dh,
               dtype=str(dtype).replace("torch.", ""),
               earlier_ms=turns["earlier"], serving_ms=turns["this"],
               with_lse_ms=cuda_ms(with_lse), same_bits=same)
    print(f"forward {label} {row['dtype']} (B={B}, T={T}, H={H}, Kh={Kh}, "
          f"dh={dh}): earlier {turns['earlier'][0]:.4f} / "
          f"{turns['earlier'][1]:.4f} ms, serving (no lse) "
          f"{turns['this'][0]:.4f} / {turns['this'][1]:.4f} ms in turns; "
          f"with the lse store {row['with_lse_ms']:.4f} ms; the same bits "
          f"as the earlier kernel", flush=True)
    return row


def backward_row(earlier, label, B, T, H, Kh, dh, dev) -> dict:
    q, k, v, do = inputs(B, T, H, Kh, dh, torch.bfloat16, dev)
    o, lse = fa._forward(q, k, v, True, True)
    old = lambda: earlier_backward(earlier, q, k, v, o, lse, do)  # noqa
    new = lambda: fa.flash_attention_bwd(q, k, v, o, lse, do)  # noqa
    want = flash_attention_bwd_ref(q, k, v, o, lse, do)
    ex = {}
    for which, fn in (("earlier", old), ("this", new)):
        got = fn()
        ex[which] = {n: excess(a, w) for n, a, w in zip(("dq", "dk", "dv"),
                                                        got, want)}
        del got
    del want
    if max(max(e.values()) for e in ex.values()) > 1:
        raise AssertionError(f"{label} backward: off the plain backward by "
                             f"{ex} x the elementwise limit")
    turns = in_turns(old, new)
    row = dict(part="backward", shape=label, B=B, T=T, H=H, Kh=Kh, dh=dh,
               dtype="bfloat16", earlier_ms=turns["earlier"],
               this_ms=turns["this"], excess=ex)
    print(f"backward {label} bf16 (B={B}, T={T}, H={H}, Kh={Kh}, dh={dh}): "
          f"earlier {turns['earlier'][0]:.4f} / {turns['earlier'][1]:.4f} ms, "
          f"this {turns['this'][0]:.4f} / {turns['this'][1]:.4f} ms in "
          f"turns; dq/dk/dv at {ex} x the elementwise limit", flush=True)
    return row


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("flash_parent_ab: no CUDA device")
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    source = (pathlib.Path(sys.argv[1]).resolve() / "src" / "repro_torch"
              / "kernels" / "flash_attention" / "csrc"
              / "flash_attention.cu")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    (earlier_path, _), _ = _build.build_all(
        [lambda: _build.build(source, fa.NVCC_FLAGS), fa.build])
    earlier = load_earlier(earlier_path, source)
    dev = torch.device("cuda")
    rows = []
    for label, B, T, H, Kh, dh in SHAPES:
        for dtype in DTYPES:
            rows.append(forward_row(earlier, label, B, T, H, Kh, dh, dtype,
                                    dev))
        rows.append(backward_row(earlier, label, B, T, H, Kh, dh, dev))
        torch.cuda.empty_cache()
    print(json.dumps({"card": smi, "rows": rows}))


if __name__ == "__main__":
    main()
