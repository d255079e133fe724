"""The flash forward's serving call against an earlier commit's kernel, on
one NVIDIA card.

    git archive <commit> | tar -x -C build/parent     # build/ is git-ignored
    python3 tools/flash_parent_ab.py build/parent

Builds the flash-attention library from the source in that checkout (a
commit whose C entry ``flash_attention_launch`` takes no lse pointer, as
before the forward kernels gained their lse store) and from this tree's,
one nvcc each, started together.  Then, at the heads of llama3.2-1b
(32/8, dh 64) and phi3.5-moe (32/8, dh 128), B = 1, T = 4096, causal, in
bf16 (the tensor-core kernel) and f32 (the 3xTF32 kernel), it checks that
this tree's serving call (no lse: the instance without the store) and its
call with the lse store give the earlier kernel's output bit for bit, and
times by CUDA events the earlier kernel and this tree's serving call in
turns (earlier, this, this, earlier), and the call with the store once.
Each timed call allocates its output and scratch, as the wrapper does.
Prints a line a shape and, last, one JSON line of the numbers.  Needs one
card; about two minutes, the builds included.
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

SHAPES = [("llama3.2-1b", 1, 4096, 32, 8, 64),
          ("phi3.5-moe", 1, 4096, 32, 8, 128)]
DTYPES = (torch.bfloat16, torch.float32)
REPS = 20


def load_earlier(path: pathlib.Path) -> ctypes.CDLL:
    """The earlier library, its launch typed without the lse pointer."""
    lib = ctypes.CDLL(str(path))
    lib.flash_attention_launch.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
                             ctypes.POINTER(ctypes.c_int)]
    lib.flash_attention_launch.restype = ctypes.c_int
    lib.flash_attention_scratch_bytes.argtypes = [ctypes.c_int] * 5
    lib.flash_attention_scratch_bytes.restype = ctypes.c_longlong
    return lib


def earlier_forward(lib, q, k, v) -> torch.Tensor:
    """One causal launch of the earlier kernel, as its wrapper made it."""
    B, Tq, H, dh = q.shape
    Tk, Kh = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    bf16 = int(q.dtype == torch.bfloat16)
    scratch = torch.empty(lib.flash_attention_scratch_bytes(B, Tk, Kh, dh,
                                                            bf16),
                          dtype=torch.uint8, device=q.device)
    path = ctypes.c_int(-1)
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        scratch.data_ptr() if scratch.numel() else None, B, Tq, Tk, H, Kh,
        dh, bf16, 1.0 / math.sqrt(dh), 1,
        torch.cuda.current_stream(q.device).cuda_stream, ctypes.byref(path))
    if err:
        raise RuntimeError(f"the earlier kernel's launch failed ({err})")
    return out


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
    earlier = load_earlier(earlier_path)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    rows = []
    for label, B, T, H, Kh, dh in SHAPES:
        for dtype in DTYPES:
            gen.manual_seed(48)
            q = torch.randn((B, T, H, dh), generator=gen, device=dev)
            k, v = (torch.randn((B, T, Kh, dh), generator=gen, device=dev)
                    for _ in range(2))
            q, k, v = (t.to(dtype) for t in (q, k, v))
            old = lambda: earlier_forward(earlier, q, k, v)  # noqa: E731
            serve = lambda: fa._forward(q, k, v, True, False)[0]  # noqa
            with_lse = lambda: fa._forward(q, k, v, True, True)[0]  # noqa
            want = old()
            same = {"serving": torch.equal(serve(), want),
                    "with_lse": torch.equal(with_lse(), want)}
            if not all(same.values()):
                raise AssertionError(f"{label} {dtype}: not the earlier "
                                     f"kernel's bits ({same})")
            turns = {"earlier": [], "serving": []}
            for which in ("earlier", "serving", "serving", "earlier"):
                turns[which].append(cuda_ms(old if which == "earlier"
                                            else serve))
            row = dict(shape=label, B=B, T=T, H=H, Kh=Kh, dh=dh,
                       dtype=str(dtype).replace("torch.", ""),
                       earlier_ms=turns["earlier"],
                       serving_ms=turns["serving"],
                       with_lse_ms=cuda_ms(with_lse), same_bits=same)
            rows.append(row)
            print(f"{label} {row['dtype']} (B={B}, T={T}, H={H}, Kh={Kh}, "
                  f"dh={dh}): earlier {turns['earlier'][0]:.4f} / "
                  f"{turns['earlier'][1]:.4f} ms, serving (no lse) "
                  f"{turns['serving'][0]:.4f} / {turns['serving'][1]:.4f} "
                  f"ms in turns; with the lse store "
                  f"{row['with_lse_ms']:.4f} ms; the same bits as the "
                  f"earlier kernel", flush=True)
    print(json.dumps({"card": smi, "rows": rows}))


if __name__ == "__main__":
    main()
