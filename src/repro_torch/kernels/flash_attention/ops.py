"""Host wrapper of the CUDA flash-attention forward
(``csrc/flash_attention.cu``).

``flash_attention(q, k, v, causal=True)`` keeps the JAX package's
contract (``q [B, Tq, H, dh]``, ``k``/``v`` ``[B, Tk, Kh, dh]``, ``H %
Kh == 0`` -> ``[B, Tq, H, dh]`` in q's dtype).  The TPU tile knobs ``bq``
and ``bk`` and the ``interpret`` switch have no counterpart here and are
dropped; unlike the Pallas wrapper, T need not be a multiple of the tile.
On a CUDA tensor the wrapper launches a kernel (or raises): bfloat16
inputs the tensor-core kernel (``csrc/flash_attention_tc.cuh``: wgmma on
TMA-staged tiles), float32 inputs the 3xTF32 tensor-core kernel
(``csrc/flash_attention_tf32.cuh``: each product as three TF32 products
of split operands, after a split pass over K and V into scratch that the
wrapper allocates); on a CPU tensor it runs the plain version
(``ref.py``).  Both devices get the same checks: q, k and v contiguous,
16-byte aligned (TMA reads nothing else), all float32 or all bfloat16, on
one device, ``dh`` one of the head widths the kernels are built for.  The
library is built with ``nvcc`` for ``sm_90a`` at first use
(``kernels/_build.py``) and loaded with ``ctypes``.
"""
from __future__ import annotations

import ctypes
import functools
import math
import pathlib

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

HERE = pathlib.Path(__file__).resolve().parent
SOURCE = HERE / "csrc" / "flash_attention.cu"
NVCC_FLAGS = _build.SM90A_FLAGS
HEAD_DIMS = (16, 32, 64, 128)     # the kernel's instantiations
DTYPES = (torch.float32, torch.bfloat16)

# the C entry's path codes 0, 1, 2: "cuda_core" (f32 on the CUDA cores)
# only from a library built with -DFA_CUDA_CORE_F32, for an A/B
PATHS = ("cuda_core", "tensor_core", "tensor_core_tf32x3")

launches = 0   # kernel launches made by flash_attention, every path
path_launches = dict.fromkeys(PATHS, 0)   # the same launches by kernel


def build() -> tuple[pathlib.Path, str]:
    """Compile the kernel library unless built; ``(path, ptxas report)``."""
    return _build.build(SOURCE, NVCC_FLAGS)


def load(path: pathlib.Path) -> ctypes.CDLL:
    """The kernel library at ``path`` with its C entry points typed."""
    lib = ctypes.CDLL(str(path))
    lib.flash_attention_launch.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
                             ctypes.POINTER(ctypes.c_int)]
    lib.flash_attention_launch.restype = ctypes.c_int
    lib.flash_attention_scratch_bytes.argtypes = [ctypes.c_int] * 5
    lib.flash_attention_scratch_bytes.restype = ctypes.c_longlong
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    return load(build()[0])


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Check what the kernel takes; raises ValueError otherwise."""
    dev = q.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"flash attention runs on cuda or cpu, not {dev}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in DTYPES or t.dtype != q.dtype or t.device != dev \
                or t.dim() != 4 or not t.is_contiguous():
            raise ValueError(
                f"{name} is {t.dtype}{list(t.shape)} on {t.device} "
                f"(contiguous={t.is_contiguous()}); the kernel needs "
                f"contiguous 4-D tensors of one dtype (float32 or bfloat16) "
                f"on {dev}")
    B, Tq, H, dh = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != dh:
        raise ValueError(f"k {list(k.shape)} and v {list(v.shape)} do not "
                         f"fit q {list(q.shape)}: need [B, Tk, Kh, dh]")
    Tk, Kh = k.shape[1], k.shape[2]
    if Kh == 0 or H % Kh:
        raise ValueError(f"{H} query heads do not group over {Kh} KV heads")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head width {dh}: the kernel is built for "
                         f"{HEAD_DIMS}")
    if min(B, Tq, Tk, H) == 0:
        raise ValueError(f"empty attention: q {list(q.shape)}, k "
                         f"{list(k.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} starts at {t.data_ptr():#x}, not on a "
                             f"16-byte boundary: the kernel's tensor-map "
                             f"loads need one")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q: [B, Tq, H, dh]; k/v: [B, Tk, Kh, dh] -> [B, Tq, H, dh] in q's
    dtype.  Each kernel launch adds one to the module's ``launches`` and
    to its kernel's entry of ``path_launches``."""
    global launches
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal)
    B, Tq, H, dh = q.shape
    Tk, Kh = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lib = _library()
    bf16 = int(q.dtype == torch.bfloat16)
    scratch = torch.empty(lib.flash_attention_scratch_bytes(B, Tk, Kh, dh,
                                                            bf16),
                          dtype=torch.uint8, device=q.device)
    path = ctypes.c_int(-1)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            scratch.data_ptr() if scratch.numel() else None, B, Tq, Tk, H,
            Kh, dh, bf16, 1.0 / math.sqrt(dh), int(causal), stream,
            ctypes.byref(path))
    if err:
        raise RuntimeError("flash_attention kernel launch failed: "
                           + lib.flash_attention_error_string(err).decode())
    launches += 1
    path_launches[PATHS[path.value]] += 1
    return out
