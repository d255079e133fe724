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

Gradients: when grad mode is on and q, k or v requires grad, the call
goes through ``FlashAttention`` (a ``torch.autograd.Function``).  Its
forward launches the same kernel with the per-row log-sum-exp stored
(``lse [B, H, Tq]`` f32); its backward launches the bf16 backward kernel
(``csrc/flash_attention_bwd.cuh``: wgmma on TMA-staged tiles with no
transposed copies; a prep pass for delta, then dK and dV over pairs of
key tiles that balance the causal work, then dQ over query tiles; no
float atomics, so the same bits every run; it does twice the bound's
tensor-core operations, the recomputed S and dP and the hi and lo terms
of P and dS) on a CUDA tensor, and on a CPU tensor the plain backward
``ref.flash_attention_bwd_ref``, the formula that kernel is held to.  A
CUDA float32 input that requires grad raises ``NotImplementedError``: no
main path trains attention in f32, and the backward kernel is bf16 only.
"""
from __future__ import annotations

import ctypes
import functools
import math
import pathlib

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_bwd_ref, flash_attention_fwd_ref, flash_attention_ref)

HERE = pathlib.Path(__file__).resolve().parent
SOURCE = HERE / "csrc" / "flash_attention.cu"
NVCC_FLAGS = _build.SM90A_FLAGS
HEAD_DIMS = (16, 32, 64, 128)     # the kernel's instantiations
DTYPES = (torch.float32, torch.bfloat16)

# the C entry's path codes 0, 1, 2: "cuda_core" (f32 on the CUDA cores)
# only from a library built with -DFA_CUDA_CORE_F32, for an A/B
PATHS = ("cuda_core", "tensor_core", "tensor_core_tf32x3")

launches = 0   # forward kernel launches made by flash_attention
path_launches = dict.fromkeys(PATHS, 0)   # the same launches by kernel
bwd_launches = 0   # backward kernel launches (one a backward: 3 kernels)
# the C entry's parts of a backward: the prep pass (delta, lse log2 e),
# dK and dV, dQ; a part alone times that launch
BWD_PREP, BWD_DKDV, BWD_DQ = 1, 2, 4
BWD_ALL = BWD_PREP | BWD_DKDV | BWD_DQ


def build() -> tuple[pathlib.Path, str]:
    """Compile the kernel library unless built; ``(path, ptxas report)``."""
    return _build.build(SOURCE, NVCC_FLAGS)


def load(path: pathlib.Path) -> ctypes.CDLL:
    """The kernel library at ``path`` with its C entry points typed."""
    lib = ctypes.CDLL(str(path))
    lib.flash_attention_launch.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
                             ctypes.POINTER(ctypes.c_int)]
    lib.flash_attention_launch.restype = ctypes.c_int
    lib.flash_attention_scratch_bytes.argtypes = [ctypes.c_int] * 5
    lib.flash_attention_scratch_bytes.restype = ctypes.c_longlong
    lib.flash_attention_bwd_launch.argtypes = [ctypes.c_void_p] * 10 + [
        ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                             ctypes.c_void_p]
    lib.flash_attention_bwd_launch.restype = ctypes.c_int
    lib.flash_attention_bwd_scratch_bytes.argtypes = [ctypes.c_int] * 3
    lib.flash_attention_bwd_scratch_bytes.restype = ctypes.c_longlong
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


def _forward(q, k, v, causal: bool, with_lse: bool):
    """One forward launch on checked CUDA inputs -> (out, lse or None)."""
    global launches
    B, Tq, H, dh = q.shape
    Tk, Kh = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
           if with_lse else None)
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
            None if lse is None else lse.data_ptr(),
            scratch.data_ptr() if scratch.numel() else None, B, Tq, Tk, H,
            Kh, dh, bf16, 1.0 / math.sqrt(dh), int(causal), stream,
            ctypes.byref(path))
    if err:
        raise RuntimeError("flash_attention kernel launch failed: "
                           + lib.flash_attention_error_string(err).decode())
    launches += 1
    path_launches[PATHS[path.value]] += 1
    return out, lse


def flash_attention_bwd(q, k, v, o, lse, dout, causal: bool = True):
    """(dq, dk, dv) of the attention at q, k, v with output ``o`` and
    ``lse`` [B, H, Tq] f32 (the forward's), for the output gradient
    ``dout``: on CUDA tensors one call of the bf16 backward kernel (adds
    one to ``bwd_launches``), on CPU tensors the plain backward.  Every
    input contiguous; q, k, v, o and dout bf16 on the card."""
    global bwd_launches
    _check(q, k, v)
    if dout.shape != q.shape or o.shape != q.shape \
            or lse.shape != (q.shape[0], q.shape[2], q.shape[1]):
        raise ValueError(f"o {list(o.shape)}, dout {list(dout.shape)} and "
                         f"lse {list(lse.shape)} do not fit q "
                         f"{list(q.shape)}")
    if q.device.type == "cpu":
        dq, dk, dv = flash_attention_bwd_ref(q, k, v, o, lse, dout, causal)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
    if q.dtype != torch.bfloat16:
        raise NotImplementedError(
            f"the flash-attention backward kernel is bf16 only, not "
            f"{q.dtype}: no main path of the port trains attention in f32")
    for name, t, dt in (("o", o, q.dtype), ("dout", dout, q.dtype),
                        ("lse", lse, torch.float32)):
        if t.dtype != dt or t.device != q.device or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(f"{name} is {t.dtype} on {t.device} "
                             f"(contiguous={t.is_contiguous()}); the "
                             f"backward needs contiguous, 16-byte aligned "
                             f"{dt} on {q.device}")
    bufs = bwd_buffers(q, k, v)
    bwd_launch(q, k, v, o, lse, dout, causal, bufs)
    bwd_launches += 1
    return bufs[:3]


def bwd_buffers(q, k, v) -> tuple[torch.Tensor, ...]:
    """(dq, dk, dv, scratch) for a backward launch on CUDA q, k, v."""
    B, Tq, H, _ = q.shape
    nbytes = _library().flash_attention_bwd_scratch_bytes(B, Tq, H)
    return (*(torch.empty_like(t) for t in (q, k, v)),
            torch.empty(nbytes, dtype=torch.uint8, device=q.device))


def bwd_launch(q, k, v, o, lse, dout, causal: bool, bufs,
               parts: int = BWD_ALL) -> None:
    """The backward kernel's ``parts`` (``BWD_*``) into ``bufs`` (of
    ``bwd_buffers``) on checked CUDA inputs; raises if a launch fails.
    Counts nothing: ``flash_attention_bwd`` counts the whole backward."""
    B, Tq, H, dh = q.shape
    Tk, Kh = k.shape[1], k.shape[2]
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), dout.data_ptr(),
            *(t.data_ptr() for t in bufs), B, Tq, Tk, H, Kh, dh,
            1.0 / math.sqrt(dh), int(causal), parts, stream)
    if err:
        raise RuntimeError("flash_attention backward launch failed: "
                           + lib.flash_attention_error_string(err).decode())


class FlashAttention(torch.autograd.Function):
    """``flash_attention`` with its gradient: the forward kernel with the
    lse store, and the backward kernel (the plain backward on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        if q.device.type == "cpu":
            out, lse = flash_attention_fwd_ref(q, k, v, causal)
        else:
            out, lse = _forward(q, k, v, causal, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        if dout.data_ptr() % 16:      # the kernel reads 16-byte rows
            dout = dout.clone()
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout,
                                         ctx.causal)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q: [B, Tq, H, dh]; k/v: [B, Tk, Kh, dh] -> [B, Tq, H, dh] in q's
    dtype.  Each forward kernel launch adds one to the module's
    ``launches`` and to its kernel's entry of ``path_launches``; with grad
    on and an input that requires it, the output has a ``grad_fn``
    (``FlashAttention``) and each backward adds one to ``bwd_launches``."""
    _check(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        if q.device.type == "cuda" and q.dtype == torch.float32:
            raise NotImplementedError(
                "flash_attention with grad in float32 on the card: the "
                "backward kernel is bf16 only, and no main path of the "
                "port trains attention in f32 (cast q, k, v to bfloat16)")
        return FlashAttention.apply(q, k, v, causal)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal)
    return _forward(q, k, v, causal, with_lse=False)[0]
