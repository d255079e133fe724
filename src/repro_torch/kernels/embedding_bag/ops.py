"""Host wrapper of the CUDA EmbeddingBag kernel (``csrc/embedding_bag.cu``).

``embedding_bags(tables, indices)`` looks up all F fields of a batch in
one launch: F f32 tables ``[V_f, D]``, int32 indices ``[B, F, L]``,
optional f32 ``weights`` ``[B, F, L]`` -> f32 ``[B, F, D]``.
``embedding_bag_fwd(table, indices)`` is its F = 1 case with the JAX
package's contract (``[B, L]`` -> ``[B, D]``).  The TPU ``interpret``
switch is dropped: on CUDA tensors the wrapper launches the kernel (or
raises); on CPU tensors it runs the plain version (``ref.py``).  Both
devices get the same checks.  The kernel is built with ``nvcc`` for
``sm_90a`` at first use (``kernels/_build.py``) and loaded with
``ctypes``.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.embedding_bag.ref import embedding_bags_ref

HERE = pathlib.Path(__file__).resolve().parent
SOURCE = HERE / "csrc" / "embedding_bag.cu"
NVCC_FLAGS = _build.SM90A_FLAGS
COMBINERS = ("sum", "mean")

launches = 0   # kernel launches made by embedding_bags / embedding_bag_fwd


def build() -> tuple[pathlib.Path, str]:
    """Compile the kernel library unless built; ``(path, ptxas report)``."""
    return _build.build(SOURCE, NVCC_FLAGS)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()[0]))
    lib.embedding_bag_launch.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    lib.embedding_bag_launch.restype = ctypes.c_int
    lib.embedding_bag_error_string.argtypes = [ctypes.c_int]
    lib.embedding_bag_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=16)
def _table_meta(key: tuple, dev: torch.device) -> torch.Tensor:
    """The table pointers, then their row counts, as an int64 device
    array.  Cached by value, so a forward over the same tables makes no
    host-to-device copy (and no host sync)."""
    return torch.tensor(key, dtype=torch.int64, device=dev)


def _check(tables, indices, weights, combiner) -> torch.device:
    """Check what the kernel takes; raises ValueError otherwise."""
    dev = indices.device
    if combiner not in COMBINERS:
        raise ValueError(f"combiner must be one of {COMBINERS}, not "
                         f"{combiner!r}")
    if indices.dtype != torch.int32 or indices.dim() != 3 \
            or not indices.is_contiguous():
        raise ValueError(f"indices is {indices.dtype}{list(indices.shape)} "
                         f"(contiguous={indices.is_contiguous()}); the kernel "
                         f"needs a contiguous int32 [B, F, L]")
    if len(tables) != indices.shape[1] or not tables:
        raise ValueError(f"{len(tables)} tables for {indices.shape[1]} "
                         f"fields of indices")
    D = tables[0].shape[-1]
    for f, t in enumerate(tables):
        if t.dtype != torch.float32 or t.dim() != 2 or t.shape[1] != D \
                or t.device != dev or not t.is_contiguous():
            raise ValueError(
                f"table {f} is {t.dtype}{list(t.shape)} on {t.device} "
                f"(contiguous={t.is_contiguous()}); the kernel needs "
                f"contiguous float32 [V, {D}] tables on {dev}")
    if weights is not None and (
            weights.dtype != torch.float32 or weights.device != dev
            or weights.shape != indices.shape
            or not weights.is_contiguous()):
        raise ValueError(f"weights is {weights.dtype}{list(weights.shape)} "
                         f"on {weights.device}; the kernel needs contiguous "
                         f"float32 {list(indices.shape)} on {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"the EmbeddingBag runs on cuda or cpu, not {dev}")
    return dev


def embedding_bags(tables, indices: torch.Tensor,
                   weights: torch.Tensor | None = None,
                   combiner: str = "sum") -> torch.Tensor:
    """All F fields in one launch: [B, F, L] -> [B, F, D] f32.  Each
    kernel launch adds one to the module's ``launches``."""
    global launches
    if _check(tables, indices, weights, combiner).type == "cpu":
        return embedding_bags_ref(tables, indices, weights, combiner)
    dev = indices.device
    B, F, L = indices.shape
    D = tables[0].shape[1]
    out = torch.empty((B, F, D), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    meta = _table_meta(tuple(t.data_ptr() for t in tables)
                       + tuple(t.shape[0] for t in tables), dev)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.embedding_bag_launch(
            meta.data_ptr(), meta[F:].data_ptr(), indices.data_ptr(),
            None if weights is None else weights.data_ptr(), out.data_ptr(),
            B * F, F, L, D, int(combiner == "mean"), stream)
    if err:
        raise RuntimeError("embedding_bag kernel launch failed: "
                           + lib.embedding_bag_error_string(err).decode())
    launches += 1
    return out


def embedding_bag_fwd(table: torch.Tensor, indices: torch.Tensor,
                      weights: torch.Tensor | None = None,
                      combiner: str = "sum") -> torch.Tensor:
    """table: [V, D] f32; indices: [B, L] int32 -> [B, D] f32."""
    if indices.dim() != 2:
        raise ValueError(f"indices must be [B, L], got {list(indices.shape)}")
    return embedding_bags([table], indices[:, None],
                          None if weights is None else weights[:, None],
                          combiner)[:, 0]
