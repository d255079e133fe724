"""Host wrapper of the CUDA EmbeddingBag kernel (``csrc/embedding_bag.cu``).

``embedding_bags(tables, indices)`` looks up all F fields of a batch in
one launch: F f32 tables ``[V_f, D]``, int32 indices ``[B, F, L]``,
optional f32 ``weights`` ``[B, F, L]`` -> f32 ``[B, F, D]``.
``embedding_bag_fwd(table, indices)`` is its F = 1 case with the JAX
package's contract (``[B, L]`` -> ``[B, D]``).  The TPU ``interpret``
switch is dropped: on CUDA tensors the wrapper launches the kernel (or
raises); on CPU tensors it runs the plain version (``ref.py``).  Both
devices get the same checks.

``tables`` is a sequence of tensors or a ``BagTables`` handle from
``prepare_tables``.  A sequence is checked at every call, from its key
(each table's pointer, shape, strides, dtype and device: ~20 us for
DLRM's 26 tables); the checks' result and the device array of the
tables' pointers and row counts are cached by that key, so a call over
the same tables makes no host-to-device copy.  A handle was checked when
it was made, and a call over it reads nothing of its tables: the layer
that owns the tables makes it once (``models.dlrm.prepare_dlrm_params``)
and makes it again after it resizes a table or gives it other storage.
The warp's shape comes from ``geometry(D, L, align)`` (lanes a bag,
floats a lane load, the L the kernel is built for, rounds a tile), as
``csrc/embedding_bag.cu`` says; the C entry refuses a shape it is not
built for.  The kernel is built with ``nvcc`` for ``sm_90a`` at first
use (``kernels/_build.py``) and loaded with ``ctypes``.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import operator
import pathlib
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.embedding_bag.ref import embedding_bags_ref

HERE = pathlib.Path(__file__).resolve().parent
SOURCE = HERE / "csrc" / "embedding_bag.cu"
NVCC_FLAGS = _build.SM90A_FLAGS
COMBINERS = ("sum", "mean")
LOAD_FLOATS = 32        # the kernel's LOAD_FLOATS: row floats a lane
CHUNK = 8               # lookups a step of the kernel for any other L
TILE_L = (1, 2, 4, 8)   # the L the tile kernel is built for

launches = 0   # kernel launches made by embedding_bags / embedding_bag_fwd
shape_launches = collections.Counter()   # the same launches by Geometry


class Geometry(NamedTuple):
    """The kernel's warp: ``lanes`` a bag, ``vec`` floats a lane load,
    ``lt`` the L it is built for (0: any other, CHUNK lookups a step),
    ``rounds`` of 32 / lanes bags a tile."""
    lanes: int
    vec: int
    lt: int
    rounds: int

    @property
    def bags(self) -> int:
        """Bags a warp's tile."""
        return 32 // self.lanes * self.rounds


def build(flags: tuple[str, ...] = ()) -> tuple[pathlib.Path, str]:
    """Compile the kernel library unless built; ``(path, ptxas report)``.
    ``flags`` adds nvcc flags for ``tools/bag_variants.py``
    (``-DBAG_WARP_PER_BAG``: the first port's kernel)."""
    return _build.build(SOURCE, NVCC_FLAGS + tuple(flags))


def load(path: pathlib.Path) -> ctypes.CDLL:
    """The kernel library at ``path`` with its C entry points typed."""
    lib = ctypes.CDLL(str(path))
    lib.embedding_bag_launch.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_longlong] + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    lib.embedding_bag_launch.restype = ctypes.c_int
    lib.embedding_bag_error_string.argtypes = [ctypes.c_int]
    lib.embedding_bag_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    return load(build()[0])


def tile_rounds(lanes: int, vec: int, lt: int) -> int:
    """``csrc/embedding_bag.cu::tile_rounds``: the largest power of two R
    with (32 / lanes) R lt <= 32 and R lt vec <= LOAD_FLOATS; 1 for lt =
    0."""
    r = 1
    while lt and 2 * r * (32 // lanes) * lt <= 32 \
            and 2 * r * lt * vec <= LOAD_FLOATS:
        r *= 2
    return r


@functools.lru_cache(maxsize=64)
def geometry(D: int, L: int, align: int = 16) -> Geometry:
    """The warp's shape for width ``D`` and bag size ``L`` when the tables
    and the output share ``align`` bytes of alignment: float4 loads where
    ``D % 4 == 0`` and ``align`` is 16, float2 where ``D % 2 == 0`` and it
    is 8, else scalar; the fewest lanes (a power of two, up to 32, then
    strips) whose loads cover ``D``, but at least ``L`` for the tile
    kernel (one index a lane) and CHUNK for the chunked one."""
    if D < 1 or L < 0:
        raise ValueError(f"no geometry for D = {D}, L = {L}")
    vec = 4 if D % 4 == 0 and align % 16 == 0 else \
        2 if D % 2 == 0 and align % 8 == 0 else 1
    lanes = min(32, 1 << (-(-D // vec) - 1).bit_length())
    lt = L if L in TILE_L else 0
    lanes = max(lanes, lt or CHUNK)
    return Geometry(lanes, vec, lt, tile_rounds(lanes, vec, lt))


def _alignment(ptr: int) -> int:
    """The largest of 16, 8, 4, 2, 1 bytes that divides ``ptr``."""
    return next(a for a in (16, 8, 4, 2, 1) if ptr % a == 0)


def _contiguous(shape, stride) -> bool:
    """``Tensor.is_contiguous()`` from a shape and strides."""
    if 0 in shape:
        return True
    expected = 1
    for size, st in zip(reversed(shape), reversed(stride)):
        if size != 1:
            if st != expected:
                return False
            expected *= size
    return True


_DTYPE = operator.attrgetter("dtype")
_DEVICE = operator.attrgetter("device")


def _key(tables) -> tuple:
    """Each table's (pointer, shape, strides, dtype, device): all that the
    checks and the device meta array read."""
    T = torch.Tensor
    return tuple(zip(map(T.data_ptr, tables), map(T.size, tables),
                     map(T.stride, tables), map(_DTYPE, tables),
                     map(_DEVICE, tables)))


@functools.lru_cache(maxsize=16)
def _checked(key: tuple, dev: torch.device
             ) -> tuple[torch.Tensor | None, int, int]:
    """Check the tables from their ``_key`` for a launch on ``dev``
    (ValueError otherwise).  Returns, on the card, the table pointers then
    their row counts as an int64 device array (None on the CPU), D, and
    the alignment in bytes (up to 16) that every table shares.  Cached by
    the key, so a forward over the same tables makes no check and no
    host-to-device copy (and no host sync)."""
    D = key[0][1][-1] if key[0][1] else None
    align = 16
    for f, (ptr, shape, stride, dtype, device) in enumerate(key):
        contiguous = _contiguous(shape, stride)
        if dtype != torch.float32 or len(shape) != 2 or shape[1] != D \
                or device != dev or not contiguous:
            raise ValueError(
                f"table {f} is {dtype}{list(shape)} on {device} "
                f"(contiguous={contiguous}); the kernel needs "
                f"contiguous float32 [V, {D}] tables on {dev}")
        align = min(align, _alignment(ptr))
    meta = None
    if dev.type == "cuda":
        meta = torch.tensor([k[0] for k in key] + [k[1][0] for k in key],
                            dtype=torch.int64, device=dev)
    return meta, D, align


class BagTables(tuple):
    """F tables checked for the kernel (``prepare_tables``): a tuple of
    the tables, with ``meta`` (on the card, their pointers then their row
    counts as int64; None on the CPU), ``D``, ``align`` (the bytes of
    alignment, up to 16, that every table shares) and ``device``."""
    meta: torch.Tensor | None
    D: int
    align: int
    device: torch.device


def _prepare(tables, dev: torch.device) -> BagTables:
    prepared = BagTables(tables)
    prepared.meta, prepared.D, prepared.align = _checked(_key(prepared), dev)
    prepared.device = dev
    return prepared


def prepare_tables(tables) -> BagTables:
    """``tables`` checked once, on the first one's device (ValueError
    otherwise), as a handle that ``embedding_bags`` takes without reading
    the tables again.  It holds each table's pointer and row count as they
    are now: writes to a table's rows show through it, but a table
    resized or given other storage afterwards does not, so prepare again
    after such a change."""
    if not tables:
        raise ValueError("no tables")
    return _prepare(tables, tables[0].device)


def _check(tables, indices, weights, combiner):
    """Check what the kernel takes; raises ValueError otherwise.  Returns
    the tables as a ``BagTables``."""
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
    if not isinstance(tables, BagTables):
        tables = _prepare(tables, dev)
    elif tables.device != dev:
        raise ValueError(f"the tables were prepared on {tables.device}; "
                         f"the indices are on {dev}")
    if weights is not None and (
            weights.dtype != torch.float32 or weights.device != dev
            or weights.shape != indices.shape
            or not weights.is_contiguous()):
        raise ValueError(f"weights is {weights.dtype}{list(weights.shape)} "
                         f"on {weights.device}; the kernel needs contiguous "
                         f"float32 {list(indices.shape)} on {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"the EmbeddingBag runs on cuda or cpu, not {dev}")
    return tables


def launch(tables, indices: torch.Tensor,
           weights: torch.Tensor | None = None, combiner: str = "sum",
           shape: Geometry | None = None) -> torch.Tensor:
    """One launch of the kernel on CUDA inputs (checked here): [B, F, D]
    f32, with the warp ``shape`` that ``geometry`` picks unless given (the
    C entry refuses one it was not built for).  Adds one to the module's
    ``launches``."""
    global launches
    tables = _check(tables, indices, weights, combiner)
    meta, D, align = tables.meta, tables.D, tables.align
    dev = indices.device
    if dev.type != "cuda":
        raise ValueError(f"the kernel runs on cuda, not {dev}")
    B, F, L = indices.shape
    out = torch.empty((B, F, D), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    g = shape or geometry(D, L, min(align, _alignment(out.data_ptr())))
    lib = _library()
    # the device's context only where it is not current (~5 us a call)
    with contextlib.nullcontext() if dev.index == torch.cuda.current_device() \
            else torch.cuda.device(dev):
        err = lib.embedding_bag_launch(
            meta.data_ptr(), meta.data_ptr() + 8 * F, indices.data_ptr(),
            None if weights is None else weights.data_ptr(), out.data_ptr(),
            B * F, F, L, D, int(combiner == "mean"), *g,
            torch._C._cuda_getCurrentRawStream(dev.index))
    if err:
        raise RuntimeError("embedding_bag kernel launch failed: "
                           + lib.embedding_bag_error_string(err).decode())
    launches += 1
    shape_launches[g] += 1
    return out


def embedding_bags(tables, indices: torch.Tensor,
                   weights: torch.Tensor | None = None,
                   combiner: str = "sum") -> torch.Tensor:
    """All F fields in one launch: [B, F, L] -> [B, F, D] f32.
    ``tables``: F tensors or a ``prepare_tables`` handle.  Each kernel
    launch adds one to the module's ``launches``."""
    if indices.device.type == "cpu":
        _check(tables, indices, weights, combiner)
        return embedding_bags_ref(tables, indices, weights, combiner)
    return launch(tables, indices, weights, combiner)


def embedding_bag_fwd(table: torch.Tensor, indices: torch.Tensor,
                      weights: torch.Tensor | None = None,
                      combiner: str = "sum") -> torch.Tensor:
    """table: [V, D] f32; indices: [B, L] int32 -> [B, D] f32."""
    if indices.dim() != 2:
        raise ValueError(f"indices must be [B, L], got {list(indices.shape)}")
    return embedding_bags([table], indices[:, None],
                          None if weights is None else weights[:, None],
                          combiner)[:, 0]
