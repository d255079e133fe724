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

Gradients: with grad on and a table that requires it, ``embedding_bags``
goes through ``EmbeddingBags`` (a ``torch.autograd.Function`` whose
inputs are the F tables; a ``prepare_tables`` handle stays valid, as the
optimizer updates the tables in place).  Its backward returns each
table's dense gradient ``[V_f, D]``, as JAX's autodiff of the gather
does, as views of one ``torch.empty`` buffer that the kernels write
whole, each row once (``launch_bwd``): on the card ``bwd_keys`` (the key
kernel writes each lookup's global row, its table's row plus the rows of
the tables before it, as int32 with the total of rows for a dropped
lookup, and its int32 position; then a stable sort of the pairs over the
low ``total.bit_length()`` bits by CUB's radix sort, ``bwd_sort``) and
``bwd_kernel`` (the segments kernel sums each run of one row within a
segment of ``SEGMENT`` = 32 sorted lookups, fixed when the library is
built, and writes the runs that lie in one segment; the rows kernel
writes every other row: zeros, or the segment partials of a run that
spans several, in segment order).  No float atomics, so the same bits
every run: those of ``ref.embedding_bags_bwd_ordered``.  Keys and
positions are int32: a call with 2^31 or more rows over all tables, or
lookups, raises a ``ValueError`` (``bwd_bits``); every configuration of
the repo is far below (DLRM-RM2 whole is 143,697,920 rows).  On the CPU
the backward is the plain ``index_add_`` of
``ref.embedding_bags_bwd_ref``.  Weights get no gradient (no caller
trains them): a weight that requires one raises.
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
from repro_torch.kernels.embedding_bag.ref import (SEGMENT,
                                                   embedding_bags_bwd_ref,
                                                   embedding_bags_ref)

HERE = pathlib.Path(__file__).resolve().parent
SOURCE = HERE / "csrc" / "embedding_bag.cu"
NVCC_FLAGS = _build.SM90A_FLAGS
COMBINERS = ("sum", "mean")
LOAD_FLOATS = 32        # the kernel's LOAD_FLOATS: row floats a lane
CHUNK = 8               # lookups a step of the kernel for any other L
TILE_L = (1, 2, 4, 8)   # the L the tile kernel is built for

BWD_SEGMENTS, BWD_ROWS = 1, 2   # the backward C entry's ``parts``
BWD_ALL = BWD_SEGMENTS | BWD_ROWS

launches = 0   # kernel launches made by embedding_bags / embedding_bag_fwd
bwd_launches = 0   # backward launches (segments and rows kernels: one a call)
bwd_key_launches = 0   # key kernel launches (one a backward)
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
    lib.embedding_bag_bwd_keys.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_void_p]
    lib.embedding_bag_bwd_keys.restype = ctypes.c_int
    lib.embedding_bag_bwd_sort.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    lib.embedding_bag_bwd_sort.restype = ctypes.c_int
    lib.embedding_bag_bwd_launch.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_longlong] * 2 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.embedding_bag_bwd_launch.restype = ctypes.c_int
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


def _error(err: int) -> str:
    return _library().embedding_bag_error_string(err).decode()


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
             ) -> tuple[torch.Tensor | None, int, int, int]:
    """Check the tables from their ``_key`` for a launch on ``dev``
    (ValueError otherwise).  Returns, on the card, the table pointers,
    their row counts and their first global rows (the rows of the tables
    before each) as an int64 device array (None on the CPU), D, the
    alignment in bytes (up to 16) that every table shares, and the total
    of rows.  Cached by the key, so a call over the same tables makes no
    check and no host-to-device copy (and no host sync)."""
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
    rows = [k[1][0] for k in key]
    firsts = [sum(rows[:f]) for f in range(len(rows))]
    meta = None
    if dev.type == "cuda":
        meta = torch.tensor([k[0] for k in key] + rows + firsts,
                            dtype=torch.int64, device=dev)
    return meta, D, align, sum(rows)


class BagTables(tuple):
    """F tables checked for the kernel (``prepare_tables``): a tuple of
    the tables, with ``meta`` (on the card, their pointers, their row
    counts and their first global rows as int64; None on the CPU), ``D``,
    ``align`` (the bytes of alignment, up to 16, that every table
    shares), ``total`` (their rows) and ``device``."""
    meta: torch.Tensor | None
    D: int
    align: int
    total: int
    device: torch.device


def _prepare(tables, dev: torch.device) -> BagTables:
    prepared = BagTables(tables)
    prepared.meta, prepared.D, prepared.align, prepared.total = _checked(
        _key(prepared), dev)
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


def bwd_bits(n: int, total: int) -> int:
    """The key bits the backward's sort covers for ``n`` lookups into
    ``total`` rows: ``total.bit_length()`` (keys run 0 .. total), at least
    1.  Keys and positions are int32, so 2^31 or more of either raises a
    ``ValueError``."""
    if n >= 2 ** 31 or total >= 2 ** 31:
        raise ValueError(f"the bag backward keys {n} lookups into {total} "
                         f"rows as int32: both must stay below 2^31")
    return max(1, total.bit_length())


def bwd_key_pass(tables: BagTables, indices: torch.Tensor):
    """One launch of the key kernel: (keys, pos), each lookup's global row
    (``tables.total`` for a dropped one) and flat (b, f, l) position, both
    int32 [B F L] in (b, f, l) order.  Adds one to the module's
    ``bwd_key_launches``."""
    global bwd_key_launches
    _, F, L = indices.shape
    n, total = indices.numel(), tables.total
    bwd_bits(n, total)
    dev = indices.device
    keys = torch.empty(n, dtype=torch.int32, device=dev)
    pos = torch.empty(n, dtype=torch.int32, device=dev)
    if n:
        meta = tables.meta
        err = _library().embedding_bag_bwd_keys(
            indices.data_ptr(), meta.data_ptr() + 8 * F,
            meta.data_ptr() + 16 * F, keys.data_ptr(), pos.data_ptr(), n,
            F, L, total,
            torch._C._cuda_getCurrentRawStream(dev.index))
        if err:
            raise RuntimeError("embedding_bag key kernel launch failed: "
                               + _error(err))
        bwd_key_launches += 1
    return keys, pos


def bwd_sort(keys: torch.Tensor, pos: torch.Tensor, total: int):
    """The (key, position) pairs sorted stably by key: CUB's radix sort
    over the low ``bwd_bits`` bits, the positions carried as int32 (twice
    as fast as ``torch.sort`` of the int32 keys on an H100, which sorts
    all 32 bits and makes int64 positions: ``chip_smoke.py`` phase 49
    times both)."""
    n = keys.numel()
    if not n:
        return keys, pos
    bits = bwd_bits(n, total)
    lib = _library()
    stream = torch._C._cuda_getCurrentRawStream(keys.device.index)
    nbytes = ctypes.c_ulonglong(0)
    out_k, out_p = torch.empty_like(keys), torch.empty_like(pos)
    args = (keys.data_ptr(), out_k.data_ptr(), pos.data_ptr(),
            out_p.data_ptr(), n, bits, stream)
    err = lib.embedding_bag_bwd_sort(None, ctypes.byref(nbytes), *args)
    if not err:
        temp = torch.empty(nbytes.value, dtype=torch.uint8,
                           device=keys.device)
        err = lib.embedding_bag_bwd_sort(temp.data_ptr(),
                                         ctypes.byref(nbytes), *args)
    if err:
        raise RuntimeError("embedding_bag backward sort failed: "
                           + _error(err))
    return out_k, out_p


def bwd_keys(tables: BagTables, indices: torch.Tensor):
    """The backward's preparation on the card: (keys, pos, total), the key
    pass (``bwd_key_pass``) sorted by ``bwd_sort``."""
    keys, pos = bwd_key_pass(tables, indices)
    keys, pos = bwd_sort(keys, pos, tables.total)
    return keys, pos, tables.total


def bwd_shape(D: int, align: int = 16) -> tuple[int, int]:
    """The backward kernels' group for width ``D`` when the bag gradients,
    the dense gradients and the partials share ``align`` bytes of
    alignment: (lanes, vec), float4 where ``D % 4 == 0`` and ``align`` is
    16, float2 where ``D % 2 == 0`` and it is 8, else scalar; the fewest
    lanes, a power of two up to 32 (then strips), whose loads cover D.  At
    D = 64, 16 lanes: two segments a warp."""
    vec = 4 if D % 4 == 0 and align % 16 == 0 else \
        2 if D % 2 == 0 and align % 8 == 0 else 1
    return min(32, 1 << (-(-D // vec) - 1).bit_length()), vec


def bwd_kernel(keys, pos, gout, weights, grad, L: int, combiner: str,
               parts: int = BWD_ALL) -> None:
    """The backward kernels on the sorted ``keys`` and ``pos``: ``grad``
    [total, D] (any contents) gets every row, written once; ``parts``
    launches the segments kernel, the rows kernel or both (phase 49 of
    ``chip_smoke.py`` times each alone).  Adds one to the module's
    ``bwd_launches`` where it launched a kernel (none for no lookups into
    no rows)."""
    global bwd_launches
    n, (total, D) = keys.numel(), grad.shape
    partial = torch.empty((-(-n // SEGMENT), 2, D), dtype=torch.float32,
                          device=grad.device)
    align = min(_alignment(x.data_ptr()) for x in (gout, grad, partial))
    lib = _library()
    err = lib.embedding_bag_bwd_launch(
        keys.data_ptr(), pos.data_ptr(), gout.data_ptr(),
        None if weights is None else weights.data_ptr(), grad.data_ptr(),
        partial.data_ptr(), n, total, L, D, int(combiner == "mean"),
        SEGMENT, *bwd_shape(D, align), parts,
        torch._C._cuda_getCurrentRawStream(grad.device.index))
    if err:
        raise RuntimeError("embedding_bag backward launch failed: "
                           + _error(err))
    if (parts & BWD_SEGMENTS and n) or (parts & BWD_ROWS and total):
        bwd_launches += 1


def launch_bwd(tables, indices: torch.Tensor, gout: torch.Tensor,
               weights: torch.Tensor | None = None,
               combiner: str = "sum") -> list:
    """The F tables' dense gradients [V_f, D] f32 (views of one
    ``torch.empty`` buffer, each row written once by the kernels) for the
    bag gradients ``gout`` [B, F, D]: ``bwd_keys``, then ``bwd_kernel``,
    on CUDA inputs; ``tables`` a ``BagTables`` handle or tensors."""
    tables = _check(tables, indices, weights, combiner)
    dev = indices.device
    if dev.type != "cuda":
        raise ValueError(f"the kernel runs on cuda, not {dev}")
    B, F, L = indices.shape
    if gout.shape != (B, F, tables.D) or gout.device != dev:
        raise ValueError(f"gout is {list(gout.shape)} on {gout.device}; the "
                         f"backward needs [{B}, {F}, {tables.D}] on {dev}")
    keys, pos, total = bwd_keys(tables, indices)
    grad = torch.empty((total, tables.D), dtype=torch.float32, device=dev)
    bwd_kernel(keys, pos, gout.float().contiguous(), weights, grad, L,
               combiner)
    return list(torch.split(grad, [t.shape[0] for t in tables]))


class EmbeddingBags(torch.autograd.Function):
    """``embedding_bags`` with the tables' gradients."""

    @staticmethod
    def forward(ctx, indices, weights, combiner, tables, *leaves):
        ctx.save_for_backward(indices, weights)
        ctx.combiner, ctx.tables = combiner, tables
        if indices.device.type == "cpu":
            return embedding_bags_ref(tables, indices, weights, combiner)
        return launch(tables, indices, weights, combiner)

    @staticmethod
    def backward(ctx, gout):
        indices, weights = ctx.saved_tensors
        if indices.device.type == "cpu":
            grads = embedding_bags_bwd_ref([t.shape[0] for t in ctx.tables],
                                           indices, gout, weights,
                                           ctx.combiner)
        else:
            grads = launch_bwd(ctx.tables, indices, gout, weights,
                               ctx.combiner)
        return (None, None, None, None, *grads)


def embedding_bags(tables, indices: torch.Tensor,
                   weights: torch.Tensor | None = None,
                   combiner: str = "sum") -> torch.Tensor:
    """All F fields in one launch: [B, F, L] -> [B, F, D] f32.
    ``tables``: F tensors or a ``prepare_tables`` handle.  Each kernel
    launch adds one to the module's ``launches``; with grad on and a table
    that requires it, the output has a ``grad_fn`` (``EmbeddingBags``)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tables):
        if weights is not None and weights.requires_grad:
            raise NotImplementedError(
                "embedding_bags gives the tables a gradient, not the "
                "weights (no caller of the port trains them)")
        tables = _check(tables, indices, weights, combiner)
        return EmbeddingBags.apply(indices, weights, combiner, tables,
                                   *tables)
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
