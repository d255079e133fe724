"""Host wrapper of the CUDA scatter-SpMM kernel (``csrc/spmm.cu``).

``scatter_spmm(msgs, dst, n_nodes)`` and ``spmm_sorted_coo(x, src, dst,
n_nodes, coeff)`` keep the JAX package's contracts (``[n_nodes, D]`` f32,
edges sorted by ``dst``).  The TPU tile knobs ``bn`` and ``be`` and the
``interpret`` switch have no counterpart here and are dropped: on a CUDA
tensor the wrapper launches the kernel (or raises); on a CPU tensor it
runs the plain version (``ref.py``).  Both devices get the same checks:
f32 contiguous messages, int32 contiguous indices, ``dst`` sorted
ascending.

The kernel reads each destination row's edges through row pointers,
``row_pointers(dst, n_nodes)``: it checks that ``dst`` is sorted (one
read of ``dst`` and a host sync) and binary-searches it on the device,
so a destination outside ``[0, n_nodes)`` falls outside every row and is
dropped.  A caller that sums over one edge set many times builds them
once and passes ``rowptr=``; the call then makes neither the check nor
the search (``models.gnn.sort_edges`` does so once per graph).

The warp's shape comes from ``geometry(D, aligned)``: lanes over the
columns for ``D >= 32``, else edge groups of a few lanes (float4 loads
where ``D % 4 == 0`` and x is 16-byte aligned), as ``csrc/spmm.cu`` says;
``ref.py::spmm_ordered`` sums in the order each shape sums.  The
kernel is built with ``nvcc`` for ``sm_90a`` at first use
(``kernels/_build.py``) and loaded with ``ctypes``.

Gradients: with grad on and an input that requires it, both calls go
through ``torch.autograd.Function``s.  ``scatter_spmm``'s backward is
``g[dst]`` (a gather, what XLA's autodiff of ``segment_sum`` gives).
``spmm_sorted_coo``'s backward computes dx = A^T g on the card by the
same kernel over the transposed edges (``transpose_edges``: the kept
edges sorted by source, their destinations as the sources and row
pointers over the sources), which the caller builds once a graph and
passes as ``transposed=`` (``models.gnn.add_transposed`` keeps them in
the graph), and dcoeff[e] = <x[src[e]], g[dst[e]]> in
plain PyTorch, only where coeff needs a gradient.  On CPU tensors both
backwards are the plain ones of ``ref.py``.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.spmm.ref import (scatter_spmm_bwd_ref,
                                          scatter_spmm_ref, source_rows,
                                          spmm_sorted_coo_bwd_ref,
                                          spmm_sorted_coo_ref, take_rows)

HERE = pathlib.Path(__file__).resolve().parent
SOURCE = HERE / "csrc" / "spmm.cu"
NVCC_FLAGS = _build.SM90A_FLAGS

launches = 0   # kernel launches made by scatter_spmm / spmm_sorted_coo
bwd_launches = 0   # of them, the transposed launches of the backward


def build() -> tuple[pathlib.Path, str]:
    """Compile the kernel library unless built; ``(path, ptxas report)``."""
    return _build.build(SOURCE, NVCC_FLAGS)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()[0]))
    lib.spmm_csr_launch.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.spmm_csr_launch.restype = ctypes.c_int
    lib.spmm_error_string.argtypes = [ctypes.c_int]
    lib.spmm_error_string.restype = ctypes.c_char_p
    return lib


def _need(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int,
          dev: torch.device) -> None:
    if t.dtype != dtype or t.dim() != ndim or t.device != dev \
            or not t.is_contiguous():
        raise ValueError(
            f"{name} is {t.dtype}{list(t.shape)} on {t.device} "
            f"(contiguous={t.is_contiguous()}); the kernel needs a "
            f"contiguous {ndim}-D {dtype} on {dev}")


def _check(x, src, dst, coeff, n_nodes: int, rowptr) -> torch.Tensor:
    """Check what the kernel takes (ValueError otherwise); the row
    pointers, built here unless given."""
    dev = x.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"the scatter-SpMM runs on cuda or cpu, not {dev}")
    _need(x, "x" if src is not None else "msgs", torch.float32, 2, dev)
    _need(dst, "dst", torch.int32, 1, dev)
    n_edges = dst.shape[0]
    if src is not None:
        _need(src, "src", torch.int32, 1, dev)
        if src.shape[0] != n_edges:
            raise ValueError(f"src has {src.shape[0]} edges, dst {n_edges}")
    elif x.shape[0] != n_edges:
        raise ValueError(f"msgs has {x.shape[0]} rows, dst {n_edges}")
    if coeff is not None:
        _need(coeff, "coeff", torch.float32, 1, dev)
        if coeff.shape[0] != n_edges:
            raise ValueError(f"coeff has {coeff.shape[0]} edges, dst "
                             f"{n_edges}")
    if not 0 <= n_nodes < 2 ** 31 or n_edges >= 2 ** 31 \
            or x.shape[0] >= 2 ** 31:
        raise ValueError(f"n_nodes {n_nodes}, {n_edges} edges and "
                         f"{x.shape[0]} rows must fit in int32")
    if rowptr is None:
        return row_pointers(dst, n_nodes)
    _need(rowptr, "rowptr", torch.int32, 1, dev)
    if rowptr.shape[0] != n_nodes + 1:
        raise ValueError(f"rowptr has {rowptr.shape[0]} entries, not "
                         f"n_nodes + 1 = {n_nodes + 1}")
    return rowptr


def row_pointers(dst: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """int32 [n_nodes + 1]: the first edge of each destination row of the
    int32 ``dst``, which must be sorted ascending (checked: one read and a
    host sync), by a binary search on its device."""
    if dst.numel() > 1 and bool((dst[1:] < dst[:-1]).any()):
        raise ValueError("dst must be sorted ascending (sort the edges "
                         "by destination once per graph)")
    return torch.searchsorted(
        dst, torch.arange(n_nodes + 1, dtype=torch.int32, device=dst.device),
        out_int32=True)


WIDE = (32, 1)   # lanes over the columns, one edge at a time


def geometry(D: int, aligned: bool = True) -> tuple[int, int]:
    """(lanes an edge, floats a lane load) of the kernel's warp at width
    ``D``: the wide shape ``WIDE`` for ``D >= 32``; below it, the fewest
    lanes (a power of two) whose float4 loads cover ``D`` when ``D % 4 ==
    0`` and x is 16-byte ``aligned``, else whose scalar loads do (the
    wide shape again if that takes 32).  The warp is then ``32 / lanes``
    edge groups."""
    if D >= 32:
        return WIDE
    vec = 4 if D % 4 == 0 and aligned else 1
    lanes = 1 << (-(-D // vec) - 1).bit_length()
    return (lanes, vec) if lanes < 32 else WIDE


def launch(x, src, coeff, rowptr, n_nodes: int,
           shape: tuple[int, int] | None = None,
           transposed: bool = False) -> torch.Tensor:
    """One launch of the kernel on checked CUDA inputs and their row
    pointers: [n_nodes, D] f32, with the warp ``shape`` (lanes, vec) that
    ``geometry`` picks unless given (the C entry refuses one it was not
    built for).  ``transposed``: a backward's launch over the transposed
    edges, counted in ``bwd_launches`` too."""
    global launches, bwd_launches
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"the kernel runs on cuda, not {dev}")
    out = torch.empty((n_nodes, x.shape[1]), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    lib = _library()
    n_edges = x.shape[0] if src is None else src.shape[0]
    lanes, vec = shape or geometry(x.shape[1], x.data_ptr() % 16 == 0)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.spmm_csr_launch(ptr(x), ptr(src), ptr(coeff), ptr(rowptr),
                                  ptr(out), n_nodes, x.shape[0], n_edges,
                                  x.shape[1], lanes, vec, stream)
    if err:
        raise RuntimeError("spmm kernel launch failed: "
                           + lib.spmm_error_string(err).decode())
    launches += 1
    bwd_launches += int(transposed)
    return out


class Transposed(NamedTuple):
    """An edge list transposed for ``spmm_sorted_coo``'s backward: ``perm``
    [E] int64, the edges in a stable order by the row of ``x`` their
    ``src`` names, those that carry no gradient (a destination dropped, or
    a source outside ``[-n_src, n_src)``: ``ref.source_rows``) last;
    ``src`` [E] int32, their destinations; ``rowptr`` int32 [n_src + 1]
    over those rows (the edges without gradient lie past its end)."""
    perm: torch.Tensor
    src: torch.Tensor
    rowptr: torch.Tensor


def transpose_edges(src: torch.Tensor, dst: torch.Tensor, n_src: int,
                    n_nodes: int) -> Transposed:
    """The transposed edges of (``src``, ``dst``) for ``n_src`` source
    rows and ``n_nodes`` destinations (a stable sort; no host sync)."""
    rows, valid = source_rows(src, n_src)
    keep = valid & (dst >= 0) & (dst < n_nodes)
    # the edges without gradient sort last, past every row's pointers
    key, perm = torch.sort(torch.where(keep, rows, n_src), stable=True)
    rowptr = torch.searchsorted(
        key, torch.arange(n_src + 1, dtype=key.dtype, device=key.device),
        out_int32=True)
    return Transposed(perm, dst[perm].contiguous(), rowptr)


class ScatterSpmm(torch.autograd.Function):
    """``scatter_spmm`` with its gradient ``g[dst]``."""

    @staticmethod
    def forward(ctx, msgs, dst, n_nodes, rowptr):
        ctx.save_for_backward(dst)
        ctx.n_nodes = n_nodes
        if msgs.device.type == "cpu":
            return scatter_spmm_ref(msgs, dst, n_nodes)
        return launch(msgs, None, None, rowptr, n_nodes)

    @staticmethod
    def backward(ctx, g):
        (dst,) = ctx.saved_tensors
        return scatter_spmm_bwd_ref(g, dst, ctx.n_nodes), None, None, None


class SpmmSortedCoo(torch.autograd.Function):
    """``spmm_sorted_coo`` with its gradients: dx = A^T g by the kernel
    over the transposed edges on the card, dcoeff plain."""

    @staticmethod
    def forward(ctx, x, coeff, src, dst, n_nodes, rowptr, transposed):
        ctx.save_for_backward(x, coeff, src, dst)
        ctx.n_nodes, ctx.transposed = n_nodes, transposed
        if x.device.type == "cpu":
            return spmm_sorted_coo_ref(x, src, dst, n_nodes, coeff)
        return launch(x, src, coeff, rowptr, n_nodes)

    @staticmethod
    def backward(ctx, g):
        x, coeff, src, dst = ctx.saved_tensors
        n = ctx.n_nodes
        g = g.float().contiguous()
        if x.device.type == "cpu":
            dx, dcoeff = spmm_sorted_coo_bwd_ref(g, x, src, dst, n, coeff)
        else:
            dx = dcoeff = None
            if ctx.needs_input_grad[0]:
                t = ctx.transposed
                dx = launch(g, t.src, None if coeff is None
                            else coeff[t.perm].contiguous(), t.rowptr,
                            x.shape[0], transposed=True)
            if coeff is not None and ctx.needs_input_grad[1]:
                keep = (dst >= 0) & (dst < n)
                gd = g[dst.long().clamp(0, max(n - 1, 0))]
                dcoeff = torch.where(keep, (take_rows(x, src) * gd).sum(-1),
                                     0.0)
        if not ctx.needs_input_grad[1]:
            dcoeff = None
        return dx, dcoeff, None, None, None, None, None


def wants_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ts)


def scatter_spmm(msgs: torch.Tensor, dst: torch.Tensor, n_nodes: int,
                 rowptr: torch.Tensor | None = None) -> torch.Tensor:
    """msgs: [E, D] f32 edge messages; dst: [E] int32 sorted ascending;
    rowptr: ``row_pointers(dst, n_nodes)``, built here unless given.
    Returns the [n_nodes, D] f32 segment sums.  Each kernel launch adds
    one to the module's ``launches``."""
    rowptr = _check(msgs, None, dst, None, n_nodes, rowptr)
    if wants_grad(msgs):
        return ScatterSpmm.apply(msgs, dst, n_nodes, rowptr)
    if msgs.device.type == "cpu":
        return scatter_spmm_ref(msgs, dst, n_nodes)
    return launch(msgs, None, None, rowptr, n_nodes)


def spmm_sorted_coo(x: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                    n_nodes: int, coeff: torch.Tensor | None = None,
                    rowptr: torch.Tensor | None = None,
                    transposed: Transposed | None = None) -> torch.Tensor:
    """A @ X over a COO edge list sorted by dst (the GNN hot path): the
    segment sum of ``x[src] * coeff`` by ``dst``, [n_nodes, D] f32, with
    the gather and the scale fused into the kernel.  ``transposed``:
    ``transpose_edges(src, dst, len(x), n_nodes)``, which the backward
    runs over on the card; needed there when x requires grad."""
    rowptr = _check(x, src, dst, coeff, n_nodes, rowptr)
    if wants_grad(x, coeff):
        if transposed is None and x.device.type == "cuda" and \
                x.requires_grad:
            raise ValueError(
                "spmm_sorted_coo: x requires grad, and its backward on the "
                "card runs over transpose_edges(src, dst, len(x), n_nodes): "
                "build them once a graph and pass them as transposed=")
        return SpmmSortedCoo.apply(x, coeff, src, dst, n_nodes, rowptr,
                                   transposed)
    if x.device.type == "cpu":
        return spmm_sorted_coo_ref(x, src, dst, n_nodes, coeff)
    return launch(x, src, coeff, rowptr, n_nodes)
