"""Host wrapper of the CUDA cycle kernel (``csrc/cca_cycle.cu``).

``cca_cycle_chunk`` runs up to ``n_cycles`` (default ``cfg.chunk``)
engine cycles with freeze-at-quiescence and returns ``(state, int32
[quiescent, cycles_run])``, the contract of the JAX package's
``cca_cycle_chunk``.  For a state on the card it launches the kernel,
which updates every leaf **in place** (the returned state is the same
object); for a state on the CPU it runs the plain version
(``ref.cca_cycle_chunk_ref``), which returns a new state.  Any other device is
refused.

The kernel is built with ``nvcc`` for ``sm_90a`` at first use, into
``build/<hash of source and flags>/`` beside this file, and loaded with
``ctypes`` (``kernels/_build.py``).
"""
from __future__ import annotations

import ctypes
import functools
import pathlib

import torch

from repro_torch.core.alloc import vicinity_offsets
from repro_torch.core.apps import DiffusionApp
from repro_torch.core.config import EngineConfig
from repro_torch.core.state import MachineState, init_state
from repro_torch.kernels import _build
from repro_torch.kernels.cca_cycle.ref import cca_cycle_chunk_ref

HERE = pathlib.Path(__file__).resolve().parent
SOURCE = HERE / "csrc" / "cca_cycle.cu"
NVCC_FLAGS = _build.SM90A_FLAGS + ("--fmad=false",)   # bit-exact f32 sums

launches = 0   # kernel launches made by cca_cycle_chunk

# state leaves handed to the kernel, in the order of `struct Leaves`
KERNEL_LEAVES = (
    "vals", "nedges", "edst", "ew", "gaddr", "gstate", "rhz_on", "rstate",
    "nfree", "fq", "fq_n", "fq_head", "fwd_val", "fwd_pending",
    "aq", "aq_n", "aq_head", "ch", "ch_n", "ch_head", "ch_rr", "pk_n",
    "cmsg", "cvalid", "cphase", "cT", "cemit", "cout", "cdrain",
    "io_edges", "io_n", "io_pos", "arot",
    "cycle", "stat_hops", "stat_exec", "stat_stall", "stat_allocs")


def build() -> tuple[pathlib.Path, str]:
    """Compile the kernel library if this source and these flags have
    not been built yet.  Returns ``(library path, nvcc's -Xptxas -v
    report)``."""
    return _build.build(SOURCE, NVCC_FLAGS)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()[0]))
    lib.cca_cycle_launch.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_void_p]
    lib.cca_cycle_launch.restype = ctypes.c_int
    lib.cca_cycle_error_string.argtypes = [ctypes.c_int]
    lib.cca_cycle_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _layout(cfg: EngineConfig) -> dict:
    """``{leaf: (shape, dtype)}`` that ``cfg`` gives the state."""
    return {k: (tuple(v.shape), v.dtype) for k, v in
            init_state(cfg, device="meta")._asdict().items()}


def _dims(cfg: EngineConfig, app: DiffusionApp, n_offs: int,
          n_cycles: int) -> list[int]:
    """Scalar geometry, in the order of `struct Dims`."""
    return [cfg.height, cfg.width, cfg.slots, cfg.edge_cap, cfg.queue_cap,
            cfg.futq_cap, cfg.lane_capacity, cfg.io_cells, cfg.io_stream_cap,
            cfg.root_slots, cfg.primary_slots, cfg.rhizome_cap,
            cfg.rhizome_stride, cfg.aq_reserve, cfg.sys_reserve, n_offs,
            app.code, n_cycles]


def _launch_args(cfg: EngineConfig, app: DiffusionApp, st: MachineState,
                 n_cycles: int):
    """The kernel's tensors, in the order of `struct Leaves` (the state
    leaves, the vicinity table, the per-cell scratch, the record last),
    and its `struct Dims`."""
    dev = st.aq.device
    offs = torch.as_tensor(vicinity_offsets(cfg.vicinity_hops), device=dev)

    def scratch(n):
        return torch.empty(n, dtype=torch.int32, device=dev)

    cells = cfg.n_cells
    tensors = [getattr(st, k) for k in KERNEL_LEAVES] + [
        offs, scratch(cells * cfg.msg_words), scratch(cells), scratch(cells),
        scratch(8)]
    return tensors, _dims(cfg, app, len(offs), n_cycles)


def _check(cfg: EngineConfig, st: MachineState) -> torch.device:
    dev = st.aq.device
    for name, (shape, dtype) in _layout(cfg).items():
        t = getattr(st, name)
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(
                f"state leaf {name!r} is {t.dtype}{list(t.shape)} on "
                f"{t.device} (contiguous={t.is_contiguous()}); the kernel "
                f"needs a contiguous {dtype}{list(shape)} on {dev}")
    return dev


def cca_cycle_chunk(cfg: EngineConfig, app: DiffusionApp, st: MachineState,
                    n_cycles: int | None = None):
    """Run up to ``n_cycles`` engine cycles, frozen at quiescence.

    Returns ``(state, counters)`` with ``counters`` int32 ``[quiescent at
    end, cycles run]`` on the state's device.  Each kernel launch adds
    one to the module's ``launches``.
    """
    global launches
    cfg.validate()
    n_cycles = cfg.chunk if n_cycles is None else int(n_cycles)
    if n_cycles < 0:
        raise ValueError(f"n_cycles must be >= 0, got {n_cycles}")
    dev = _check(cfg, st)
    if dev.type == "cpu":
        return cca_cycle_chunk_ref(cfg, app, st, n_cycles)
    if dev.type != "cuda":
        raise ValueError(f"cca_cycle_chunk runs on cuda or cpu, not {dev}")
    lib = _library()
    tensors, dims = _launch_args(cfg, app, st, n_cycles)
    rec = tensors[-1]
    ptrs = (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])
    dims_c = (ctypes.c_int * len(dims))(*dims)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.cca_cycle_launch(ptrs, len(tensors), dims_c, len(dims),
                                   stream)
    if err:
        raise RuntimeError("cca_cycle kernel launch failed: "
                           + lib.cca_cycle_error_string(err).decode())
    launches += 1
    return st, rec[5:7]
