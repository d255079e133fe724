"""Host wrapper of the CUDA cycle kernels (``csrc/cca_cycle.cu``).

``cca_cycle_chunk`` runs up to ``n_cycles`` (default ``cfg.chunk``)
engine cycles with freeze-at-quiescence and returns ``(state, int32
[quiescent, cycles_run])``, the contract of the JAX package's
``cca_cycle_chunk``.  Given ``trace``, an int32 ``[n_cycles, 2]`` tensor
of the caller's, it also fills row ``t`` with cycle ``t``'s ``(active
cells, messages in flight after it)`` for every cycle run (the stats of
``core.engine.cycle_step``).  For a state on the card it launches a
kernel, which updates every leaf **in place** (the returned state is the
same object); for a state on the CPU it runs the plain version
(``ref.cca_cycle_chunk_ref``), which returns a new state.  Any other
device is refused.

With ``cfg.telemetry`` the launch takes the kernels' telemetry instances,
which also accumulate the state's telemetry planes (``tm_cell``,
``tm_lane``, ``tm_hiw``) as ``core.engine.cycle_body`` does; the launch
record and the trace rows are the same.  With ``cfg.faults`` it takes
their fault instances, which inject the plan's hazards in the hop stage,
seal and check the messages, run ``OP_REPAIR`` and count into ``flt`` as
``core.engine.cycle_body`` does; the plan reaches the kernel as the hash
keys and thresholds in `struct Dims` and the blackout windows as a small
int32 table on the state's device.

Two kernels compute the same chunk (``path``):

  cluster  the grid in row bands over the CTAs of one thread-block
           cluster, each band's per-cell leaves in shared memory
           (``csrc/cca_cycle_cluster.cuh``), where ``cluster_geometry``
           finds a band that fits;
  block    one thread block, every leaf in device memory, for any grid.

``path="auto"`` takes the cluster kernel wherever ``cluster_geometry``
returns one and the one-block kernel only where it returns ``None``;
``"cluster"`` or ``"block"`` forces one (``"cluster"`` raises where no band
fits).  Nothing falls back: a refused launch raises.

The kernels are built with ``nvcc`` for ``sm_90a`` at first use, into
``build/<hash of sources and flags>/`` beside this file, and loaded with
``ctypes`` (``kernels/_build.py``).
"""
from __future__ import annotations

import ctypes
import functools
import math
import pathlib

import torch

from repro_torch.core.alloc import vicinity_offsets
from repro_torch.core.apps import DiffusionApp
from repro_torch.core.config import EngineConfig
from repro_torch.core.state import MachineState, init_state
from repro_torch.kernels import _build
from repro_torch.kernels.cca_cycle.ref import cca_cycle_chunk_ref
from repro_torch.resilience.faults import fault_key

HERE = pathlib.Path(__file__).resolve().parent
SOURCE = HERE / "csrc" / "cca_cycle.cu"
NVCC_FLAGS = _build.SM90A_FLAGS + ("--fmad=false",)   # bit-exact f32 sums

PATHS = ("block", "cluster")   # the C entry's path codes 0, 1
ALLOCATORS = ("vicinity", "random")   # `struct Dims`' allocator codes

launches = 0   # kernel launches made by cca_cycle_chunk, both paths
path_launches = dict.fromkeys(PATHS, 0)   # the same launches by kernel

# state leaves handed to the kernel, in the order of `struct Leaves`
KERNEL_LEAVES = (
    "vals", "nedges", "edst", "ew", "gaddr", "gstate", "rhz_on", "rstate",
    "nfree", "fq", "fq_n", "fq_head", "fwd_val", "fwd_pending",
    "aq", "aq_n", "aq_head", "ch", "ch_n", "ch_head", "ch_rr",
    "pk", "pk_n", "pk_head", "cmsg", "cvalid", "cphase", "cT", "cemit",
    "cout", "cdrain",
    "io_edges", "io_n", "io_pos", "arot",
    "cycle", "stat_hops", "stat_exec", "stat_stall", "stat_allocs",
    "tm_cell", "tm_lane", "tm_hiw", "flt")

# the per-cell leaves the cluster kernel holds in shared memory, a band of
# rows of each ([H, W, ...] leaves; `cluster_layout` in the .cuh).  The
# park ring (pk, pk_head) stays in device memory: only its own cell's
# thread touches it, and only after a lane was full.
CLUSTER_LEAVES = ("aq", "aq_n", "aq_head", "ch", "ch_n", "ch_head", "ch_rr",
                  "pk_n", "cmsg", "cvalid", "cphase", "cT", "cemit", "cout",
                  "cdrain", "arot", "nfree")
MAX_CTAS = 16             # the largest (non-portable) cluster on sm_90
SMEM_LIMIT = 232_448      # opt-in shared memory of one CTA on sm_90


def build() -> tuple[pathlib.Path, str]:
    """Compile the kernel library if these sources and flags have not
    been built yet.  Returns ``(library path, nvcc's -Xptxas -v
    report)``."""
    return _build.build(SOURCE, NVCC_FLAGS)


def load(path: pathlib.Path) -> ctypes.CDLL:
    """The kernel library at ``path`` with its C entry points typed."""
    lib = ctypes.CDLL(str(path))
    lib.cca_cycle_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    lib.cca_cycle_launch.restype = ctypes.c_int
    lib.cca_cycle_cluster_smem.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.cca_cycle_cluster_smem.restype = ctypes.c_int
    lib.cca_cycle_error_string.argtypes = [ctypes.c_int]
    lib.cca_cycle_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    return load(build()[0])


@functools.cache
def _layout(cfg: EngineConfig) -> dict:
    """``{leaf: (shape, dtype)}`` that ``cfg`` gives the state."""
    return {k: (tuple(v.shape), v.dtype) for k, v in
            init_state(cfg, device="meta")._asdict().items()}


def cluster_cell_bytes(cfg: EngineConfig) -> int:
    """Shared memory one cell takes in the cluster kernel: its row of each
    ``CLUSTER_LEAVES`` leaf, from the state's layout, and its scratch
    (``qwork``, and ``outbox`` and ``grant`` for each of the 4 hop
    directions)."""
    lay = _layout(cfg)
    leaves = sum(math.prod(lay[k][0][2:]) * lay[k][1].itemsize
                 for k in CLUSTER_LEAVES)
    return leaves + 4 * (1 + 4 * cfg.msg_words + 4)


def cluster_geometry(cfg: EngineConfig, n_ctas: int | None = None
                     ) -> tuple[int, int, int] | None:
    """``(n_ctas, rows a band, shared-memory bytes a CTA)`` of the cluster
    kernel for ``cfg``, or ``None`` where no band fits.

    A geometry is ``n`` CTAs of ``H / n`` rows each: ``n`` divides the
    height and is at most 16, and a CTA's bytes fit the 232,448 a CTA may
    opt into: its band's cells (``cluster_cell_bytes`` each), the IO
    cursors (``io_n``, ``io_pos``) and the cluster's words (a busy flag
    and 4 counters for each of up to 16 CTAs).  Given ``n_ctas``, that
    geometry or ``None``; else the largest ``n`` that fits: the most SMs,
    the least shared memory each.  (On the H100, 8 CTAs of 4 rows and 16
    of 2 ran the fingerprint config's chunk within 1% of each other, and
    on the pinned 8x8 config 1 CTA was the slowest: nothing measured
    favours fewer CTAs; PERF.md section 6.)
    """
    H = cfg.height
    cands = [n_ctas] if n_ctas is not None else range(MAX_CTAS, 0, -1)
    for n in cands:
        if 1 <= n <= MAX_CTAS and H % n == 0:
            nbytes = (H // n * cfg.width * cluster_cell_bytes(cfg)
                      + 2 * 4 * cfg.io_cells + 4 * 5 * MAX_CTAS)
            if nbytes <= SMEM_LIMIT:
                return n, H // n, nbytes
    return None


def _fault_dims(cfg: EngineConfig) -> list[int]:
    """`struct Dims`' fault fields: ``faults`` 0 or 1, the hash keys of
    salts 1-3 (drop, dup, corrupt), the three 16-bit thresholds and the
    blackout count."""
    plan = cfg.faults
    if plan is None:
        return [0] * 8
    return [1, *(fault_key(plan.seed, salt) for salt in (1, 2, 3)),
            plan.drop_thr, plan.dup_thr, plan.corrupt_thr,
            len(plan.blackouts)]


@functools.cache
def _blackout_table(blackouts: tuple, device: torch.device):
    """The plan's blackout windows as int32 ``[n, 5]`` rows (row, col,
    dir, start, n) on ``device``, made once a plan and device."""
    return torch.tensor(blackouts, dtype=torch.int32,
                        device=device).reshape(-1, 5)


def _dims(cfg: EngineConfig, app: DiffusionApp, n_offs: int,
          n_cycles: int, geometry: tuple[int, int, int] | None
          ) -> list[int]:
    """Scalar geometry, in the order of `struct Dims` (``telemetry`` 0 or
    1, the fault fields of ``_fault_dims``; ``n_ctas`` and the bytes a CTA
    0 for the one-block kernel)."""
    n_ctas, _, nbytes = geometry or (0, 0, 0)
    return [cfg.height, cfg.width, cfg.slots, cfg.edge_cap, cfg.queue_cap,
            cfg.futq_cap, cfg.lane_capacity, cfg.lanes, cfg.park_capacity,
            cfg.io_cells, cfg.io_stream_cap,
            cfg.root_slots, cfg.primary_slots, cfg.rhizome_cap,
            cfg.rhizome_stride, cfg.aq_reserve, cfg.sys_reserve, n_offs,
            app.code, ALLOCATORS.index(cfg.allocator), n_cycles,
            int(cfg.telemetry), *_fault_dims(cfg), n_ctas, nbytes]


def _launch_args(cfg: EngineConfig, app: DiffusionApp, st: MachineState,
                 n_cycles: int, geometry=None, trace=None):
    """The kernel's tensors, in the order of `struct Leaves` (the state
    leaves, the vicinity table, the blackout table or ``None``, the
    per-cell scratch, the record, the trace rows or ``None``), and its
    `struct Dims`."""
    dev = st.aq.device
    offs = torch.as_tensor(vicinity_offsets(cfg.vicinity_hops), device=dev)
    blackouts = (_blackout_table(cfg.faults.blackouts, dev)
                 if cfg.faults is not None and cfg.faults.blackouts
                 else None)

    def scratch(n):
        return torch.empty(n, dtype=torch.int32, device=dev)

    # the cluster kernel keeps its scratch in shared memory
    cells = 1 if geometry else cfg.n_cells
    tensors = [getattr(st, k) for k in KERNEL_LEAVES] + [
        offs, blackouts, scratch(cells * cfg.msg_words), scratch(cells),
        scratch(cells), scratch(8), trace]
    return tensors, _dims(cfg, app, len(offs), n_cycles, geometry)


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


def _check_trace(trace, n_cycles: int, dev: torch.device) -> None:
    if trace is None:
        return
    if trace.device != dev or trace.dtype != torch.int32 or \
            tuple(trace.shape) != (n_cycles, 2) or not trace.is_contiguous():
        raise ValueError(
            f"trace is {trace.dtype}{list(trace.shape)} on {trace.device} "
            f"(contiguous={trace.is_contiguous()}); the kernel needs a "
            f"contiguous torch.int32[{n_cycles}, 2] on {dev}")


def route(cfg: EngineConfig, path: str = "auto",
          n_ctas: int | None = None) -> tuple[int, int, int] | None:
    """The cluster geometry a launch takes, or ``None`` for the one-block
    kernel.  ``n_ctas`` forces the cluster's size (and the cluster path).
    Raises on an unknown ``path`` and where a forced cluster does not
    fit."""
    if path not in ("auto",) + PATHS:
        raise ValueError(f"path must be 'auto', 'cluster' or 'block', not "
                         f"{path!r}")
    if path == "block":
        if n_ctas is not None:
            raise ValueError("n_ctas sizes the cluster; path='block' has "
                             "none")
        return None
    geometry = cluster_geometry(cfg, n_ctas)
    if geometry is None and (path == "cluster" or n_ctas is not None):
        raise ValueError(
            f"no cluster band fits a {cfg.height}x{cfg.width} grid"
            + (f" in {n_ctas} CTAs" if n_ctas is not None else "")
            + f": a cell takes {cluster_cell_bytes(cfg)} bytes of shared "
            f"memory, a CTA at most {SMEM_LIMIT}, at most {MAX_CTAS} CTAs "
            f"dividing the height")
    return geometry


def cca_cycle_chunk(cfg: EngineConfig, app: DiffusionApp, st: MachineState,
                    n_cycles: int | None = None, path: str = "auto",
                    n_ctas: int | None = None,
                    trace: torch.Tensor | None = None):
    """Run up to ``n_cycles`` engine cycles, frozen at quiescence.

    Returns ``(state, counters)`` with ``counters`` int32 ``[quiescent at
    end, cycles run]`` on the state's device.  ``path`` and ``n_ctas``
    choose the kernel (``route``); they are checked on the CPU too, where
    the plain version runs.  ``trace``, a contiguous int32 ``[n_cycles,
    2]`` tensor on the state's device, gets the ``(active, in_flight)``
    row of each cycle run (rows ``0 .. cycles run - 1``).  Each kernel
    launch adds one to the module's ``launches`` and to its kernel's entry
    of ``path_launches``.
    """
    global launches
    cfg.validate()
    n_cycles = cfg.chunk if n_cycles is None else int(n_cycles)
    if n_cycles < 0:
        raise ValueError(f"n_cycles must be >= 0, got {n_cycles}")
    geometry = route(cfg, path, n_ctas)
    dev = _check(cfg, st)
    _check_trace(trace, n_cycles, dev)
    if dev.type == "cpu":
        return cca_cycle_chunk_ref(cfg, app, st, n_cycles, trace)
    if dev.type != "cuda":
        raise ValueError(f"cca_cycle_chunk runs on cuda or cpu, not {dev}")
    lib = _library()
    tensors, dims = _launch_args(cfg, app, st, n_cycles, geometry, trace)
    rec = tensors[-2]
    ptrs = (ctypes.c_void_p * len(tensors))(
        *[0 if t is None else t.data_ptr() for t in tensors])
    dims_c = (ctypes.c_int * len(dims))(*dims)
    kernel = ctypes.c_int(-1)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.cca_cycle_launch(ptrs, len(tensors), dims_c, len(dims),
                                   stream, ctypes.byref(kernel))
    if err:
        raise RuntimeError("cca_cycle kernel launch failed: "
                           + lib.cca_cycle_error_string(err).decode())
    launches += 1
    path_launches[PATHS[kernel.value]] += 1
    return st, rec[5:7]
