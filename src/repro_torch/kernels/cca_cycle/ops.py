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
int32 table on the state's device.  With ``cfg.qbatch`` Q > 1 (a
composite app of ``repro_torch.mq.batch_app``) it takes their
query-batched instances: records of ``cfg.msg_words`` words, Q values a
slot, and the per-query counters ``qchg`` / ``qlast``; the slot apps
reach the kernel as a table of Q app codes in `struct Dims`, so a new
mix of tenants is a new table for the next launch.

``TileStep`` and ``cca_tile_step`` run one cycle of a tile of a grid
sharded over ranks (``repro_torch.dist.cca``): the kernels' tile
instances, one for each of the knob mixes above (``instance``), each
counting, testing and tracing its owned cells only.

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
``ctypes`` (``kernels/_build.py``): one library of the whole grid's
instances (``build``) and one of the tile instances (``build_tiles``).
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
from repro_torch.kernels.cca_cycle.ref import (cca_cycle_chunk_ref,
                                               tile_step_ref)
from repro_torch.resilience.faults import fault_key

HERE = pathlib.Path(__file__).resolve().parent
SOURCE = HERE / "csrc" / "cca_cycle.cu"
NVCC_FLAGS = _build.SM90A_FLAGS + ("--fmad=false",)   # bit-exact f32 sums
# the second library, of the tile instances (built beside the first)
TILE_FLAGS = NVCC_FLAGS + ("-DCCA_TILES=1",)

PATHS = ("block", "cluster")   # the C entry's path codes 0, 1
ALLOCATORS = ("vicinity", "random")   # `struct Dims`' allocator codes

launches = 0   # kernel launches made by cca_cycle_chunk and tile steps
path_launches = dict.fromkeys(PATHS, 0)   # the same launches by kernel
query_launches = dict.fromkeys(PATHS, 0)  # those of them at qbatch > 1
# those of them tile steps, by kernel and instance ("cluster tl+tm", ...;
# `instance`); `tile_launches_by_path` sums them by kernel
tile_launches = {}

def tile_launches_by_path() -> dict:
    """``tile_launches`` summed by kernel: ``{"block": n, "cluster": n}``."""
    out = dict.fromkeys(PATHS, 0)
    for key, n in tile_launches.items():
        out[key.split()[0]] += n
    return out


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
    """Compile the kernel library (the instances of the whole grid) if
    these sources and flags have not been built yet.  Returns ``(library
    path, nvcc's -Xptxas -v report)``."""
    return _build.build(SOURCE, NVCC_FLAGS)


def build_tiles() -> tuple[pathlib.Path, str]:
    """``build`` of the second library, the same source's tile instances
    (``-DCCA_TILES=1``): two nvcc runs side by side take half the time one
    takes over all 24 instances."""
    return _build.build(SOURCE, TILE_FLAGS)


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
def _library(tiles: bool = False) -> ctypes.CDLL:
    """The library of the whole grid's instances, or of the tiles'."""
    return load((build_tiles if tiles else build)()[0])


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


def cluster_geometry(cfg: EngineConfig, n_ctas: int | None = None,
                     shape: tuple[int, int] | None = None
                     ) -> tuple[int, int, int] | None:
    """``(n_ctas, rows a band, shared-memory bytes a CTA)`` of the cluster
    kernel for ``cfg``, or ``None`` where no band fits.

    A geometry is ``n`` CTAs of ``H / n`` rows each: ``n`` divides the
    height and is at most 16, and a CTA's bytes fit the 232,448 a CTA may
    opt into: its band's cells (``cluster_cell_bytes`` each), the IO
    cursors (``io_n``, ``io_pos``), the cluster's words (a busy flag and 4
    counters for each of up to 16 CTAs) and, at ``qbatch`` Q > 1, the
    per-query sums and the current cycle (2 x Q + 1 words).  Given ``n_ctas``, that
    geometry or ``None``; else the largest ``n`` that fits: the most SMs,
    the least shared memory each.  (On the H100, 8 CTAs of 4 rows and 16
    of 2 ran the fingerprint config's chunk within 1% of each other, and
    on the pinned 8x8 config 1 CTA was the slowest: nothing measured
    favours fewer CTAs; PERF.md section 6.)  ``shape`` ``(h, w)``: the
    geometry of a tile's arrays of that shape instead of the grid's (the
    IO cursors' words stay the grid's, as the kernel lays them out).
    """
    H, W = shape or (cfg.height, cfg.width)
    cands = [n_ctas] if n_ctas is not None else range(MAX_CTAS, 0, -1)
    for n in cands:
        if 1 <= n <= MAX_CTAS and H % n == 0:
            nbytes = (H // n * W * cluster_cell_bytes(cfg)
                      + 2 * 4 * cfg.io_cells + 4 * 5 * MAX_CTAS
                      + (4 * (2 * cfg.qbatch + 1) if cfg.qbatch > 1
                         else 0))
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


def _query_dims(cfg: EngineConfig, app: DiffusionApp) -> list[int]:
    """`struct Dims`' query fields: Q, the record's words and the slot
    apps' codes, 4 bits a slot, 8 slots an int (zeros at Q = 1)."""
    packed = [0] * 4
    if cfg.qbatch > 1:
        if len(app.slot_apps) != cfg.qbatch:
            raise ValueError(f"app {app.name!r} has {len(app.slot_apps)} "
                             f"slot apps, the config qbatch={cfg.qbatch}")
        for q, a in enumerate(app.slot_apps):
            packed[q // 8] |= a.code << (4 * (q % 8))
        # the int32 view of each packed word
        packed = [w - (1 << 32) if w >= 1 << 31 else w for w in packed]
    return [cfg.qbatch, cfg.msg_words, *packed]


def _tile_dims(cfg: EngineConfig, tile) -> list[int]:
    """`struct TDims`: ``tile`` 0 or 1, the grid's height and width, the
    tile's origin and owned window (zeros without a tile)."""
    if tile is None:
        return [0] * 9
    return [1, cfg.height, cfg.width, *tile]


def _dims(cfg: EngineConfig, app: DiffusionApp, n_offs: int,
          n_cycles: int, geometry: tuple[int, int, int] | None,
          tile=None, shape=None, io_len=None) -> list[int]:
    """Scalar geometry, in the order of `struct Dims` (``telemetry`` 0 or
    1, the fault fields of ``_fault_dims``; ``n_ctas`` and the bytes a CTA
    0 for the one-block kernel), then the query fields of ``_query_dims``
    and the tile fields of ``_tile_dims``.  A tile's ``Dims`` are its
    arrays' ``shape`` and the length ``io_len`` of its IO streams."""
    n_ctas, _, nbytes = geometry or (0, 0, 0)
    H, W = shape or (cfg.height, cfg.width)
    return [H, W, cfg.slots, cfg.edge_cap, cfg.queue_cap,
            cfg.futq_cap, cfg.lane_capacity, cfg.lanes, cfg.park_capacity,
            cfg.io_cells, io_len or cfg.io_stream_cap,
            cfg.root_slots, cfg.primary_slots, cfg.rhizome_cap,
            cfg.rhizome_stride, cfg.aq_reserve, cfg.sys_reserve, n_offs,
            app.code, ALLOCATORS.index(cfg.allocator), n_cycles,
            int(cfg.telemetry), *_fault_dims(cfg), n_ctas, nbytes,
            *_query_dims(cfg, app), *_tile_dims(cfg, tile)]


def _launch_args(cfg: EngineConfig, app: DiffusionApp, st: MachineState,
                 n_cycles: int, geometry=None, trace=None, tile=None,
                 gquiet=None, rec=None):
    """The kernel's tensors, in the order of `struct Leaves` (the state
    leaves, the vicinity table, the blackout table or ``None``, the
    per-cell scratch, the record (``rec``, else a new one), the trace rows
    or ``None``, the per-query counters ``qchg`` and ``qlast``, the grid's
    quiescence flag ``gquiet`` or ``None``), and its `struct Dims`."""
    dev = st.aq.device
    offs = torch.as_tensor(vicinity_offsets(cfg.vicinity_hops), device=dev)
    blackouts = (_blackout_table(cfg.faults.blackouts, dev)
                 if cfg.faults is not None and cfg.faults.blackouts
                 else None)

    def scratch(n):
        return torch.empty(n, dtype=torch.int32, device=dev)

    # the cluster kernel keeps its scratch in shared memory
    shape = tuple(st.aq_n.shape)
    cells = 1 if geometry else shape[0] * shape[1]
    tensors = [getattr(st, k) for k in KERNEL_LEAVES] + [
        offs, blackouts, scratch(cells * cfg.msg_words), scratch(cells),
        scratch(cells), scratch(8) if rec is None else rec, trace, st.qchg,
        st.qlast, gquiet]
    return tensors, _dims(cfg, app, len(offs), n_cycles, geometry, tile,
                          shape, st.io_edges.shape[1])


def _check(cfg: EngineConfig, st: MachineState,
           tile_shape: tuple[int, int] | None = None) -> torch.device:
    """The state's device, after checking every leaf against ``cfg``'s
    layout (a tile's: its per-cell leaves ``tile_shape`` cells,
    its IO streams of any length)."""
    dev = st.aq.device
    for name, (want, dtype) in _layout(cfg).items():
        t = getattr(st, name)
        shape = want if tile_shape is None else _tile_leaf_shape(
            cfg, name, want, tile_shape, t)
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(
                f"state leaf {name!r} is {t.dtype}{list(t.shape)} on "
                f"{t.device} (contiguous={t.is_contiguous()}); the kernel "
                f"needs a contiguous {dtype}{list(shape)} on {dev}")
    return dev


def _tile_leaf_shape(cfg: EngineConfig, name: str, want: tuple,
                     tile_shape: tuple[int, int], t) -> tuple:
    """The shape a tile's leaf ``name`` must have (``want``: the grid's)."""
    if name == "io_edges":
        return (want[0], t.shape[1] if t.dim() == 3 else -1, 3)
    if name in cell_leaves(cfg):
        return tuple(tile_shape) + want[2:]
    return want


# the leaves laid out [H, W, ...] a cell, but the telemetry planes
PER_CELL_LEAVES = tuple(k for k in KERNEL_LEAVES if k not in (
    "io_edges", "io_n", "io_pos", "cycle", "stat_hops", "stat_exec",
    "stat_stall", "stat_allocs", "tm_cell", "tm_lane", "tm_hiw", "flt"))
TM_PLANES = ("tm_cell", "tm_lane", "tm_hiw")


def cell_leaves(cfg: EngineConfig) -> tuple:
    """The leaves ``cfg`` lays out ``[H, W, ...]`` a cell: the telemetry
    planes too where telemetry is on (else they are 1x1 dummies)."""
    return PER_CELL_LEAVES + (TM_PLANES if cfg.telemetry else ())


def instance(cfg: EngineConfig) -> str:
    """The name of the tile instance a launch under ``cfg`` takes: ``tl``
    and its knobs, ``+tm`` (telemetry), ``+flt`` (faults), ``+q`` (query
    batching)."""
    return "tl" + "".join(k for k, on in (
        ("+q", cfg.qbatch > 1), ("+tm", cfg.telemetry),
        ("+flt", cfg.faults is not None)) if on)


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
    of ``path_launches`` (and of ``query_launches`` at ``qbatch > 1``).
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
    rec = tensors[-5]
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
    if cfg.qbatch > 1:
        query_launches[PATHS[kernel.value]] += 1
    return st, rec[5:7]


# ---- tile mode (repro_torch.dist.cca) ----

def tile_route(cfg: EngineConfig, shape: tuple[int, int], path: str = "auto",
               n_ctas: int | None = None):
    """``route`` for a tile whose arrays are ``shape`` cells."""
    if path not in ("auto",) + PATHS:
        raise ValueError(f"path must be 'auto', 'cluster' or 'block', not "
                         f"{path!r}")
    if path == "block":
        return None
    geometry = cluster_geometry(cfg, n_ctas, shape)
    if geometry is None and (path == "cluster" or n_ctas is not None):
        raise ValueError(f"no cluster band fits a {shape[0]}x{shape[1]} "
                         "tile")
    return geometry


def _check_tile_call(cfg: EngineConfig, st: MachineState, gquiet, rec,
                     trace):
    dev = _check(cfg, st, tuple(st.aq_n.shape))
    for name, t, shape in (("gquiet", gquiet, ()), ("rec", rec, (8,))):
        if t.device != dev or t.dtype != torch.int32 or \
                tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name} is {t.dtype}{list(t.shape)} on "
                             f"{t.device}; the tile step needs a contiguous "
                             f"torch.int32{list(shape)} on {dev}")
    _check_trace(trace, 1, dev)
    return dev


class TileStep:
    """One tile's cycle on the card, its launch arguments prepared once:
    each call launches the cycle kernel's tile instance for ``cfg``'s
    knobs (``instance``: telemetry, faults, query batching) on the
    state's leaves, in place, and adds one to the launch counts
    (``launches``, ``path_launches`` and ``tile_launches``).  A launch
    runs one cycle of the tile unless ``gquiet`` (int32 ``[]``, the grid's
    quiescence, which the ranks reduce after every cycle) is set, and
    writes the launch record
    into ``rec`` (int32 ``[8]``: the tile's cycle and counters, the
    quiescence of its owned cells after the cycle, the cycles run).
    Given ``trace`` (int32 ``[1, 2]``, the tile's own row), it writes the
    cycle's ``(active, in_flight)`` counts of its owned cells there, for
    the caller to sum over the tiles.  The tensors must not be reallocated
    between calls."""

    def __init__(self, cfg: EngineConfig, app: DiffusionApp,
                 st: MachineState, tile, gquiet: torch.Tensor,
                 rec: torch.Tensor, path: str = "auto",
                 n_ctas: int | None = None,
                 trace: torch.Tensor | None = None):
        cfg.validate()
        dev = _check_tile_call(cfg, st, gquiet, rec, trace)
        if dev.type != "cuda":
            raise ValueError(f"TileStep launches on cuda, not {dev}")
        shape = tuple(st.aq_n.shape)
        geometry = tile_route(cfg, shape, path, n_ctas)
        self.lib = _library(tiles=True)
        tensors, dims = _launch_args(cfg, app, st, 1, geometry, trace,
                                     tuple(tile), gquiet, rec)
        self.instance = instance(cfg)
        self._keep = tensors          # the scratch must outlive the calls
        self.ptrs = (ctypes.c_void_p * len(tensors))(
            *[0 if t is None else t.data_ptr() for t in tensors])
        self.n_ptrs = len(tensors)
        self.dims = (ctypes.c_int * len(dims))(*dims)
        self.n_dims = len(dims)
        self.dev = dev
        self.path = PATHS[geometry is not None]

    def __call__(self) -> None:
        global launches
        kernel = ctypes.c_int(-1)
        with torch.cuda.device(self.dev):
            stream = torch.cuda.current_stream(self.dev).cuda_stream
            err = self.lib.cca_cycle_launch(self.ptrs, self.n_ptrs,
                                            self.dims, self.n_dims, stream,
                                            ctypes.byref(kernel))
        if err:
            raise RuntimeError("cca_cycle tile launch failed: "
                               + self.lib.cca_cycle_error_string(err)
                               .decode())
        launches += 1
        path = PATHS[kernel.value]
        path_launches[path] += 1
        key = f"{path} {self.instance}"
        tile_launches[key] = tile_launches.get(key, 0) + 1


def cca_tile_step(cfg: EngineConfig, app: DiffusionApp, st: MachineState,
                  tile, gquiet: torch.Tensor, rec: torch.Tensor,
                  path: str = "auto", n_ctas: int | None = None,
                  trace: torch.Tensor | None = None):
    """One cycle of a tile (``core.state.Tile``) unless the grid is
    quiescent (``gquiet``), its record into ``rec`` and, given ``trace``,
    its row; see :class:`TileStep`.  On the card one launch of the tile
    instance, which updates the state in place; on the CPU the plain
    version (``ref.tile_step_ref``), which returns a new state.  Returns
    the state."""
    if st.aq.device.type == "cuda":
        TileStep(cfg, app, st, tile, gquiet, rec, path, n_ctas, trace)()
        return st
    dev = _check_tile_call(cfg, st, gquiet, rec, trace)
    if dev.type != "cpu":
        raise ValueError(f"cca_tile_step runs on cuda or cpu, not {dev}")
    tile_route(cfg, tuple(st.aq_n.shape), path, n_ctas)
    return tile_step_ref(cfg, app, st, tile, gquiet, rec, trace)
