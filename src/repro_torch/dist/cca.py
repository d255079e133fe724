"""The sharded engine: the cell grid tiled over the ranks of a mesh, one
cycle a tile step, a halo exchange after every cycle (DESIGN §5; the
port of what GSPMD does to ``repro/core/engine.py::run_chunk_body`` under
``dist.sharding.cca_state_shardings``).

Layout.  ``cca_state_shardings``' rule: cell ROWS over the data-parallel
group, cell COLUMNS over ``model``; rank ``r`` owns row block ``r //
model`` and column block ``r % model`` of the ``[H, W]`` grid.  Each
rank's tile holds its owned cells and a halo two cells deep along every
tiled axis (corners included on a 2-D tiling): the hop stage's four
direction rounds each read the receivers' queue counts as the earlier
rounds of the same cycle left them, so a boundary cell's next state
depends on cells up to two away.  A halo at the grid's edge is phantom
cells, empty and never reached.  Everything else in a cycle (staging,
phase 0, the allocator, the IO cells) is cell-local.  Routing, addresses,
the allocator and the IO cells work in global coordinates
(``core.state.Tile``).

Exchange.  After every cycle each tile's halo gets the hop stage's leaves
of the cells it mirrors (``HOP_LEAVES``: the channels, their counts,
heads and arbiter pointers, and the action-queue counts: all the hop
stage reads of another cell), packed into one int32 buffer a process and
moved by the mesh's transport (``dist.transport``) in one gather, one
move and one scatter.  The other leaves of a halo cell go stale, and
nothing reads them: the owned cells are exact.

Global scalars.  ``cycle`` is replicated.  The counters (``stat_*``) and
the fault and query counters (``flt``, ``qchg``) are each tile's sums over
its owned cells, rank 0's starting from the state's; :func:`gather_state`
and :func:`counters` add them up.  ``qlast`` is a maximum.  Quiescence is
global: each tile reports its owned cells' test after the cycle, the
ranks reduce it into ``gquiet`` on the device, and the next tile step
freezes on that flag (a tile quiescent alone does not), with no host read
a cycle.

Knobs.  Every knob of the unsharded machine runs on the tiles: the
telemetry planes are per-cell leaves, tiled like the others (their halo
cells count what nobody reads); a fault plan's decisions are a pure
function of the global link and the cycle, so a halo sender decides as
its owner does; the query counters are sums and a maximum as above.  A
traced chunk gives each tile a row of its owned cells' ``(active,
in_flight)`` a cycle, summed over the tiles and the ranks on the device
(:func:`run_chunk`), and :func:`snapshot` takes the telemetry frame of the
whole grid from the owned cells.

The ``[IO]`` leaves depart from the rule (which would row-shard them over
the data group, ``(dp, ...)``): ``io_edges`` is read-only within a chunk
and large (768 MiB at the paper config), so each process keeps one whole
copy (the tiles of ``LocalTiles`` share it), never exchanged; each IO cell
advances its cursor ``io_pos[i]`` in the tile that owns grid cell ``(0,
i)``, and only there is that entry current.
"""
from __future__ import annotations

import math
import types
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.apps import DiffusionApp
from repro_torch.core.config import EngineConfig
from repro_torch.core.engine import LIVELOCK_CHUNKS, increment_reset_leaves
from repro_torch.core.engine import quiescent as tile_quiescent
from repro_torch.core.ingest import _io_cells
from repro_torch.core.ingest import load_stream as _load_stream
from repro_torch.core.state import MachineState, Tile, init_state
from repro_torch.dist.ctx import dp_axes_active, model_size
from repro_torch.kernels.cca_cycle import ops
from repro_torch.obs import frames as obs_frames

HALO = 2   # the hop stage's reach in one cycle, in cells
# what the hop stage reads of another cell
HOP_LEAVES = ("ch", "ch_n", "ch_head", "ch_rr", "aq_n")
IO_LEAVES = ("io_edges", "io_n", "io_pos")
SUM_LEAVES = ("stat_hops", "stat_exec", "stat_stall", "stat_allocs", "flt",
              "qchg")
COUNTERS = ("cycle", "stat_hops", "stat_exec", "stat_stall", "stat_allocs")


class Grid(NamedTuple):
    """The tiling of an ``H x W`` grid over ``rows x cols`` ranks: tiles of
    ``h x w`` owned cells, arrays of ``hp x wp`` with the halo."""
    H: int
    W: int
    rows: int
    cols: int

    @classmethod
    def of(cls, cfg: EngineConfig, mesh) -> "Grid":
        extra = set(mesh.axis_names) - {"pod", "data", "model"}
        if extra or ("model" in mesh.axis_names
                     and mesh.axis_names[-1] != "model"):
            raise ValueError(f"the sharded engine tiles over (pod, data, "
                             f"model) meshes, not {mesh.axis_names}")
        rows = math.prod(mesh.shape[a] for a in dp_axes_active(mesh)
                         if a in mesh.axis_names)
        cols = model_size(mesh)
        if cfg.height % rows or cfg.width % cols:
            raise ValueError(f"a {cfg.height}x{cfg.width} grid does not "
                             f"tile over {rows}x{cols} ranks")
        return cls(cfg.height, cfg.width, rows, cols)

    @property
    def h(self):
        return self.H // self.rows

    @property
    def w(self):
        return self.W // self.cols

    @property
    def pad(self):
        return (HALO if self.rows > 1 else 0, HALO if self.cols > 1 else 0)

    @property
    def shape(self):
        ph, pw = self.pad
        return self.h + 2 * ph, self.w + 2 * pw

    def tile(self, rank: int) -> Tile:
        ph, pw = self.pad
        rb, cb = divmod(rank, self.cols)
        return Tile(rb * self.h - ph, cb * self.w - pw, ph, ph + self.h,
                    pw, pw + self.w)

    def owner(self, gi: int, gj: int) -> int:
        return (gi // self.h) * self.cols + gj // self.w


class HaloPlan(NamedTuple):
    """One process's halo exchange over its packed hop buffer: ``send`` the
    buffer positions to pack (one gather), ``recv`` where the moved words
    go (one scatter), ``peers`` ``(rank, send slice, recv slice)`` for a
    transport that sends between processes, ``n_recv`` the words it
    receives."""
    send: torch.Tensor
    recv: torch.Tensor
    peers: tuple
    n_recv: int

    def exchange(self, transport, buf: torch.Tensor) -> None:
        if not self.n_recv and not self.peers:
            return
        packed = buf.index_select(0, self.send)
        buf.index_copy_(0, self.recv, transport.move(packed, self))


def _hop_sizes(cfg: EngineConfig, like: MachineState) -> list:
    """Words a cell of each ``HOP_LEAVES`` leaf."""
    return [math.prod(getattr(like, k).shape[2:]) for k in HOP_LEAVES]


def _halo_pairs(grid: Grid, rank: int) -> dict:
    """``{source rank: [(dst cell, src cell), ...]}``: the halo cells of
    ``rank``'s tile on the grid, each with the owner's array cell that
    holds it, in the tile's cell order."""
    hp, wp = grid.shape
    t = grid.tile(rank)
    out = {}
    for i in range(hp):
        for j in range(wp):
            if t.or0 <= i < t.or1 and t.oc0 <= j < t.oc1:
                continue
            gi, gj = t.r0 + i, t.c0 + j
            if not (0 <= gi < grid.H and 0 <= gj < grid.W):
                continue                     # a phantom cell
            s = grid.owner(gi, gj)
            ts = grid.tile(s)
            out.setdefault(s, []).append(
                (i * wp + j, (gi - ts.r0) * wp + (gj - ts.c0)))
    return out


def _words(cells, slot: int, tile_words: int, sizes: list, n_cells: int):
    """Buffer positions of every hop word of ``cells`` in local tile
    ``slot``, leaf by leaf, cell by cell."""
    cells = np.asarray(cells, np.int64)
    out, off = [], slot * tile_words
    for n in sizes:
        out.append((off + cells[:, None] * n + np.arange(n)[None, :])
                   .reshape(-1))
        off += n_cells * n
    return np.concatenate(out) if out else np.zeros(0, np.int64)


def halo_plan(grid: Grid, ranks: tuple, sizes: list, device) -> HaloPlan:
    """The exchange of a process holding ``ranks``: every rank of the grid
    (``LocalTiles``: each pair of tiles packs its words already where they
    go) or one (a process group: a slice of the packed words for each peer
    that needs this tile's cells, a slice of what arrives from each peer
    that owns its halo, both in the receiving tile's cell order, which
    both sides compute)."""
    hp, wp = grid.shape
    n_cells = hp * wp
    tile_words = n_cells * sum(sizes)
    world = grid.rows * grid.cols
    pairs = {r: _halo_pairs(grid, r) for r in range(world)}

    def words(cells, slot):
        return _words(cells, slot, tile_words, sizes, n_cells)

    send, recv, peers = [], [], []
    if len(ranks) == world:
        for rt in ranks:
            for rs, pp in pairs[rt].items():
                d, s = zip(*pp)
                send.append(words(s, rs))
                recv.append(words(d, rt))
    elif len(ranks) == 1:
        (me,) = ranks
        ns = nr = 0
        for peer in range(world):
            if peer == me:
                continue
            s_idx = (words([s for _, s in pairs[peer][me]], 0)
                     if me in pairs[peer] else np.zeros(0, np.int64))
            r_idx = (words([d for d, _ in pairs[me][peer]], 0)
                     if peer in pairs[me] else np.zeros(0, np.int64))
            if not len(s_idx) and not len(r_idx):
                continue
            peers.append((peer, (ns, ns + len(s_idx)),
                          (nr, nr + len(r_idx))))
            send.append(s_idx)
            recv.append(r_idx)
            ns, nr = ns + len(s_idx), nr + len(r_idx)
    else:
        raise ValueError("a process holds every rank of the mesh or one")

    def cat(a):
        return torch.from_numpy(np.concatenate(a) if a else
                                np.zeros(0, np.int64)).to(device)

    send_t, recv_t = cat(send), cat(recv)
    return HaloPlan(send_t, recv_t, tuple(peers), int(recv_t.numel()))


class ShardedState:
    """This process's tiles of a sharded machine state.

    ``tiles[k]`` is the ``MachineState`` of rank ``ranks[k]``, its
    per-cell leaves ``[hp, wp, ...]`` (``grid.shape``) at ``geoms[k]``;
    the ``HOP_LEAVES`` of all of them are views into one int32 buffer
    ``hop``, exchanged by ``plan``.  ``recs[k]`` is tile ``k``'s last
    launch record, ``trows[k]`` its trace row of a traced cycle, and
    ``gquiet`` (int32 ``[]``) the grid's quiescence, reduced over the
    ranks after every cycle.  Tensors are updated in place: a tile step's
    launch arguments stay valid."""

    def __init__(self, cfg, mesh, grid, ranks, tiles, hop, plan, device):
        self.cfg, self.mesh, self.grid = cfg, mesh, grid
        self.transport = mesh.transport
        self.ranks = tuple(ranks)
        self.geoms = [grid.tile(r) for r in self.ranks]
        self.tiles = tiles
        self.hop, self.plan, self.device = hop, plan, device
        self.recs = torch.zeros((len(ranks), 8), dtype=torch.int32,
                                device=device)
        self.trows = torch.zeros((len(ranks), 1, 2), dtype=torch.int32,
                                 device=device)
        self.gquiet = torch.zeros((), dtype=torch.int32, device=device)
        self._steps = {}

    def exchange(self) -> None:
        """Refresh every tile's halo from the tiles that own it."""
        self.plan.exchange(self.transport, self.hop)

    def reduce_quiet(self) -> None:
        """``gquiet`` from the tiles' records (their owned cells' test)."""
        self.transport.all_min(self.recs[:, 5], self.gquiet)

    def refresh_quiet(self) -> torch.Tensor:
        """Recompute ``gquiet`` from the tiles' state (after a load)."""
        for k, (st, g) in enumerate(zip(self.tiles, self.geoms)):
            self.recs[k, 5] = tile_quiescent(st, g).to(torch.int32)
        self.reduce_quiet()
        return self.gquiet

    def bind(self, k: int, new: MachineState) -> None:
        """Tile ``k`` takes ``new``'s leaves (a plain step's state is new
        tensors): the hop buffer's views and the IO cursors, which other
        tiles share, by copy."""
        old = self.tiles[k]
        for name in HOP_LEAVES + ("io_n", "io_pos"):
            t, v = getattr(old, name), getattr(new, name)
            if v is not t:
                t.copy_(v)
        self.tiles[k] = new._replace(**{n: getattr(old, n) for n in
                                        HOP_LEAVES + IO_LEAVES})

    def steps(self, cfg, app, path, n_ctas, traced: bool) -> list:
        """The tiles' ``ops.TileStep`` launchers (on the card), made once
        a config, app, route and trace."""
        key = (cfg, app.code, app.name, path, n_ctas, traced)
        if key not in self._steps:
            self._steps[key] = [
                ops.TileStep(cfg, app, st, g, self.gquiet, self.recs[k],
                             path, n_ctas, self.trows[k] if traced else None)
                for k, (st, g) in enumerate(zip(self.tiles, self.geoms))]
        return self._steps[key]


def shard_state(cfg: EngineConfig, st: MachineState, mesh) -> ShardedState:
    """This process's tiles of the global state ``st`` on ``mesh`` (its
    transport's device), laid out by :func:`cca_state_shardings`' rule
    with halos, the ``[IO]`` leaves whole (see the module's docstring),
    rank 0's counters the state's and the others' zero.  Raises
    ``ValueError`` for a state whose leaves are not ``cfg``'s."""
    cfg.validate()
    ops._check(cfg, st)
    if mesh.transport is None:
        raise ValueError("shard_state needs a mesh with a transport")
    grid = Grid.of(cfg, mesh)     # the rule's divisibility, or ValueError
    dev = mesh.transport.device
    ranks = mesh.local_ranks
    hp, wp = grid.shape
    like = init_state(cfg, device="meta")
    sizes = _hop_sizes(cfg, like)
    tile_words = hp * wp * sum(sizes)
    hop = torch.zeros(len(ranks) * tile_words, dtype=torch.int32, device=dev)
    io = {k: getattr(st, k).to(dev).clone() for k in IO_LEAVES}
    tiles = []
    for slot, r in enumerate(ranks):
        t = grid.tile(r)
        leaves = {}
        off = slot * tile_words
        views = {}
        for k, n in zip(HOP_LEAVES, sizes):
            rest = tuple(getattr(like, k).shape[2:])
            views[k] = hop[off:off + hp * wp * n].view(hp, wp, *rest)
            off += hp * wp * n
        gi0, gi1 = max(t.r0, 0), min(t.r0 + hp, grid.H)
        gj0, gj1 = max(t.c0, 0), min(t.c0 + wp, grid.W)
        for name in ops.cell_leaves(cfg):
            src = getattr(st, name)
            out = views.get(name)
            if out is None:
                out = torch.zeros((hp, wp) + tuple(src.shape[2:]),
                                  dtype=src.dtype, device=dev)
            out[gi0 - t.r0:gi1 - t.r0, gj0 - t.c0:gj1 - t.c0] = \
                src[gi0:gi1, gj0:gj1].to(dev)
            leaves[name] = out
        # one copy of the IO leaves a process (shared by local tiles)
        leaves.update(io)
        for name in MachineState._fields:
            if name in leaves:
                continue
            v = getattr(st, name).to(dev).clone()
            if name in SUM_LEAVES and r != 0:
                v.zero_()
            leaves[name] = v
        tiles.append(MachineState(**leaves))
    plan = halo_plan(grid, ranks, sizes, dev)
    sst = ShardedState(cfg, mesh, grid, ranks, tiles, hop, plan, dev)
    sst.refresh_quiet()
    return sst


def _io_pos(sst: ShardedState) -> torch.Tensor:
    """The IO cursors, each from the tile that owns its IO cell."""
    pos = sst.tiles[0].io_pos
    if len(sst.ranks) == sst.grid.rows * sst.grid.cols:
        return pos.clone()        # local tiles share the cursors
    mine = torch.zeros_like(pos)
    for st, g in zip(sst.tiles, sst.geoms):
        cells = _io_cells(pos.shape[0], g, pos.device)
        if cells is not None:
            mine[cells[0]] = st.io_pos[cells[0]]
    return sst.transport.all_sum(mine[None])


def owned_cells(st: MachineState, g: Tile, name: str) -> torch.Tensor:
    """The owned cells of a tile's per-cell leaf ``name``."""
    return getattr(st, name)[g.or0:g.or1, g.oc0:g.oc1]


def gather_leaf(sst: ShardedState, name: str) -> torch.Tensor:
    """The whole grid's per-cell leaf ``name``, on every process, from
    every rank's owned cells."""
    grid = sst.grid
    blocks = []
    for st, g in zip(sst.tiles, sst.geoms):
        b = owned_cells(st, g, name)
        blocks.append(b.to(torch.uint8) if b.dtype == torch.bool
                      else b.contiguous())
    blocks = sst.transport.all_gather(blocks)
    rows = [torch.cat(blocks[r * grid.cols:(r + 1) * grid.cols], dim=1)
            for r in range(grid.rows)]
    full = torch.cat(rows, dim=0)
    return full.bool() if getattr(sst.tiles[0], name).dtype == torch.bool \
        else full


def reduce_tiles(sst: ShardedState, fn, op: str = "sum") -> torch.Tensor:
    """``fn(tile state, its Tile)`` of every tile, summed (``op="sum"``)
    or the maximum (``"max"``) over every rank, on the device."""
    vals = torch.stack([fn(st, g) for st, g in zip(sst.tiles, sst.geoms)])
    return (sst.transport.all_sum if op == "sum"
            else sst.transport.all_max)(vals)


def gather_state(sst: ShardedState) -> MachineState:
    """The global state, on every process, from every rank's owned cells
    (the counters summed, ``qlast`` the maximum)."""
    leaves = {name: gather_leaf(sst, name)
              for name in ops.cell_leaves(sst.cfg)}
    t0 = sst.tiles[0]
    leaves.update(io_edges=t0.io_edges.clone(), io_n=t0.io_n.clone(),
                  io_pos=_io_pos(sst))
    for name in MachineState._fields:
        if name in leaves:
            continue
        if name in SUM_LEAVES:
            leaves[name] = reduce_tiles(sst, lambda st, g: getattr(st, name))
        elif name == "qlast":
            leaves[name] = reduce_tiles(sst, lambda st, g: st.qlast, "max")
        else:
            leaves[name] = getattr(t0, name).clone()
    return MachineState(**leaves)


def write_cells(sst: ShardedState, name: str, rows, cols, index: tuple,
                value) -> None:
    """``leaf[rows, cols, *index] = value`` of the global per-cell leaf
    ``name`` (``rows``, ``cols``: global cell coordinates, numpy), written
    in the tiles that own those cells."""
    rows, cols = np.asarray(rows).reshape(-1), np.asarray(cols).reshape(-1)
    index = [np.broadcast_to(np.asarray(i), rows.shape) for i in index]
    for st, g in zip(sst.tiles, sst.geoms):
        r, c = rows - g.r0, cols - g.c0
        mine = (r >= g.or0) & (r < g.or1) & (c >= g.oc0) & (c < g.oc1)
        if mine.any():
            at = tuple(torch.as_tensor(a[mine], device=sst.device)
                       for a in (r, c, *index))
            getattr(st, name)[at] = value


def quiescent(sst: ShardedState) -> torch.Tensor:
    """0-d bool on the device: no work left on any rank (recomputed from
    the tiles, every process's test reduced over the mesh)."""
    return sst.refresh_quiet().bool()


def counters(sst: ShardedState) -> torch.Tensor:
    """int32 ``[cycle, hops, execs, stalls, allocs]`` of the whole grid on
    the device."""
    v = torch.stack([torch.stack([getattr(st, k) for k in COUNTERS])
                     for st in sst.tiles])
    s = sst.transport.all_sum(v[:, 1:])
    return torch.cat([sst.tiles[0].cycle[None], s])


def load_stream(cfg: EngineConfig, sst: ShardedState, edges: np.ndarray,
                limit: int | None = None) -> np.ndarray:
    """``core.ingest.load_stream`` on the sharded state: the IO cursors
    gathered from their owners, the edges loaded into every process's copy
    of the IO streams alike.  Returns the spill."""
    pos = _io_pos(sst)
    t0 = sst.tiles[0]
    stub = t0._replace(io_pos=pos)
    new, spill = _load_stream(cfg, stub, edges, limit)
    seen = set()
    for st in sst.tiles:
        for k in ("io_n", "io_pos"):
            t = getattr(st, k)
            if id(t) not in seen:
                t.copy_(getattr(new, k))
                seen.add(id(t))
    sst.refresh_quiet()
    return spill


def reset_counters(sst: ShardedState) -> None:
    """Zero every tile's counters, as an increment starts."""
    for st in sst.tiles:
        for k in COUNTERS[1:]:
            getattr(st, k).zero_()


def reset_increment(cfg: EngineConfig, sst: ShardedState) -> None:
    """The leaves an increment starts from zero
    (``core.engine.increment_reset_leaves``), zeroed on every tile."""
    names = increment_reset_leaves(cfg)
    for st in sst.tiles:
        for k in names:
            getattr(st, k).zero_()


def snapshot(cfg: EngineConfig, sst: ShardedState,
             quiet: torch.Tensor | None = None) -> torch.Tensor:
    """``obs.frames.snapshot`` of the sharded machine, on the device: the
    whole grid's planes from the owned cells, the counters summed, and
    the grid's quiescence (``quiet``, else ``gquiet``)."""
    c = counters(sst)
    whole = types.SimpleNamespace(
        cycle=c[0], stat_hops=c[1], stat_exec=c[2], stat_stall=c[3],
        stat_allocs=c[4], **{k: gather_leaf(sst, k) for k in (
            "aq_n", "pk_n", "ch_n")},
        **{k: gather_leaf(sst, k) if cfg.telemetry
           else getattr(sst.tiles[0], k) for k in ops.TM_PLANES})
    return obs_frames.snapshot(cfg, whole,
                               sst.gquiet if quiet is None else quiet)


def run_chunk(cfg: EngineConfig, app: DiffusionApp, sst: ShardedState,
              n_cycles: int | None = None, path: str = "auto",
              n_ctas: int | None = None, trace: torch.Tensor | None = None):
    """``n_cycles`` (default ``cfg.chunk``) cycles of the sharded machine,
    frozen once the grid is quiescent: each cycle every local tile's step
    (the cycle kernel's tile instance on the card, ``ref.tile_step_ref``
    on the CPU), the quiescence flag reduced over the ranks and the halo
    exchanged, all on the device.  ``trace``, an int32 ``[n_cycles, 2]``
    tensor on the tiles' device, gets each cycle's ``(active, in_flight)``
    row of the whole grid (rows ``0 .. cycles run - 1``), the tiles' rows
    summed over the ranks.  Returns ``(sst, int32 [quiescent at end,
    cycles run])`` on the device, as ``core.engine.run_chunk``."""
    cfg.validate()
    n = cfg.chunk if n_cycles is None else int(n_cycles)
    dev = sst.tiles[0].aq.device
    if trace is not None and (
            trace.device != dev or trace.dtype != torch.int32
            or tuple(trace.shape) != (n, 2) or not trace.is_contiguous()):
        raise ValueError(f"trace is {trace.dtype}{list(trace.shape)} on "
                         f"{trace.device}; a chunk needs a contiguous "
                         f"torch.int32[{n}, 2] on {dev}")
    c0 = sst.tiles[0].cycle.clone()
    traced = trace is not None
    card = sst.device.type == "cuda"
    steps = sst.steps(cfg, app, path, n_ctas, traced) if card else None
    for t in range(n):
        for k, (st, g) in enumerate(zip(sst.tiles, sst.geoms)):
            if card:
                steps[k]()
            else:
                sst.bind(k, ops.cca_tile_step(
                    cfg, app, st, g, sst.gquiet, sst.recs[k], path, n_ctas,
                    sst.trows[k] if traced else None))
        sst.reduce_quiet()
        if traced:
            trace[t] = sst.transport.all_sum(sst.trows)[0]
        sst.exchange()
    return sst, torch.stack([sst.gquiet, sst.tiles[0].cycle - c0])


def run_chunk_body(cfg: EngineConfig, app: DiffusionApp, sst: ShardedState,
                   **kw) -> ShardedState:
    """Exactly ``cfg.chunk`` cycles, never frozen: :func:`run_chunk` with
    the cycles it froze added to every tile's ``cycle`` (a quiescent
    machine's cycle moves nothing else, ``core.engine.run_chunk_body``)."""
    sst, rec = run_chunk(cfg, app, sst, **kw)
    for st in sst.tiles:
        st.cycle.add_(cfg.chunk - rec[1])
    return sst


def run_to_quiescence(cfg: EngineConfig, app: DiffusionApp,
                      sst: ShardedState, limit: int | None = None, **kw):
    """Chunks until the grid is quiescent, the cycle ``limit`` (checked
    between chunks) or ``LIVELOCK_CHUNKS`` chunks without an executed
    action or a hop, one host read a chunk (``StreamingEngine._pass``'s
    loop).  Returns ``(cycles run, quiescent, no-progress chunks, (hops,
    execs, stalls, allocs))``."""
    limit = cfg.max_cycles if limit is None else limit
    start, hops, execs, stalls, allocs = counters(sst).tolist()
    cycle, last, noprog, q = start, hops + execs, 0, bool(sst.gquiet)
    while not q and cycle - start < limit and noprog < LIVELOCK_CHUNKS:
        sst, qr = run_chunk(cfg, app, sst, **kw)
        cycle, hops, execs, stalls, allocs, q, ran = torch.cat(
            [counters(sst), qr]).tolist()
        noprog = noprog + 1 if hops + execs == last else 0
        last = hops + execs
        q = bool(q)
    return cycle - start, q, noprog, (hops, execs, stalls, allocs)
