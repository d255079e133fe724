"""Engine configuration for the AM-CCA-style message-driven machine.

The port's own copy of ``repro.core.config.EngineConfig``: the same
fields (``backend`` dropped -- the device decides) and the same derived
capacities, so a config built with the same arguments lays the machine
state out exactly as the JAX engine does, virtual lanes and rhizome
vertex objects included, and ``faults`` takes the port's own
``resilience.FaultPlan``.  Knobs the port does not carry yet are rejected
by :meth:`EngineConfig.validate` with ``NotImplementedError`` instead of
being ignored.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.msg import MSG_WORDS


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    # --- chip geometry (paper: 32x32) ---
    height: int = 32
    width: int = 32

    # --- RPVO storage ---
    n_vertices: int = 1024        # logical vertices (roots, round-robin placed)
    edge_cap: int = 8             # edges per RPVO node before spilling to ghost
    ghost_slots: int = 64         # ghost slots per cell (beyond root slots)
    rhizome_cap: int = 1          # co-equal roots per vertex

    # --- queues / buffers ---
    queue_cap: int = 32           # per-cell action queue
    chan_cap: int = 8             # per-cell per-direction outgoing channel
    futq_cap: int = 8             # per-future deferred-task queue

    # --- virtual lanes ---
    lanes: int = 1                # virtual lanes per physical channel
    lane_cap: int = 0             # per-lane ring capacity; 0 -> chan_cap // lanes
    park_cap: int = 0             # per-cell park buffer; 0 -> chan_cap

    # --- IO channels (one edge per IO cell per cycle) ---
    n_io_cells: int = 0           # 0 -> one per column (paper-style)
    io_stream_cap: int = 4096     # per-IO-cell residual stream capacity

    # --- allocation policy (paper Fig. 5) ---
    allocator: str = "vicinity"   # "vicinity" (<=2 hops) | "random"
    vicinity_hops: int = 2

    # --- app ---
    n_vals: int = 1               # per-slot application values
    qbatch: int = 1               # query-batch width

    # --- engine ---
    max_cycles: int = 1_000_000
    chunk: int = 256              # cycles per kernel launch (K)

    # --- observability / resilience ---
    telemetry: bool = False
    frame_ring: int = 64
    faults: object = None         # resilience.FaultPlan, or None: no fault
                                  # code runs at all
    ingest_guard: bool = False

    @property
    def n_cells(self) -> int:
        return self.height * self.width

    @property
    def root_slots(self) -> int:
        return int(math.ceil(self.n_vertices / self.n_cells))

    @property
    def primary_slots(self) -> int:
        return self.rhizome_cap * self.root_slots

    @property
    def slots(self) -> int:
        return self.primary_slots + self.ghost_slots

    @property
    def rhizome_stride(self) -> int:
        return max(1, self.n_cells // self.rhizome_cap) | 1

    @property
    def io_cells(self) -> int:
        return self.n_io_cells if self.n_io_cells > 0 else self.width

    @property
    def lane_capacity(self) -> int:
        return self.lane_cap if self.lane_cap > 0 else \
            max(1, self.chan_cap // self.lanes)

    @property
    def park_capacity(self) -> int:
        if self.lanes == 1:
            return 1
        return self.park_cap if self.park_cap > 0 else self.chan_cap

    @property
    def msg_words(self) -> int:
        return MSG_WORDS + max(0, self.qbatch - 1)

    @property
    def aq_reserve(self) -> int:
        # reserved action-queue slots so the active action's local
        # emissions always complete (DESIGN §4.2)
        return self.edge_cap + 2 + (self.rhizome_cap - 1)

    @property
    def sys_reserve(self) -> int:
        return 2

    def validate(self) -> None:
        """Raise ``ValueError`` on a malformed config (the JAX engine's
        rules) and ``NotImplementedError`` on a knob the port does not
        carry yet."""
        not_yet = [name for name, off in (
            ("qbatch>1", self.qbatch == 1),
            ("n_vals>1", self.n_vals == 1),
        ) if not off]
        if not_yet:
            raise NotImplementedError(
                f"repro_torch does not port {', '.join(not_yet)} yet")
        if self.n_io_cells not in (0, self.width):
            raise NotImplementedError(
                f"n_io_cells={self.n_io_cells} on a {self.width}-wide grid: "
                "the JAX engine's io_stage delivers [n_io_cells]-shaped "
                "messages into the [width]-shaped row-0 queues and fails "
                "on it with a broadcast error, so there is no reference "
                "behaviour to port (ROADMAP.md item 5); use 0 or the width")
        # the derived capacities below divide by these two
        if self.lanes < 1:
            raise ValueError("lanes must be >= 1")
        if not 1 <= self.rhizome_cap <= self.n_cells:
            raise ValueError("rhizome_cap must be in [1, n_cells]")
        checks = (
            (self.height >= 2 and self.width >= 2, "grid must be >= 2x2"),
            (self.allocator in ("vicinity", "random"),
             f"unknown allocator {self.allocator!r}"),
            (self.queue_cap > self.aq_reserve + self.sys_reserve + 1,
             "queue too small for reserves (DESIGN §4.2): need queue_cap > "
             f"{self.aq_reserve + self.sys_reserve + 1}"),
            (self.n_cells * self.slots < 2 ** 31, "address overflows int32"),
            (self.edge_cap >= 1 and self.futq_cap >= 2,
             "edge_cap >= 1 and futq_cap >= 2 required"),
            (self.lane_cap >= 0 and self.park_cap >= 0,
             "lane_cap and park_cap must be >= 0"),
            (self.frame_ring >= 2, "frame_ring must hold >= 2 frames"),
            (self.lane_capacity >= 1, "lane_capacity must be >= 1"),
            (self.park_capacity >= 1, "park_capacity must be >= 1"),
            # the k-th root of a vertex lives at (v + k * stride) % n_cells
            (len({k * self.rhizome_stride % self.n_cells
                  for k in range(self.rhizome_cap)}) == self.rhizome_cap,
             "rhizome_stride collides rhizome roots on one cell; pick a "
             "rhizome_cap with distinct k*stride mod n_cells"),
            # a rhizome activation drains up to futq_cap deferred inserts
            # onto the local action queue in one action
            (self.rhizome_cap == 1 or self.futq_cap <= self.aq_reserve,
             f"futq_cap={self.futq_cap} exceeds the local-emission reserve "
             f"{self.aq_reserve}; shrink futq_cap or raise "
             "edge_cap/rhizome_cap"),
            (self.vicinity_hops >= 1, "vicinity_hops must be >= 1"),
            (self.io_stream_cap >= 1 and self.chunk >= 1,
             "io_stream_cap and chunk must be >= 1"),
        )
        for ok, msg in checks:
            if not ok:
                raise ValueError(msg)
        if self.ingest_guard and not self.telemetry:
            raise ValueError("ingest_guard needs the tm_hiw telemetry "
                             "plane (set telemetry=True, DESIGN §9)")
        if self.faults is not None:
            from repro_torch.resilience.faults import FaultPlan
            if not isinstance(self.faults, FaultPlan):
                raise ValueError(f"faults must be a repro_torch.resilience."
                                 f"FaultPlan or None, not {self.faults!r}")
            self.faults.validate(self)
