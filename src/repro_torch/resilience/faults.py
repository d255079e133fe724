"""Deterministic fault injection for the cycle engine (DESIGN §9).

The port's own copy of ``repro.resilience.faults``.  A :class:`FaultPlan`
is a static, seeded description of the hazards that ``cycle_body`` (and
the fault instances of both CUDA cycle kernels) inject into the hop
stage.  ``EngineConfig(faults=None)`` runs none of this code, so the
engine without faults is the engine it was before.

Fault decisions are pure counter hashes of ``(seed, cycle, link, salt)``:
no random state rides in ``MachineState``, so the plain version, the
kernels and the JAX engine make the same decisions bit for bit.

The four hazards:

* **drop** -- a granted application flit vanishes on the link: the
  sender pops it, the receiver never sees it.  Only monotone relaxes
  (``OP_APP`` / ``OP_REPAIR``, :func:`is_droppable`) are ever dropped:
  they can be re-derived from the durable vertex values, an edge insert
  or a protocol message could not.
* **blackout** -- a named ``(row, col, dir)`` link is dead for a cycle
  window: none of its lanes is granted.  A lossless delay, for all
  traffic.
* **duplicate** -- the receiver takes the flit and the sender keeps it
  (a retransmission), so it is delivered again later.  Monotone relaxes
  absorb the replay.
* **corrupt** -- one bit of the value word of a granted application flit
  flips in transit.  Every message carries an XOR seal over its other
  words (``core.msg.msg_seal``); the execute stage checks it at pop and
  discards a corrupted message as a counted no-op, a detected drop.

Injection is counted in the ``flt`` state leaf (``FLT_*`` indices); the
end-of-increment loss detector (``core.engine``) reads it, and with
telemetry cross-checks it against link departures (``stat_hops``) less
deliveries (``sum(TM_HOP)``), then runs the bounded repair pass.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.msg import OP_APP, OP_REPAIR

# ---- fault-counter leaf indices: ``MachineState.flt`` [N_FLT] int32 ----
FLT_DROP = 0       # application flits dropped on a link
FLT_DUP = 1        # application flits delivered twice (sender kept a copy)
FLT_CORRUPT = 2    # corrupted flits caught by the seal check at pop
FLT_BLACKOUT = 3   # occupied lane-cycles a blackout window held back
N_FLT = 4

# 16-bit decision space: a rate r fires where hash16 < int(r * 65536)
_HASH_SPACE = 1 << 16

# 32-bit odd mixing constants (Murmur3 / xxhash finalizers)
_M1 = 0x9E3779B1
_M2 = 0x85EBCA6B
_M3 = 0xC2B2AE35
_M4 = 0x27D4EB2F
U32 = 0xFFFFFFFF


def fault_key(seed: int, salt):
    """The hash's per-(seed, salt) key, a non-negative 31-bit int (a
    tensor of them for a tensor of salts)."""
    return ((seed * _M4) & U32) + salt * 40503 & 0x7FFFFFFF


def _mul32(a, b: int):
    """``a * b mod 2**32`` for int64 ``a`` in ``[0, 2**32)`` and a 32-bit
    constant ``b``, in two 16-bit halves so no int64 product overflows."""
    lo = (a & 0xFFFF) * b
    hi = ((a >> 16) * b) & 0xFFFF
    return (lo + (hi << 16)) & U32


def fault_hash16(seed: int, cycle, link, salt):
    """Deterministic per-(cycle, link, salt) hash in ``[0, 65536)``.

    ``cycle``, ``link`` and ``salt`` are ints or int tensors that
    broadcast (``salt`` small and non-negative).  The
    JAX engine computes this in wrapping int32 arithmetic with logical
    shifts; here it is the same function in int64 kept to the low 32
    bits, where every shift is logical because the value is never
    negative.  Returns int64.
    """
    cycle = torch.as_tensor(cycle).long() & U32
    link = torch.as_tensor(link).long() & U32
    key = fault_key(seed, torch.as_tensor(salt, device=link.device).long())
    h = (_mul32(cycle, _M1) + _mul32(link, _M2) + key) & U32
    h = _mul32(h ^ (h >> 16), _M2)
    h = _mul32(h ^ (h >> 13), _M3)
    h = h ^ (h >> 16)
    return h & (_HASH_SPACE - 1)


def is_droppable(op):
    """True where ``op`` may be dropped, duplicated or corrupted: the
    monotone relaxes, which the durable vertex values can re-derive."""
    return (op == OP_APP) | (op == OP_REPAIR)


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Static, seeded fault schedule (``EngineConfig.faults``).

    Rates are per granted application flit per link per cycle;
    ``blackouts`` is a tuple of ``(row, col, dir, start_cycle,
    n_cycles)`` link outages (``dir`` a ``msg.DIR_*`` code, the window on
    the machine's ``cycle`` counter).  ``max_repair_rounds`` bounds the
    end-of-increment repair pass.  Frozen and hashable, as the config it
    rides on.
    """
    seed: int = 0
    drop_rate: float = 0.0
    dup_rate: float = 0.0
    corrupt_rate: float = 0.0
    blackouts: tuple = ()
    max_repair_rounds: int = 3

    # ---- 16-bit thresholds (0 turns the hazard off) ----
    @property
    def drop_thr(self) -> int:
        return int(self.drop_rate * _HASH_SPACE)

    @property
    def dup_thr(self) -> int:
        return int(self.dup_rate * _HASH_SPACE)

    @property
    def corrupt_thr(self) -> int:
        return int(self.corrupt_rate * _HASH_SPACE)

    def safe(self) -> "FaultPlan":
        """The reliable-transport twin: the same seed and repair budget,
        no hazard, no blackout.  The repair pass runs under it; the state
        keeps its shapes (the ``flt`` leaf)."""
        return dataclasses.replace(self, drop_rate=0.0, dup_rate=0.0,
                                   corrupt_rate=0.0, blackouts=())

    def validate(self, cfg) -> None:
        """Raise ``ValueError`` where the JAX engine's plan asserts."""
        for r in (self.drop_rate, self.dup_rate, self.corrupt_rate):
            if not 0.0 <= r < 1.0:
                raise ValueError(f"fault rate {r} outside [0, 1)")
        if self.max_repair_rounds < 1:
            raise ValueError("max_repair_rounds must be >= 1")
        for b in self.blackouts:
            r, c, d, start, n = b
            if not (0 <= r < cfg.height and 0 <= c < cfg.width):
                raise ValueError(f"blackout {b}: cell off-grid")
            if not 0 <= d < 4:
                raise ValueError(f"blackout {b}: bad direction")
            if n < 1 or start < 0:
                raise ValueError(f"blackout {b}: bad window")
