"""Telemetry frames: per-chunk snapshots of the machine's telemetry planes
in a fixed-size ring on the state's device (the port's copy of
``repro.obs.frames``, DESIGN §8).

A **frame** is one snapshot of the cumulative telemetry planes, the
instantaneous queue depths and the scalar counter row, taken after every
chunk by the engine's host chunk loop with torch ops on the state's
device: no host read of its own.  The ring holds ``cfg.frame_ring``
frames and overwrites ring-style.  It is one flat int32 buffer ``[F,
frame_words(cfg)]`` whose views are the :class:`FrameRing` fields, so a
pass reads it back in one transfer.

Because the planes are cumulative over an increment (reset with the
``stat_*`` counters), the final frame reconciles exactly with the
counters, and per-chunk activity is the difference of consecutive frames
(:meth:`FrameLog.deltas`), which the flight recorder and the exporters
read.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.config import EngineConfig
from repro_torch.core.state import (N_TM_HIW, N_TM_LANE, N_TM_STAGES,
                                    MachineState)

# ---- frame scalar row indices (``scal [N_FS]``) ----
FS_CYCLE = 0      # machine cycle at snapshot time
FS_HOPS = 1       # cumulative stat_hops (this increment)
FS_EXEC = 2       # cumulative stat_exec
FS_STALL = 3      # cumulative stat_stall
FS_ALLOCS = 4     # cumulative stat_allocs
FS_BACKLOG = 5    # instantaneous sum of action-queue depths
FS_INFLIGHT = 6   # instantaneous channel + park-ring occupancy
FS_QUIESCENT = 7  # machine quiescent at snapshot time (0/1)
N_FS = 8

_PLANES = ("cell", "lane", "hiw", "aq_n", "pk_n", "ch_n", "scal")


def _shapes(cfg: EngineConfig) -> dict:
    """``{field: shape of one frame's entry}``, in the flat order."""
    H, W, L = cfg.height, cfg.width, cfg.lanes
    return dict(cell=(H, W, N_TM_STAGES), lane=(H, W, 4, L, N_TM_LANE),
                hiw=(H, W, N_TM_HIW), aq_n=(H, W), pk_n=(H, W),
                ch_n=(H, W, 4, L), scal=(N_FS,))


def frame_words(cfg: EngineConfig) -> int:
    """int32 words of one frame."""
    return sum(math.prod(s) for s in _shapes(cfg).values())


class FrameRing(NamedTuple):
    """The last ``F = cfg.frame_ring`` frames: ``flat [F, frame_words]``
    int32 and its views, each with a leading ``[F]`` axis.  ``n`` counts
    the frames written in total (it may exceed ``F``: the oldest were
    overwritten).  :meth:`host` copies the ring to the CPU in one
    transfer."""
    flat: torch.Tensor
    cell: torch.Tensor   # [F,H,W,N_TM_STAGES] cumulative stage activity
    lane: torch.Tensor   # [F,H,W,4,L,N_TM_LANE] cumulative lane counters
    hiw: torch.Tensor    # [F,H,W,N_TM_HIW] AQ/park hi-water marks
    aq_n: torch.Tensor   # [F,H,W] instantaneous action-queue depth
    pk_n: torch.Tensor   # [F,H,W] instantaneous park-ring depth
    ch_n: torch.Tensor   # [F,H,W,4,L] instantaneous lane occupancy
    scal: torch.Tensor   # [F,N_FS] scalar counter row
    n: int

    def host(self) -> "FrameRing":
        return _views(self.flat.cpu(), {k: tuple(getattr(self, k).shape[1:])
                                        for k in _PLANES}, self.n)


def _views(flat: torch.Tensor, shapes: dict, n: int) -> FrameRing:
    views, at = {}, 0
    for name, shape in shapes.items():
        size = math.prod(shape)
        views[name] = flat[:, at:at + size].view(flat.shape[0], *shape)
        at += size
    return FrameRing(flat=flat, n=n, **views)


def init_ring(cfg: EngineConfig, device) -> FrameRing:
    """An empty ring of ``cfg.frame_ring`` frames on ``device``."""
    flat = torch.zeros((cfg.frame_ring, frame_words(cfg)), dtype=torch.int32,
                       device=device)
    return _views(flat, _shapes(cfg), 0)


def snapshot(cfg: EngineConfig, st: MachineState,
             quiet: torch.Tensor | None = None) -> torch.Tensor:
    """One frame of ``st``, flat int32 ``[frame_words]`` on the state's
    device.  ``quiet``, a 0-d or 1-element tensor, is the state's
    quiescence when the caller holds it (a launch record's first word),
    else it is reduced here."""
    if quiet is None:
        from repro_torch.core.engine import quiescent   # engine imports us
        quiet = quiescent(st)
    i32 = torch.int32
    scal = torch.stack([
        st.cycle, st.stat_hops, st.stat_exec, st.stat_stall, st.stat_allocs,
        st.aq_n.sum(dtype=i32),
        st.ch_n.sum(dtype=i32) + st.pk_n.sum(dtype=i32),
        quiet.reshape(()).to(i32)])
    return torch.cat([t.reshape(-1) for t in (
        st.tm_cell, st.tm_lane, st.tm_hiw, st.aq_n, st.pk_n, st.ch_n,
        scal)])


def ring_store(ring: FrameRing, frame: torch.Tensor) -> FrameRing:
    """Write ``frame`` at slot ``n % F`` (in place, on the device) and
    advance ``n``."""
    ring.flat[ring.n % ring.flat.shape[0]] = frame
    return ring._replace(n=ring.n + 1)


@dataclasses.dataclass
class FrameLog:
    """Host-side, time-ordered frame sequence (numpy, oldest first).

    Built from the ring(s) of an increment (one ring per spill pass of
    the engine's chunk loop: the cumulative counters continue across
    passes, so the concatenation keeps the difference structure).
    """
    cell: np.ndarray   # [N,H,W,N_TM_STAGES]
    lane: np.ndarray   # [N,H,W,4,L,N_TM_LANE]
    hiw: np.ndarray    # [N,H,W,N_TM_HIW]
    aq_n: np.ndarray   # [N,H,W]
    pk_n: np.ndarray   # [N,H,W]
    ch_n: np.ndarray   # [N,H,W,4,L]
    scal: np.ndarray   # [N,N_FS]
    dropped: int = 0   # frames overwritten in the ring before readback

    def __len__(self) -> int:
        return int(self.scal.shape[0])

    @classmethod
    def from_rings(cls, rings) -> "FrameLog":
        """Unroll one or more rings (already on the host) into time
        order: ring slot ``i % F`` holds frame ``i``, so the surviving
        window is ``[max(0, n - F), n)``."""
        parts = {k: [] for k in _PLANES}
        dropped = 0
        for ring in rings:
            n = int(ring.n)
            if n == 0:
                continue
            F = ring.scal.shape[0]
            k = min(n, F)
            idx = np.arange(n - k, n) % F
            dropped += max(0, n - F)
            for name in _PLANES:
                parts[name].append(np.asarray(getattr(ring, name))[idx])
        if not parts["scal"]:
            raise ValueError("no frames recorded (empty ring)")
        arrs = {k: np.concatenate(v, axis=0) for k, v in parts.items()}
        return cls(**arrs, dropped=dropped)

    # -- reductions ---------------------------------------------------

    def last(self) -> dict:
        """The final frame's planes (cumulative over the increment)."""
        return {k: getattr(self, k)[-1] for k in _PLANES}

    def totals(self) -> dict:
        """Scalar totals of the final frame: the reconciliation surface
        against the engine's ``IncrementResult`` counters."""
        s = self.scal[-1]
        return dict(cycle=int(s[FS_CYCLE]), hops=int(s[FS_HOPS]),
                    execs=int(s[FS_EXEC]), stalls=int(s[FS_STALL]),
                    allocs=int(s[FS_ALLOCS]), backlog=int(s[FS_BACKLOG]),
                    in_flight=int(s[FS_INFLIGHT]),
                    quiescent=bool(s[FS_QUIESCENT]))

    def deltas(self) -> dict:
        """Per-frame activity: consecutive differences of the cumulative
        planes and counters (the first frame differenced against zero:
        the counters reset at increment start).  Instantaneous fields
        (``aq_n``/``pk_n``/``ch_n``/``hiw``) pass through unchanged."""
        if self.dropped:
            # the window does not start at cycle 0: difference within
            # the window only, dropping its first frame
            return dict(
                cell=np.diff(self.cell, axis=0),
                lane=np.diff(self.lane, axis=0),
                scal=np.diff(self.scal, axis=0),
                aq_n=self.aq_n[1:], pk_n=self.pk_n[1:],
                ch_n=self.ch_n[1:], hiw=self.hiw[1:])
        z_cell = np.zeros_like(self.cell[:1])
        z_lane = np.zeros_like(self.lane[:1])
        z_scal = np.zeros_like(self.scal[:1])
        return dict(
            cell=np.diff(np.concatenate([z_cell, self.cell]), axis=0),
            lane=np.diff(np.concatenate([z_lane, self.lane]), axis=0),
            scal=np.diff(np.concatenate([z_scal, self.scal]), axis=0),
            aq_n=self.aq_n, pk_n=self.pk_n, ch_n=self.ch_n, hiw=self.hiw)


def plane_digest(a) -> str:
    """The first 16 hex digits of the sha256 of an int32 plane's bytes
    (little-endian, C order): how the telemetry fingerprint names a
    plane."""
    a = np.ascontiguousarray(np.asarray(a), dtype="<i4")
    return hashlib.sha256(a.tobytes()).hexdigest()[:16]


def state_digests(arrays: dict) -> dict:
    """``{leaf: plane_digest}`` of a machine state given as numpy arrays
    (``core.state.state_to_numpy``, or a JAX state's leaves): a float32
    leaf by its bits, a bool leaf as 0 / 1.  How the fault fingerprint
    names a final state."""
    out = {}
    for k, a in arrays.items():
        a = np.asarray(a)
        out[k] = plane_digest(a.view(np.int32) if a.dtype == np.float32
                              else a)
    return out


def frame_record(frames) -> dict:
    """A frame log as the telemetry fingerprint records it: the frame
    count, ``dropped``, ``totals()`` and the final frame's planes, each as
    its shape and :func:`plane_digest`.  It reads only those members, so
    it records the JAX package's ``FrameLog`` the same way."""
    return dict(frames=len(frames), dropped=frames.dropped,
                totals=frames.totals(),
                planes={k: dict(shape=list(v.shape), digest=plane_digest(v))
                        for k, v in frames.last().items()})
