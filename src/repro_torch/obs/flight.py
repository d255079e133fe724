"""Livelock flight recorder (the port's copy of ``repro.obs.flight``,
DESIGN §8).

When the engine's livelock detector fires, the last ``cfg.frame_ring``
frames are already in the frame ring — the flight
recorder turns them into a per-cell / per-lane "who is wedged" report
instead of the bare sizing-advice exception message.

Wedge analysis over the TRAILING window (default 8 frames = the
livelock detector's ``LIVELOCK_CHUNKS`` no-progress chunks, so startup
activity earlier in the ring cannot mask a late wedge):

* a **cell** is wedged when it still holds work at the final frame
  (action queue, park ring or any outgoing lane non-empty) but made no
  progress over the window — zero action pops and zero flit arrivals;
* a **lane** is wedged when it is occupied at the final frame but won
  zero arbiter grants over the window (all its blocked cycles counted).

The report names the wedged cells with their queue depths and hi-water
marks, and the wedged lanes with their occupancy — the §4.2/§7
diagnosis that previously took a manual host-loop trace session.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.config import EngineConfig
from repro_torch.core.state import (TM_EXEC, TM_HOP, TM_HW_AQ, TM_HW_PK,
                                    TM_L_GRANT)
from repro_torch.obs.frames import FS_CYCLE, FrameLog

_DIR_NAMES = ("N", "S", "W", "E")

# trailing-window length in frames; matches engine.LIVELOCK_CHUNKS (the
# detector guarantees this many final chunks made zero progress) —
# duplicated here as a literal to keep ``flight`` import-light
WEDGE_WINDOW = 8


def _window_start(frames: FrameLog, window: int) -> int:
    return max(0, len(frames) - 1 - window)


def wedged_cells(cfg: EngineConfig, frames: FrameLog,
                 window: int = WEDGE_WINDOW) -> list[dict]:
    """Cells holding work with zero exec/arrival progress over the
    trailing window, sorted by total pending work (descending)."""
    first, last = frames.cell[_window_start(frames, window)], frames.cell[-1]
    prog = ((last[..., TM_EXEC] - first[..., TM_EXEC])
            + (last[..., TM_HOP] - first[..., TM_HOP]))      # [H,W]
    aq, pk = frames.aq_n[-1], frames.pk_n[-1]
    ch = frames.ch_n[-1].sum(axis=(-2, -1))                  # [H,W]
    pending = aq + pk + ch
    wedged = (pending > 0) & (prog == 0)
    out = []
    for r, c in zip(*np.nonzero(wedged)):
        out.append(dict(
            cell=(int(r), int(c)), aq=int(aq[r, c]), pk=int(pk[r, c]),
            ch=int(ch[r, c]),
            aq_hiwater=int(frames.hiw[-1][r, c, TM_HW_AQ]),
            pk_hiwater=int(frames.hiw[-1][r, c, TM_HW_PK])))
    out.sort(key=lambda d: -(d["aq"] + d["pk"] + d["ch"]))
    return out


def wedged_lanes(cfg: EngineConfig, frames: FrameLog,
                 window: int = WEDGE_WINDOW) -> list[dict]:
    """Occupied link lanes that won zero grants over the trailing window."""
    first, last = frames.lane[_window_start(frames, window)], frames.lane[-1]
    grants = last[..., TM_L_GRANT] - first[..., TM_L_GRANT]  # [H,W,4,L]
    occ = frames.ch_n[-1]
    wedged = (occ > 0) & (grants == 0)
    out = []
    for r, c, d, l in zip(*np.nonzero(wedged)):
        out.append(dict(cell=(int(r), int(c)), dir=_DIR_NAMES[int(d)],
                        lane=int(l), occ=int(occ[r, c, d, l])))
    out.sort(key=lambda e: -e["occ"])
    return out


def render_wedge_report(cfg: EngineConfig, frames: FrameLog,
                        max_rows: int = 12) -> str:
    """Human-readable flight-recorder report for the livelock message."""
    cells = wedged_cells(cfg, frames)
    lanes = wedged_lanes(cfg, frames)
    w0 = _window_start(frames, WEDGE_WINDOW)
    cyc = int(frames.scal[-1][FS_CYCLE] - frames.scal[w0][FS_CYCLE])
    lines = [f"flight recorder: trailing {len(frames) - w0} of "
             f"{len(frames)} frames ({cyc} cycles) — "
             f"{len(cells)} wedged cell(s), {len(lanes)} wedged lane(s)"]
    for d in cells[:max_rows]:
        r, c = d["cell"]
        lines.append(
            f"  cell ({r},{c}): aq={d['aq']} pk={d['pk']} ch={d['ch']} "
            f"pending, 0 execs / 0 arrivals over the window "
            f"(hi-water aq={d['aq_hiwater']} pk={d['pk_hiwater']})")
    if len(cells) > max_rows:
        lines.append(f"  ... {len(cells) - max_rows} more wedged cells")
    for e in lanes[:max_rows]:
        r, c = e["cell"]
        lines.append(f"  link ({r},{c})->{e['dir']} lane {e['lane']}: "
                     f"{e['occ']} queued, 0 grants over the window")
    if len(lanes) > max_rows:
        lines.append(f"  ... {len(lanes) - max_rows} more wedged lanes")
    return "\n".join(lines)
