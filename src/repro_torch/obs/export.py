"""Telemetry exporters (the port's copy of ``repro.obs.export``, DESIGN
§8).

Two render targets for a :class:`repro_torch.obs.FrameLog`:

* :func:`chrome_trace` — Chrome ``trace_event`` JSON (load in
  ``chrome://tracing`` / Perfetto): one counter track per pipeline
  stage (chip-wide per-chunk activity) and one per virtual lane
  (occupancy + grants + blocked, aggregated over the mesh), with the
  machine cycle as the timebase (1 cycle = 1 "us");
* :func:`congestion_heatmap` — per-cell [H,W] planes of the increment's
  cumulative activity (arrivals, execs, stalls, lane occupancy
  integral, blocked cycles, queue hi-water marks), the same JSON dump
  as the JAX package's (``benchmarks/report.py --section congestion``
  renders it).

Both are pure dict builders over host numpy; ``write_*`` helpers dump
them to JSON files at the path the caller gives.
"""
from __future__ import annotations

import json
import pathlib

import numpy as np

from repro_torch.core.config import EngineConfig
from repro_torch.core.state import (N_TM_STAGES, TM_HW_AQ, TM_HW_PK,
                                    TM_L_BLOCK, TM_L_GRANT, TM_L_OCC)
from repro_torch.obs.frames import FS_CYCLE, FrameLog

# index order matches the TM_* stage constants in core.state
STAGE_NAMES = ("exec", "alloc", "stall", "hop", "stage",
               "park", "unpark", "io", "bcast")
assert len(STAGE_NAMES) == N_TM_STAGES

_DIR_NAMES = ("N", "S", "W", "E")


def chrome_trace(cfg: EngineConfig, frames: FrameLog) -> dict:
    """Chrome ``trace_event`` counter tracks from the frame log.

    Counter semantics: each sample is the PER-CHUNK activity (delta of
    the cumulative plane between consecutive frames), stamped at the
    frame's machine cycle.  Stage tracks sum over the mesh; lane tracks
    sum each ``(direction, lane)`` pair over the mesh so a wedged escape
    lane shows up as a flat-lining ``lane/W0 grants`` counter.
    """
    d = frames.deltas()
    cyc = frames.scal[:, FS_CYCLE]
    if frames.dropped:
        cyc = cyc[1:]                       # deltas() dropped frame 0
    events = []

    def counter(name, ts, args):
        events.append(dict(name=name, ph="C", ts=int(ts), pid=0, tid=0,
                           args={k: int(v) for k, v in args.items()}))

    cell = d["cell"].sum(axis=(1, 2))        # [N, N_TM_STAGES]
    for i, t in enumerate(cyc):
        for s, name in enumerate(STAGE_NAMES):
            counter(f"stage/{name}", t, {name: cell[i, s]})
    lane = d["lane"].sum(axis=(1, 2))        # [N, 4, L, N_TM_LANE]
    occ = frames.ch_n.sum(axis=(1, 2))       # [N, 4, L] instantaneous
    if frames.dropped:
        occ = occ[1:]
    L = lane.shape[2]
    for i, t in enumerate(cyc):
        for dd in range(4):
            for l in range(L):
                counter(f"lane/{_DIR_NAMES[dd]}{l}", t, {
                    "occ": occ[i, dd, l],
                    "grants": lane[i, dd, l, TM_L_GRANT],
                    "blocked": lane[i, dd, l, TM_L_BLOCK]})
    return dict(traceEvents=events, displayTimeUnit="ms",
                metadata=dict(timebase="1 trace us = 1 machine cycle",
                              grid=f"{cfg.height}x{cfg.width}",
                              lanes=cfg.lanes, frames=len(frames),
                              dropped=frames.dropped))


def congestion_heatmap(cfg: EngineConfig, frames: FrameLog) -> dict:
    """Per-cell congestion planes of the increment (final frame's
    cumulative counters), as JSON-ready nested lists."""
    last = frames.last()
    cell, lane, hiw = last["cell"], last["lane"], last["hiw"]
    # cycle span of the log (frame 0 = increment-start baseline)
    cycles = max(1, int(frames.scal[-1][FS_CYCLE]
                        - frames.scal[0][FS_CYCLE]))

    def plane(a):
        return np.asarray(a).astype(int).tolist()

    return dict(
        grid=[cfg.height, cfg.width], lanes=cfg.lanes, cycles=cycles,
        frames=len(frames), dropped=frames.dropped,
        # [H,W] planes
        stages={n: plane(cell[..., i]) for i, n in enumerate(STAGE_NAMES)},
        lane_occ_integral=plane(lane[..., TM_L_OCC].sum(axis=(-2, -1))),
        lane_blocked=plane(lane[..., TM_L_BLOCK].sum(axis=(-2, -1))),
        lane_grants=plane(lane[..., TM_L_GRANT].sum(axis=(-2, -1))),
        aq_hiwater=plane(hiw[..., TM_HW_AQ]),
        pk_hiwater=plane(hiw[..., TM_HW_PK]))


def write_chrome_trace(path, cfg: EngineConfig, frames: FrameLog) -> str:
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(chrome_trace(cfg, frames)))
    return str(p)


def write_heatmap(path, cfg: EngineConfig, frames: FrameLog) -> str:
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(congestion_heatmap(cfg, frames), indent=1))
    return str(p)
