"""Small latency/throughput summaries (the port's copy of
``repro.obs.metrics``).

Host-side helpers shared by the serving surface (``launch/serve.py``)
and the profile run of ``launch/paper_experiments.py::bench_engine``:
percentile summaries over wall-clock samples, and engine-rate summaries
over a telemetry frame log.  Pure numpy -- no engine imports.
"""
from __future__ import annotations

import numpy as np

from repro_torch.obs.frames import (FS_BACKLOG, FS_CYCLE, FS_EXEC, FS_HOPS,
                                    FS_INFLIGHT, FS_STALL, FrameLog)


def summarize(samples, unit: str = "s") -> dict:
    """Percentile summary of a list of wall-clock samples."""
    a = np.asarray(list(samples), np.float64)
    if a.size == 0:
        return dict(n=0, unit=unit)
    return dict(
        n=int(a.size), unit=unit, mean=float(a.mean()),
        p50=float(np.percentile(a, 50)), p90=float(np.percentile(a, 90)),
        p99=float(np.percentile(a, 99)), max=float(a.max()))


def render_summary(name: str, samples, unit: str = "ms",
                   scale: float = 1e3) -> str:
    """One-line latency summary (``scale`` converts samples to ``unit``)."""
    s = summarize([x * scale for x in samples], unit)
    if not s["n"]:
        return f"[{name}] no samples"
    return (f"[{name}] n={s['n']} mean={s['mean']:.2f}{unit} "
            f"p50={s['p50']:.2f} p90={s['p90']:.2f} p99={s['p99']:.2f} "
            f"max={s['max']:.2f}{unit}")


def engine_rates(frames: FrameLog) -> dict:
    """Chip-wide rates from a frame log: activity per machine cycle plus
    mean queue pressure (the serving/benchmark summary surface)."""
    s = frames.scal
    # cycle SPAN of the log (frame 0 is the increment-start baseline;
    # the counters reset there, so span is the right normalizer)
    cycles = max(1, int(s[-1, FS_CYCLE] - s[0, FS_CYCLE]))
    return dict(
        cycles=cycles,
        execs_per_cycle=float(s[-1, FS_EXEC]) / cycles,
        hops_per_cycle=float(s[-1, FS_HOPS]) / cycles,
        stalls_per_cycle=float(s[-1, FS_STALL]) / cycles,
        mean_backlog=float(s[:, FS_BACKLOG].mean()),
        mean_in_flight=float(s[:, FS_INFLIGHT].mean()),
        peak_backlog=int(s[:, FS_BACKLOG].max()),
        peak_in_flight=int(s[:, FS_INFLIGHT].max()))
