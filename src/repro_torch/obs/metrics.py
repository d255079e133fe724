"""Small latency/throughput summaries (the port's copy of
``repro.obs.metrics``: ``summarize`` and ``render_summary``).

Host-side helpers for the serving surface (``launch/serve.py``):
percentile summaries over wall-clock samples.  Pure numpy.  The
engine-rate summary over telemetry frames waits for the port's
telemetry.
"""
from __future__ import annotations

import numpy as np


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
