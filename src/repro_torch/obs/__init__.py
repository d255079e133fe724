"""``repro_torch.obs`` -- telemetry of the port (DESIGN §8), the same
names as ``repro.obs``:

* ``frames``  -- the per-chunk snapshot (:func:`snapshot`), the ring on
  the state's device (:class:`FrameRing`, :func:`init_ring`,
  :func:`ring_store`) and the host-side :class:`FrameLog`;
* ``flight``  -- the livelock flight recorder: the wedge analysis over
  the last frames and the "who is wedged" report that
  :class:`repro_torch.core.engine.LivelockError` carries;
* ``export``  -- Chrome ``trace_event`` JSON and the congestion heatmap;
* ``metrics`` -- latency and engine-rate summaries.

The telemetry planes live in ``core.state.MachineState`` (``tm_cell`` /
``tm_lane`` / ``tm_hiw``) and are accumulated inside the cycle stages
when ``EngineConfig.telemetry`` is on: by ``cycle_body`` in the plain
version and by the telemetry instances of both CUDA cycle kernels.
"""
from repro_torch.obs.export import (chrome_trace, congestion_heatmap,
                                    write_chrome_trace, write_heatmap)
from repro_torch.obs.flight import (render_wedge_report, wedged_cells,
                                    wedged_lanes)
from repro_torch.obs.frames import (FS_ALLOCS, FS_BACKLOG, FS_CYCLE,
                                    FS_EXEC, FS_HOPS, FS_INFLIGHT,
                                    FS_QUIESCENT, FS_STALL, FrameLog,
                                    FrameRing, init_ring, ring_store,
                                    snapshot)
from repro_torch.obs.metrics import engine_rates, render_summary, summarize

__all__ = [
    "FrameLog", "FrameRing", "init_ring", "ring_store", "snapshot",
    "FS_CYCLE", "FS_HOPS", "FS_EXEC", "FS_STALL", "FS_ALLOCS",
    "FS_BACKLOG", "FS_INFLIGHT", "FS_QUIESCENT",
    "chrome_trace", "congestion_heatmap", "write_chrome_trace",
    "write_heatmap", "render_wedge_report", "wedged_cells", "wedged_lanes",
    "engine_rates", "render_summary", "summarize",
]
