"""Elasticity, failure handling and straggler mitigation (DESIGN §6); the
port's copy of ``repro.train.elastic``, host-only Python, unchanged in
behaviour.

On a real multi-pod deployment the runtime signals we handle are:
  * a worker disappears (ICI/DCN heartbeat loss)  -> restart from the last
    atomic checkpoint on a (possibly smaller) mesh — `plan_remesh` picks
    the largest valid mesh for the surviving chip count and
    Checkpointer.restore re-shards onto it (elastic restore; the port's
    restore returns whole arrays, re-sharding is not ported);
  * a step exceeds the straggler deadline         -> StepWatchdog fires;
    the driver either re-dispatches the step (deterministic data makes
    the retry safe) or drops the slow replica for the next sync.

tests/test_torch_elastic.py holds this copy to the contracts of
tests/test_fault_tolerance.py: the remesh plans, the watchdog firing on an
injected delay, the heartbeat's survivors.
"""
from __future__ import annotations

import dataclasses
import threading
import time


@dataclasses.dataclass
class MeshPlan:
    data: int
    model: int
    pods: int = 1

    @property
    def devices(self) -> int:
        return self.data * self.model * self.pods


def plan_remesh(surviving_devices: int, model_parallel: int = 16,
                pod_size: int = 256) -> MeshPlan:
    """Largest (pod, data, model) grid that fits the surviving chips,
    keeping TP intact (a TP group must be whole — losing one chip of a
    16-chip TP group costs the whole group)."""
    groups = surviving_devices // model_parallel
    if groups < 1:
        raise RuntimeError("fewer chips than one TP group survive")
    pods = max(1, surviving_devices // pod_size)
    data = groups // pods
    while pods > 1 and data < 1:
        pods -= 1
        data = groups // pods
    return MeshPlan(data=max(data, 1), model=model_parallel, pods=pods)


class StepWatchdog:
    """Detects stragglers: if a step doesn't complete within
    `deadline_s`, `on_straggler` fires (re-dispatch / drop-replica)."""

    def __init__(self, deadline_s: float, on_straggler=None):
        self.deadline = deadline_s
        self.on_straggler = on_straggler or (lambda step: None)
        self.fired = []
        self._timer = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.cancel()
        return False

    def arm(self, step: int):
        self.cancel()
        def fire():
            self.fired.append(step)
            self.on_straggler(step)
        self._timer = threading.Timer(self.deadline, fire)
        self._timer.daemon = True
        self._timer.start()

    def disarm(self):
        self.cancel()

    def cancel(self):
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None


class HeartbeatMonitor:
    """Tracks per-worker liveness; report() returns the surviving set."""

    def __init__(self, n_workers: int, timeout_s: float = 60.0):
        self.timeout = timeout_s
        self.last = {i: time.time() for i in range(n_workers)}

    def beat(self, worker: int):
        self.last[worker] = time.time()

    def survivors(self) -> list:
        now = time.time()
        return [w for w, t in self.last.items() if now - t < self.timeout]
