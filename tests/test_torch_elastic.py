"""The port's ``train/elastic.py`` against the JAX package's, on the CPU:
``plan_remesh`` equal to JAX's over every surviving chip count up to two
pods (and both refuse fewer chips than a TP group), and the contracts of
``tests/test_fault_tolerance.py`` for the watchdog (fires on an injected
delay, not when disarmed in time) and the heartbeat monitor (the
survivors of a timeout)."""
import time

import pytest

from repro.train import elastic as jel
from repro_torch.train import elastic


@pytest.mark.parametrize("mp,pod", [(16, 256), (8, 64), (1, 4)])
def test_plan_remesh_equals_jax(mp, pod):
    for n in range(mp, 2 * pod + 7):
        a = elastic.plan_remesh(n, model_parallel=mp, pod_size=pod)
        b = jel.plan_remesh(n, model_parallel=mp, pod_size=pod)
        assert (a.data, a.model, a.pods, a.devices) == \
            (b.data, b.model, b.pods, b.devices), n
    for mod in (elastic, jel):
        with pytest.raises(RuntimeError):
            mod.plan_remesh(mp - 1 if mp > 1 else 0, model_parallel=mp)


def test_plan_remesh_contract():
    p = elastic.plan_remesh(512, model_parallel=16, pod_size=256)
    assert p.devices == 512 and p.model == 16
    p = elastic.plan_remesh(507, model_parallel=16, pod_size=256)
    assert p.model == 16 and p.devices <= 507
    assert p.data * p.model * p.pods >= 16


def test_watchdog_fires_on_straggler():
    fired = []
    wd = elastic.StepWatchdog(0.05, on_straggler=fired.append)
    wd.arm(step=9)
    time.sleep(0.15)
    assert fired == [9] and wd.fired == [9]
    wd.arm(step=10)
    wd.disarm()
    time.sleep(0.1)
    assert fired == [9]
    with elastic.StepWatchdog(0.05) as wd2:
        wd2.arm(step=1)
    time.sleep(0.1)
    assert wd2.fired == []          # leaving the block cancels the timer


def test_heartbeat_survivors():
    hb = elastic.HeartbeatMonitor(4, timeout_s=0.1)
    time.sleep(0.12)
    hb.beat(1)
    hb.beat(3)
    assert hb.survivors() == [1, 3]
