"""Twins of ``tests/test_clock.py``: each case of the JAX package's clock
tests runs on both packages' ``core`` (StepClock determinism, WallClock
scheduling and its unix-time round trip), with the same assertions.  The
deadline-order case is twinned in ``tests/test_torch_core.py``
(``test_step_clock_runs_events_in_time_order``)."""

import time
from types import SimpleNamespace

import pytest

import swiftvideo_tpu.core as jcore
import swiftvideo_tpu_torch.core as pcore

PACKAGES = {"jax": jcore, "port": pcore}


@pytest.fixture(params=sorted(PACKAGES))
def c(request):
    ns = PACKAGES[request.param]
    return SimpleNamespace(StepClock=ns.StepClock, TP=ns.TimePoint,
                           WallClock=ns.WallClock)


def test_stepclock_advances(c):
    clock = c.StepClock(c.TP(1000, 30000))
    assert clock.current() == c.TP(0, 100000)
    clock.step()
    assert clock.current() == c.TP(1000, 30000)


def test_stepclock_schedule_future_and_past(c):
    clock = c.StepClock(c.TP(1, 10))
    fired = []
    clock.schedule(c.TP(3, 10), lambda e: fired.append(e.time()))
    clock.step()  # t=1/10
    assert fired == []
    clock.step()  # t=2/10
    assert fired == []
    clock.step()  # t=3/10
    assert fired == [c.TP(3, 10)]
    # past deadline fires synchronously
    clock.schedule(c.TP(1, 10), lambda e: fired.append(e.time()))
    assert len(fired) == 2


def test_stepclock_reschedule_from_callback(c):
    """The mixer pattern: callbacks re-schedule themselves each tick."""
    clock = c.StepClock(c.TP(1, 10))
    ticks = []

    def cb(e):
        ticks.append(e.time())
        clock.schedule(e.time() + c.TP(1, 10), cb)

    clock.schedule(c.TP(1, 10), cb)
    for _ in range(5):
        clock.step()
    assert len(ticks) == 5


def test_wallclock_schedule(c):
    clock = c.WallClock()
    fired = []
    clock.schedule(clock.current() + c.TP(20, 1000),
                   lambda e: fired.append(1))
    clock.schedule(clock.current(), lambda e: fired.append(0))
    deadline = time.time() + 2.0
    while len(fired) < 2 and time.time() < deadline:
        time.sleep(0.005)
    assert sorted(fired) == [0, 1]
    clock.close()


def test_wallclock_unix_roundtrip(c):
    clock = c.WallClock(epoch=1000.0)
    tp = clock.from_unix_time(100100000)  # 1001.0s unix at scale 100000
    assert abs(tp.value / tp.scale - 1.0) < 1e-6
    assert clock.to_unix_time(tp) == 100100000
