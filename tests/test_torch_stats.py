"""Twins of ``tests/test_stats.py``: each case of the JAX package's
StatsReport tests runs on both packages' ``core`` with the same assertions
(the reference's exact JSON summary, the timer round trip, and reports held
weakly by their clock tick)."""

import gc
import weakref

import pytest

import swiftvideo_tpu.core as jcore
import swiftvideo_tpu_torch.core as pcore

PACKAGES = {"jax": jcore, "port": pcore}


@pytest.fixture(params=sorted(PACKAGES))
def c(request):
    return PACKAGES[request.param]


def test_stats_exact_json(c):
    clock = c.StepClock(step_size=c.TimePoint(1000, 30000))
    stats = c.StatsReport(period=c.TimePoint(5000 * 30, 1000 * 30),
                          clock=clock)
    while clock.current() <= c.TimePoint(10000 * 30, 1000 * 30):
        stats.add_sample("test", 1)
        clock.step()
    report = stats.report()
    expected = ('{ "name": "test", "period": 5.00, "type": "int", "median": 1, '
                '"mean": 1.00000, "peak": 1, "low": 1, "total": 150,\n'
                '  "averagePerSecond": 30.00000, "count": 150 }')
    assert report is not None
    assert report.results["test.5.00"] == expected


def test_timer_roundtrip(c):
    """Timers produce TimePoint samples; the recompute two periods later
    reports them (reference recompute picks bucket index(now)-2,
    stats.swift:212)."""
    clock = c.StepClock(step_size=c.TimePoint(1000, 1000))
    stats = c.StatsReport(period=c.TimePoint(5000, 1000), clock=clock)
    # one 1s-long timer per step for two full periods
    while clock.current() <= c.TimePoint(10000, 1000):
        stats.start_timer("op")
        clock.step()
        stats.end_timer("op")
    rep = stats.report()
    assert rep is not None
    assert any(k.startswith("op.") for k in rep.results)
    assert '"type": "time"' in rep.results["op.5.00"]


def test_stats_report_collectable_and_closable(c):
    """Reports are created per connection and per merging() call; the
    clock tick must hold them WEAKLY (a strong bound-method ref made
    every report an immortal self-rescheduling timer) and close() stops
    the cadence."""
    clock = c.StepClock(c.TimePoint(1000, 1000))
    report = c.StatsReport(asset_id="a", period=c.TimePoint(2000, 1000),
                           clock=clock)
    ref = weakref.ref(report)
    del report
    gc.collect()
    assert ref() is None                  # collectable despite the tick
    for _ in range(4):
        clock.step()                      # dead tick no-ops and drains
    assert len(clock._scheduled) == 0
    # close() stops rescheduling for a live report
    report2 = c.StatsReport(asset_id="b", period=c.TimePoint(2000, 1000),
                            clock=clock)
    report2.close()
    for _ in range(6):
        clock.step()
    assert len(clock._scheduled) == 0
