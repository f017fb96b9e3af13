"""Twins of ``tests/test_timepoint.py``: each case of the JAX package's
rational-time tests runs on both packages' ``core.time``, the port's copy
and the JAX package's, with the same assertions (the reference's
timePointTests plus the int64 wrap-around and truncation edges)."""

from types import SimpleNamespace

import pytest

import swiftvideo_tpu.core as jcore
import swiftvideo_tpu.core.time as jtime
import swiftvideo_tpu_torch.core as pcore
import swiftvideo_tpu_torch.core.time as ptime

PACKAGES = {"jax": SimpleNamespace(core=jcore, time=jtime),
            "port": SimpleNamespace(core=pcore, time=ptime)}


@pytest.fixture(params=sorted(PACKAGES))
def t(request):
    ns = PACKAGES[request.param]
    return SimpleNamespace(TP=ns.core.TimePoint, rescale=ns.core.rescale,
                           minimum=ns.core.minimum, maximum=ns.core.maximum,
                           seconds=ns.core.seconds, simplify=ns.core.simplify,
                           tdiv=ns.time._tdiv, wrap64=ns.time._wrap64)


def test_rescale(t):
    a = t.TP(2987595, 30000)
    b = t.TP(9958650, 100000)
    assert t.rescale(a, b.scale).value == b.value


def test_comparisons(t):
    a = t.TP(2987595, 30000)
    b = t.TP(9955317, 100000)
    assert (a > b) is True
    assert (b > a) is False
    assert (b < a) is True
    assert (a < b) is False
    assert (a >= b) is True
    assert (b >= a) is False
    assert (b <= a) is True
    assert (a <= b) is False


def test_add(t):
    a = t.TP(2987595, 30000)
    b = t.TP(9955317, 100000)
    c = b + t.TP(1000, 30000)
    assert a <= c and a >= c


def test_sub(t):
    a = t.TP(2957595, 30000)
    b = t.TP(9855316, 100000)
    c = a - t.TP(1000, 30000)
    assert c >= b and c <= b


def test_min_max(t):
    a = t.TP(2957595, 30000)
    b = t.TP(9855316, 100000)
    assert t.minimum(a, b) == b
    assert t.maximum(a, b) == a


def test_mod_and_div(t):
    a = t.TP(1001, 1000)
    assert (a % t.TP(1000, 1000)).value == 1
    assert (a / 2).value == 500
    # C-style truncation toward zero on negatives
    assert (t.TP(-3, 1000) / 2).value == -1
    assert t.tdiv(-7, 2) == -3
    assert t.tdiv(7, -2) == -3


def test_wraparound(t):
    near_max = t.TP((1 << 63) - 1, 1000)
    wrapped = near_max + t.TP(1, 1000)
    assert wrapped.value == -(1 << 63)
    assert t.wrap64(1 << 63) == -(1 << 63)


def test_simplify_seconds(t):
    assert t.simplify(t.TP(1000, 30000)) == t.TP(1, 30)
    assert abs(t.seconds(t.TP(1, 2)) - 0.5) < 1e-12


def test_negative_pts_window_math(t):
    # the audio mixer relies on exact negative-delta rescaling
    frame = t.TP(480, 48000)
    pts = t.TP(-100, 48000)
    delta = pts - t.TP(0, 48000)
    assert t.rescale(delta, 48000).value == -100
    assert (frame * 2).value == 960
