"""The port's AudioMixer against the JAX package's: twins of
``tests/test_audio_mixer.py`` retargeted at ``swiftvideo_tpu_torch``.

Each scenario runs through both packages' mixers on the same inputs (a
StepClock, 1024-sample packets mixed into 960-sample frames, seeded late
packets).  The port keeps the JAX tests' own assertions, and its mixed
frames, pts and provenance must equal the JAX mixer's exactly: the s16
fold is an integer contract (tolerance 0).  On a ``"cpu"`` context with
the device gate open, the port's torch folds must equal its host loop
exactly.
"""

from types import SimpleNamespace
from unittest import mock

import numpy as np
import pytest

import swiftvideo_tpu.core as jcore
import swiftvideo_tpu.media as jmedia
import swiftvideo_tpu.mix as jmix
from swiftvideo_tpu_torch import core, media, mix
from swiftvideo_tpu_torch.mix import audio_mixer as am_mod
from swiftvideo_tpu_torch.ops.registry import make_compute_context

SR = 48000


def _ns(c, m, x):
    return SimpleNamespace(EventBox=c.EventBox, StepClock=c.StepClock,
                           TimePoint=c.TimePoint, Tx=c.Tx,
                           AudioFormat=m.AudioFormat, AudioSample=m.AudioSample,
                           AudioMixer=x.AudioMixer)


PORT = _ns(core, media, mix)
JAX = _ns(jcore, jmedia, jmix)


def make_sine(idx: int, count: int, freq: int, rate: int,
              amplitude: float = 1.0) -> np.ndarray:
    """audioMixTests.swift:237-247 (trunc-toward-zero int16 conversion)."""
    i = np.arange(idx, idx + count, dtype=np.float32)
    val = np.sin(i * np.float32(2 * np.pi) * freq / rate) * 32767 * amplitude
    return np.trunc(val).astype(np.int16)


def interleave_stereo(mono: np.ndarray) -> np.ndarray:
    out = np.empty(mono.size * 2, np.int16)
    out[0::2] = mono
    out[1::2] = mono
    return out


def similarity(a: np.ndarray, b: np.ndarray) -> float:
    """Byte-level similarity ratio (audioMixTests.swift:387-396)."""
    ab, bb = a.tobytes(), b.tobytes()
    n = min(len(ab), len(bb))
    if n == 0:
        return 1.0
    return float((np.frombuffer(ab[:n], np.uint8)
                  == np.frombuffer(bb[:n], np.uint8)).sum()) / n


def run_mixer(pkg, buffers, *, packet=1024, delay=0, late_prob=0.0,
              seconds=60.0, asset="src", seed=1234, transform=None,
              **mixer_kw):
    """The audioMixTests runner in ``pkg``: packets of ``packet`` samples
    cycled from ``buffers`` into a 960-sample mixer (``delay`` samples),
    each packet late by 1.5 packets with probability ``late_prob`` (seeded).
    ``transform(k)``, where given, is packet k's 3x3 audio transform.
    Returns [(data, pts (value, scale), clock (value, scale) at emit,
    constituent assets)] of every mixed frame."""
    T = pkg.TimePoint
    frame = T(960, SR)
    clock = pkg.StepClock(step_size=frame)
    mixer = pkg.AudioMixer(clock, workspace_id="test", frame_duration=frame,
                           sample_rate=SR, channel_count=2,
                           delay=T(delay, SR), **mixer_kw)
    out = []

    def receiver(sample):
        out.append((np.array(sample.data()[0]),
                    (sample.pts().value, sample.pts().scale),
                    (clock.current().value, clock.current().scale),
                    [c.id_asset for c in sample.constituents()]))
        return pkg.EventBox.nothing(None)

    keep = mixer >> pkg.Tx(receiver)
    rng = np.random.default_rng(seed)
    state = {"push": 0}

    def recur(evt_time):
        buf = buffers[state["push"] % len(buffers)]
        extra = {} if transform is None else {
            "transform": transform(state["push"])}
        state["push"] += 1
        mixer.apply(pkg.EventBox.just(pkg.AudioSample(
            buffers=(buf,), frequency=SR, channels=2,
            format=pkg.AudioFormat.s16i, sample_count=packet,
            time_point=clock.current(), pts_value=evt_time, id_asset=asset,
            id_workspace="test", **extra)))
        late = rng.integers(0, 1000) < int(1000 * late_prob)
        nxt = evt_time + T(packet, SR) + (T(packet, SR) / 2 * 3 if late
                                          else T(0, SR))
        clock.schedule(nxt, lambda e: recur(e.time()))

    clock.schedule(T(0, SR), lambda e: recur(e.time()))
    end = T(int(seconds * 1000), 1000)
    while clock.current() < end:
        clock.step()
    mixer.close()
    del keep
    return out


def assert_same_mix(port_out, jax_out):
    """Every mixed frame of the port equals the JAX mixer's exactly: data,
    pts, emit time and constituents."""
    assert len(port_out) == len(jax_out)
    for (d, p, c, a), (jd, jp, jc, ja) in zip(port_out, jax_out):
        assert np.array_equal(d, jd)
        assert (p, c, a) == (jp, jc, ja)


def both(buffers, **kw):
    port_out = run_mixer(PORT, buffers, **kw)
    assert_same_mix(port_out, run_mixer(JAX, buffers, **kw))
    return port_out


def sine_buffers(amplitude=1.0, second_harmonic=False):
    """15 packets (lcm(1024, 960) / 1024) of a 50 Hz sine, and the 960-sample
    frame it must reproduce."""
    bufs = []
    for index in range(15):
        wave = make_sine(index * 1024, 1024, 50, SR, amplitude)
        if second_harmonic:
            wave = wave + make_sine(index * 1024, 1024, 100, SR, amplitude)
        bufs.append(interleave_stereo(wave))
    ref = make_sine(0, 960, 50, SR, amplitude)
    if second_harmonic:
        ref = ref + make_sine(0, 960, 100, SR, amplitude)
    return bufs, interleave_stereo(ref)


def test_silence():
    """audioMixTests.silenceTest: zero in, zero out, pts == the tick."""
    out = both([np.zeros(1024 * 2, np.int16)])
    assert len(out) > 2900
    for data, pts, now, _assets in out:
        assert data.shape == (960 * 2,) and not data.any()
        assert PORT.TimePoint(*pts) == PORT.TimePoint(*now)


@pytest.mark.parametrize("case", ["single", "two", "delay"])
def test_sine(case):
    """audioMixTests single / two-sine / delay: the 50 Hz sine (plus its
    second harmonic) comes back frame-exact, pts behind the clock by the
    mixer's delay (40 ms in the delay case)."""
    harmonic = case == "two"
    delay = 1920 if case == "delay" else 0
    bufs, ref = sine_buffers(0.5 if harmonic else 1.0, harmonic)
    out = both(bufs, delay=delay)
    checked = 0
    for k, (data, pts, now, _a) in enumerate(out):
        if k == 0 or not pts[0] > 960:
            continue
        assert similarity(ref, data) > 0.9
        assert PORT.TimePoint(*pts) == (PORT.TimePoint(*now)
                                        - PORT.TimePoint(delay, SR))
        checked += 1
    assert checked > 2800


def test_discontinuity_recovery():
    """audioMixTests.discontinuityTest: 1 % late packets; the mixer
    re-anchors and keeps its cadence, most frames at the sine's energy."""
    bufs, ref = sine_buffers()
    rms_ref = float(np.sqrt(np.mean(ref.astype(np.float64) ** 2)))
    out = both(bufs, late_prob=0.01, asset="sine")
    assert len(out) > 2900
    healthy = sum(
        abs(float(np.sqrt(np.mean(d.astype(np.float64) ** 2))) - rms_ref)
        < rms_ref * 0.2 for d, _p, _c, _a in out)
    assert all(d.shape == (960 * 2,) for d, _p, _c, _a in out)
    assert healthy > len(out) * 0.8


def test_constituents_provenance():
    """Mixed output names the assets that contributed
    (mix.audio.swift:189-199)."""
    out = both([np.ones(1024 * 2, np.int16)], seconds=2.0, asset="srcA")
    seen = [a for _d, _p, _c, a in out if a]
    assert seen and all(ids == ["srcA"] for ids in seen)


def moving(k):
    """Packet k's transform: a source moving and fading in, a new position
    and gain every packet (the mixer's gain table overflows)."""
    t = np.eye(3, dtype=np.float32)
    g = np.float32(0.2 + 0.8 * min(k, 150) / 150)
    t[0, 0] = t[1, 1] = g
    t[0, 2] = np.float32(np.sin(k * 0.05))
    t[1, 2] = np.float32(0.25 * np.cos(k * 0.03))
    return t


@pytest.mark.parametrize("packet", [960, 1024])
def test_moving_fading_source(packet):
    """A source whose position and gain change every packet mixes exactly as
    the JAX mixer mixes it, frame for frame."""
    bufs, _ref = sine_buffers()
    out = both(bufs, packet=packet, seconds=3.0, transform=moving)
    assert len(out) > 140

    def rms(k):
        return float(np.sqrt(np.mean(out[k][0].astype(np.float64) ** 2)))

    assert rms(-1) > 2 * rms(5) > 0  # faded in


def apply_host_fail(*a, **k):
    raise AssertionError("host loop used on a tick the device gate takes")


@pytest.mark.parametrize("packet", [960, 1024])
def test_device_mix_parity_exact(packet):
    """With a ``"cpu"`` compute context and the gate open, aligned ticks
    (960-sample packets) take ``mix_s16_device`` and unaligned ones (1024)
    ``mix_s16_device_windowed``, never the host loop, and equal the host
    loop's mix exactly.  The port's mixer imports both folds by name, so
    the spies patch the mixer module's names."""
    chunks = [interleave_stereo(make_sine(k * packet, packet, 600, SR, 0.5))
              for k in range(200)]
    name = "mix_s16_device" if packet == 960 else "mix_s16_device_windowed"
    real = getattr(am_mod, name)
    calls = []

    def spy(inputs, *args, **kw):
        calls.append(tuple(inputs.shape))
        return real(inputs, *args, **kw)

    kw = dict(packet=packet, seconds=2.0)
    with mock.patch.object(am_mod, "apply_mix_s16", apply_host_fail), \
            mock.patch.object(am_mod, name, spy):
        dev = run_mixer(PORT, chunks, compute_context=make_compute_context(
            "cpu"), device_min_elems=0, **kw)
    host = run_mixer(PORT, chunks, **kw)
    assert calls, f"{name} never engaged"
    assert_same_mix(dev, host)
    assert_same_mix(host, run_mixer(JAX, chunks, **kw))


def _asample(pts, count=960, asset="src"):
    return media.AudioSample(
        buffers=(interleave_stereo(np.ones(count, np.int16) * 100),),
        frequency=SR, channels=2, format=media.AudioFormat.s16i,
        sample_count=count, id_asset=asset, id_workspace="t", pts_value=pts)


def _mixer(**kw):
    frame = core.TimePoint(960, SR)
    clock = core.StepClock(step_size=frame)
    return clock, mix.AudioMixer(clock, workspace_id="t", frame_duration=frame,
                                 sample_rate=SR, channel_count=2, **kw)


def test_closed_mixer_drops_incoming():
    """After close() the digest refuses samples (gone)."""
    clock, mixer = _mixer()
    box = mixer.apply(core.EventBox.just(_asample(core.TimePoint(0, SR))))
    assert not box.is_gone()
    mixer.close()
    for i in range(5):
        box = mixer.apply(core.EventBox.just(
            _asample(core.TimePoint(960 * (i + 1), SR))))
        assert box.is_gone()
    with mixer._lock:
        assert sum(len(q) for q in mixer._samples.values()) == 1


def test_unanchored_leftovers_dropped():
    """Samples whose offset a discontinuity popped are dropped on the next
    tick; a fresh sample re-anchors and mixes again."""
    clock, mixer = _mixer()
    mixer.apply(core.EventBox.just(_asample(core.TimePoint(0, SR))))
    mixer.apply(core.EventBox.just(_asample(core.TimePoint(960 * 50, SR))))
    mixer.discontinuity("src")
    clock.step()
    with mixer._lock:
        assert sum(len(q) for q in mixer._samples.values()) == 0
    outs = []
    chain = mixer >> core.Tx(lambda s: (outs.append(s),
                                        core.EventBox.just(s))[1])
    mixer.apply(core.EventBox.just(_asample(
        clock.current() + core.TimePoint(960, SR) * 2)))
    for _ in range(6):
        clock.step()
    assert any(s.constituents() for s in outs)
    mixer.close()
    del chain


def test_remove_asset_racing_tick_stays_removed():
    """remove_asset() between a tick's snapshot and its write-back is not
    undone by the write-back."""
    clock, mixer = _mixer()
    mixer.apply(core.EventBox.just(_asample(core.TimePoint(0, SR))))
    mixer.apply(core.EventBox.just(_asample(core.TimePoint(960 * 50, SR))))
    real_run_mix = mixer._run_mix

    def race(contribs, backing):
        mixer.remove_asset("src")
        return real_run_mix(contribs, backing)

    mixer._run_mix = race
    clock.step()
    with mixer._lock:
        assert "src" not in mixer._samples
    mixer.close()


def ms_quantized_mix(pkg, dedup: bool) -> np.ndarray:
    """Constant 1024-sample packets whose pts are floored to milliseconds
    (the FLV timeline) through ``pkg``'s mixer; the mono mix."""
    T = pkg.TimePoint
    clock = pkg.StepClock(step_size=T(960, SR))
    mixer = pkg.AudioMixer(clock, workspace_id="test",
                           frame_duration=T(960, SR), sample_rate=SR,
                           channel_count=2, dedup_overlap=dedup)
    frames = []
    keep = mixer >> pkg.Tx(lambda s: (frames.append(np.array(s.buffers[0])),
                                      pkg.EventBox.just(s))[1])
    data = np.full(1024 * 2, 100, np.int16)
    for i in range(60):
        mixer.apply(pkg.EventBox.just(pkg.AudioSample(
            buffers=(data,), frequency=SR, channels=2,
            format=pkg.AudioFormat.s16i, sample_count=1024,
            time_point=clock.current(),
            pts_value=T((i * 1024 * 1000) // SR, 1000), id_asset="cam",
            id_workspace="w")))
        clock.step()
    for _ in range(10):
        clock.step()
    del keep
    return np.concatenate(frames)[0::2]


@pytest.mark.parametrize("dedup", [True, False])
def test_overlap_dedup(dedup):
    """ms-quantized seams: the default (dedup) never mixes a span twice; the
    compatibility mode reproduces the reference's doubling
    (mix.audio.swift:142-153).  Equal to the JAX mixer either way."""
    mono = ms_quantized_mix(PORT, dedup)
    assert np.array_equal(mono, ms_quantized_mix(JAX, dedup))
    if dedup:
        steady = mono[960 * 4:60 * 1024 - 2048]
        assert set(np.unique(steady)) <= {0, 100}
        assert (steady == 100).mean() > 0.95
    else:
        steady = mono[960 * 4:]
        assert (steady == 200).sum() > 0
        assert set(np.unique(steady)) <= {0, 100, 200}
