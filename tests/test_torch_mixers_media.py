"""The port's segmenter, SRC, Repeater, PictureAnimator and SoundAnimator
against the JAX package's: twins of ``tests/test_media_ops.py`` retargeted
at ``swiftvideo_tpu_torch``.

Each test keeps the JAX test's assertions on the port and, where the stage
has an output, runs the same inputs through the JAX package's stage and
requires the same output: segmented PCM, SRC counts and pts exactly (the
SRC on its host route in both packages), animator matrices and gains bit
for bit (float32 matrices built by the same host code), Repeater emissions
and clock queues exactly.
"""

import gc
from types import SimpleNamespace

import numpy as np

import swiftvideo_tpu.core as jcore
import swiftvideo_tpu.media as jmedia
import swiftvideo_tpu.mix as jmix
import swiftvideo_tpu.scene as jscene
from swiftvideo_tpu_torch import core, media, mix, scene
from swiftvideo_tpu_torch.core.time import rescale
from swiftvideo_tpu_torch.utils.matrix import audio_position_gain


def _ns(c, m, x, s):
    return SimpleNamespace(
        EventBox=c.EventBox, StepClock=c.StepClock, TimePoint=c.TimePoint,
        Tx=c.Tx, AudioFormat=m.AudioFormat, AudioSample=m.AudioSample,
        PixelFormat=m.PixelFormat, create_picture_sample=m.create_picture_sample,
        AudioPacketSegmenter=x.AudioPacketSegmenter,
        AudioSampleRateConversion=x.AudioSampleRateConversion,
        PictureAnimator=x.PictureAnimator, Repeater=x.Repeater,
        SoundAnimator=x.SoundAnimator, AspectMode=s.AspectMode,
        ElementState=s.ElementState)


PORT = _ns(core, media, mix, scene)
JAX = _ns(jcore, jmedia, jmix, jscene)
T = core.TimePoint


def _sample(pkg, buf, pts, rate=48000, channels=2, fmt="s16i", count=None,
            buffers=None):
    return pkg.AudioSample(
        buffers=buffers or (buf,), frequency=rate, channels=channels,
        format=getattr(pkg.AudioFormat, fmt),
        sample_count=count or (buf.size // channels),
        pts_value=pkg.TimePoint(pts.value, pts.scale), id_asset="a",
        id_workspace="w")


def _segment(pkg, chunks, fmt="s16i", planar=False):
    """Every segment (data, pts) of ``chunks`` through ``pkg``'s segmenter
    at 960 samples."""
    seg = pkg.AudioPacketSegmenter(pkg.TimePoint(960, 48000))
    out = []
    pts = T(0, 48000)
    for chunk in chunks:
        if planar:
            s = _sample(pkg, chunk, pts, fmt=fmt, count=chunk.size,
                        buffers=(chunk, chunk.copy()))
        else:
            s = _sample(pkg, chunk, pts, fmt=fmt)
        box = seg(s)
        if box.is_just():
            out.extend((np.array(o.data()[0]), o.number_samples(),
                        (o.pts().value, o.pts().scale)) for o in box.value())
        pts = pts + T(1024, 48000)
    return out


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert np.array_equal(x[0], y[0]) and x[1:] == y[1:]


def test_segmenter_1024_to_960():
    """audioSegmenterTests.segmenterTest: 1024-sample packets re-chunked to
    960 with sample continuity and pts 960 apart."""
    ramp = np.arange(1024 * 16 * 2, dtype=np.int16)
    chunks = [ramp[i * 2048:(i + 1) * 2048] for i in range(16)]
    out = _segment(PORT, chunks)
    _same(out, _segment(JAX, chunks))
    assert out and all(n == 960 for _d, n, _p in out)
    cat = np.concatenate([d for d, _n, _p in out])
    assert np.array_equal(cat, ramp[:cat.size])
    for (_a, _n, pa), (_b, _m, pb) in zip(out, out[1:]):
        assert T(*pb) - T(*pa) == T(960, 48000)


def test_segmenter_f64_planar():
    """8-byte planar formats re-chunk at one unit a sample."""
    ramp = np.arange(1024 * 8, dtype=np.float64)
    chunks = [ramp[i * 1024:(i + 1) * 1024] for i in range(8)]
    out = _segment(PORT, chunks, fmt="f64p", planar=True)
    _same(out, _segment(JAX, chunks, fmt="f64p", planar=True))
    assert out and all(n == 960 and d.size == 960 for d, n, _p in out)
    cat = np.concatenate([d for d, _n, _p in out])
    assert np.array_equal(cat, ramp[:cat.size])


def _src_counts(pkg):
    """(pts value, samples) of every emission of 3000 mono f32 44.1 kHz
    packets through ``pkg``'s SRC to 48 kHz stereo s16."""
    src = pkg.AudioSampleRateConversion(48000, 2, pkg.AudioFormat.s16i)
    got = []
    txn = src >> pkg.Tx(lambda s: (got.append((s.pts().value,
                                               s.pts().scale,
                                               s.number_samples())),
                                   pkg.EventBox.nothing(s.info()))[1])
    pts = pkg.TimePoint(0, 44100)
    blank = np.zeros(1024, np.float32)
    for _ in range(3000):
        txn(pkg.AudioSample(buffers=(blank,), frequency=44100, channels=1,
                            format=pkg.AudioFormat.f32p, sample_count=1024,
                            pts_value=pts, id_asset="blank",
                            id_workspace="test"))
        pts = pts + pkg.TimePoint(1024, 44100)
    return got


def test_src_bookkeeping():
    """sampleRateConversionTests.sampleCountTest: each emission's pts is the
    cumulative output count, over thousands of packets."""
    got = _src_counts(PORT)
    assert got == _src_counts(JAX)
    assert len(got) > 2900
    total = 0
    for value, scale, n in got:
        assert (value, scale) == (total, 48000)
        total += n
    assert abs(total - 3000 * 1024 * 48000 / 44100) < 1300


def test_src_passthrough():
    src = mix.AudioSampleRateConversion(48000, 2, media.AudioFormat.s16i)
    s = _sample(PORT, np.zeros(960 * 2, np.int16), T(0, 48000))
    assert src(s).value() is s


def _src_rate_change(pkg):
    src = pkg.AudioSampleRateConversion(48000, 1, pkg.AudioFormat.f32p)
    counts = []
    for rate, n in ((44100, 441), (32000, 320)):
        pts = T(0, rate)
        total = 0
        for _ in range(20):
            box = src(_sample(pkg, np.zeros(n, np.float32), pts, rate=rate,
                              channels=1, fmt="f32p", count=n))
            if box.is_just():
                total += box.value().number_samples()
            pts = pts + T(n, rate)
        counts.append(total)
    return tuple(counts), src._resampler.in_rate


def test_src_mid_stream_rate_change():
    """A mid-stream rate change rebuilds the polyphase filter at the new
    ratio."""
    (n1, n2), in_rate = _src_rate_change(PORT)
    assert ((n1, n2), in_rate) == _src_rate_change(JAX)
    assert abs(n1 - 20 * 480) < 1000
    assert in_rate == 32000
    assert abs(n2 - 20 * 480) < 1000


def _src_passthrough_segment(pkg):
    src = pkg.AudioSampleRateConversion(48000, 2, pkg.AudioFormat.s16i)
    blank441 = np.zeros(1024 * 2, np.int16)
    pts = T(0, 44100)
    for _ in range(20):
        src(_sample(pkg, blank441, pts, rate=44100))
        pts = pts + T(1024, 44100)
    r1 = src._resampler
    assert r1 is not None and src._pts is not None
    out48 = src(_sample(pkg, np.zeros(960 * 2, np.int16),
                        T(48000 * 100, 48000)))
    assert out48.is_just() and out48.value().pts().value == 48000 * 100
    assert src._resampler is None and src._pts is None
    first = None
    p = T(44100 * 200, 44100)
    for _ in range(4):
        box = src(_sample(pkg, blank441, p, rate=44100))
        if first is None and box.is_just():
            first = box.value()
        p = p + T(1024, 44100)
    assert src._resampler is not None and src._resampler is not r1
    assert first is not None
    return first.pts().value, first.number_samples()


def test_src_rate_change_through_passthrough_segment():
    """44.1k -> 48k passthrough -> 44.1k: the passthrough is a boundary; the
    third segment re-anchors its pts at its own start."""
    got = _src_passthrough_segment(PORT)
    assert got == _src_passthrough_segment(JAX)
    assert got[0] == rescale(T(44100 * 200, 44100), 48000).value


def _repeat(pkg, interval, inputs, steps_between):
    """Emissions and clock-queue lengths of a Repeater fed ``inputs``, the
    clock stepped ``steps_between`` times after each."""
    clock = pkg.StepClock(pkg.TimePoint(1000, 30000))
    rep = pkg.Repeater(clock, interval)
    got, queued = [], []
    chain = rep >> pkg.Tx(lambda s: (got.append(s), pkg.EventBox.just(s))[1])
    for x in inputs:
        chain(x)
        for _ in range(steps_between):
            clock.step()
            queued.append(len(clock._scheduled))
    return got, queued, chain, clock


def test_repeater_reemits():
    got, _q, _c, _k = _repeat(PORT, PORT.TimePoint(1000, 30000),
                              ["frame0"], 3)
    assert got == ["frame0"] * 4
    jgot, _q, _c, _k = _repeat(JAX, JAX.TimePoint(1000, 30000),
                               ["frame0"], 3)
    assert got == jgot


def test_repeater_reemits_then_switches():
    """A new sample replaces the repeated one on the next emission."""
    got, _q, chain, clock = _repeat(PORT, PORT.TimePoint(1000, 30000),
                                    ["frame0"], 3)
    chain("frame1")
    clock.step()
    assert got[-1] == "frame1"


def test_repeater_goes_dormant_after_chain_drop():
    """A dropped downstream chain stops the repeater's rescheduling."""
    clock = core.StepClock(T(1000, 30000))
    rep = mix.Repeater(clock, T(1000, 30000))
    got = []
    chain = rep >> core.Tx(lambda s: (got.append(s), core.EventBox.just(s))[1])
    chain("frame0")
    clock.step()
    assert got == ["frame0", "frame0"]
    del chain
    gc.collect()
    for _ in range(6):
        clock.step()
    assert len(clock._scheduled) == 0
    assert got == ["frame0", "frame0"]


def test_repeater_single_armed_timer():
    """One armed clock callback whatever the input rate."""
    inputs = [f"frame{i}" for i in range(100)]
    got, queued, _c, _k = _repeat(PORT, PORT.TimePoint(500, 1000), inputs, 1)
    assert max(queued) <= 1
    assert len(got) == 100
    jgot, jqueued, _c, _k = _repeat(JAX, JAX.TimePoint(500, 1000), inputs, 1)
    assert (got, queued) == (jgot, jqueued)


def _animated(pkg, canvas, states, size, steps=0, clock_step=(1, 30)):
    """(matrix, texture matrix, opacity) of a picture through ``pkg``'s
    PictureAnimator after ``states`` [(state kwargs, duration (v, s))] and
    ``steps`` clock steps."""
    clock = pkg.StepClock(pkg.TimePoint(*clock_step))
    anim = pkg.PictureAnimator(clock, canvas_size=canvas)
    for kw, dur in states:
        if "pic_aspect" in kw:  # by value: each package has its own enum
            kw = dict(kw, pic_aspect=pkg.AspectMode(kw["pic_aspect"].value))
        anim.set_state(pkg.ElementState(**kw), pkg.TimePoint(*dur))
    for _ in range(steps):
        clock.step()
    pic = pkg.create_picture_sample(size, pkg.PixelFormat.y420p,
                                    asset_id="a", workspace_id="w")
    out = anim(pic).value()
    return (np.array(out.matrix()), np.array(out.texture_matrix()),
            out.opacity())


def _same_animation(*args, **kw):
    got = _animated(PORT, *args, **kw)
    want = _animated(JAX, *args, **kw)
    assert all(np.array_equal(a, b) for a, b in zip(got[:2], want[:2]))
    assert got[2] == want[2]
    return got


def test_picture_animator_rect():
    """An element at (x, y, w, h) maps its corners to the canvas NDC."""
    m, _t, opacity = _same_animation(
        (1920, 1080), [(dict(pic_pos=(480, 270), size=(960, 540)), (0, 1000))],
        (64, 64))
    p0 = m @ np.array([0, 0, 0, 1], np.float32)
    p1 = m @ np.array([1, 1, 0, 1], np.float32)
    assert np.allclose(p0[:2], [-0.5, -0.5], atol=1e-5)
    assert np.allclose(p1[:2], [0.5, 0.5], atol=1e-5)
    assert opacity == 1.0


def test_picture_animator_transition():
    """Transitions lerp between states and complete on the clock."""
    states = [(dict(pic_pos=(0, 0), size=(10, 10)), (0, 1000)),
              (dict(pic_pos=(10, 10), size=(10, 10)), (1, 1))]
    m, _t, _o = _same_animation((100, 100), states, (8, 8), steps=1,
                                clock_step=(1, 10))
    p0 = m @ np.array([0, 0, 0, 1], np.float32)
    assert np.allclose(p0[:2], [-0.98, -0.98], atol=1e-5)
    m2, _t, _o = _same_animation((100, 100), states, (8, 8), steps=11,
                                 clock_step=(1, 10))
    p2 = m2 @ np.array([0, 0, 0, 1], np.float32)
    assert np.allclose(p2[:2], [-0.8, -0.8], atol=1e-5)
    clock = core.StepClock(T(1, 10))
    anim = mix.PictureAnimator(clock, canvas_size=(100, 100))
    anim.set_state(scene.ElementState(pic_pos=(0, 0), size=(10, 10)),
                   T(0, 1000))
    fut = anim.set_state(scene.ElementState(pic_pos=(10, 10), size=(10, 10)),
                         T(1, 1))
    for _ in range(11):
        clock.step()
    assert fut.done() and anim.next_state is None


def test_picture_animator_aspect_fit():
    """16:9 in a square element letterboxes vertically."""
    _m, tm, _o = _same_animation(
        (100, 100), [(dict(pic_pos=(0, 0), size=(100, 100),
                           pic_aspect=PORT.AspectMode.aspectFit), (0, 1000))],
        (160, 90))
    assert abs(tm[1, 1] - 0.5625) < 1e-4
    assert abs(tm[0, 0] - 1.0) < 1e-6
    assert abs(tm[1, 3] - (1 - 0.5625) / 2) < 1e-4


def test_picture_animator_aspect_fill():
    """16:9 in a square element filled: the texture overflows across (the
    element holds its middle 9/16), centred."""
    _m, tm, _o = _same_animation(
        (100, 100), [(dict(size=(100, 100),
                           pic_aspect=PORT.AspectMode.aspectFill), (0, 1000))],
        (160, 90))
    assert abs(tm[0, 0] - 16 / 9) < 1e-4 and abs(tm[1, 1] - 1.0) < 1e-6
    assert abs(tm[0, 3] - (1 - 16 / 9) / 2) < 1e-4


class LateClock:
    """current() advances; scheduled callbacks never fire."""

    def __init__(self):
        self.t = T(0, 1000)

    def current(self):
        return self.t

    def schedule(self, at, fn):
        pass


def test_picture_animator_no_overshoot_on_late_completion():
    """A sample past the transition's deadline, before its completion
    callback, holds at the target; the SoundAnimator's gain likewise."""
    clock = LateClock()
    anim = mix.PictureAnimator(clock, canvas_size=(100, 100))
    anim.set_state(scene.ElementState(pic_pos=(0, 0), size=(10, 10)),
                   T(0, 1000))
    anim.set_state(scene.ElementState(pic_pos=(50, 0), size=(10, 10)),
                   T(100, 1000))
    clock.t = T(250, 1000)
    pic = media.create_picture_sample((8, 8), media.PixelFormat.y420p,
                                      asset_id="a", workspace_id="w")
    p0 = anim(pic).value().matrix() @ np.array([0, 0, 0, 1], np.float32)
    assert np.allclose(p0[0], 0.0, atol=1e-5), p0
    sanim = mix.SoundAnimator(clock)
    sanim.set_state(scene.ElementState(audio_gain=1.0), T(0, 1000))
    sanim.set_state(scene.ElementState(audio_gain=0.5), T(100, 1000))
    clock.t = T(400, 1000)
    assert np.isclose(sanim.computed_matrix()[0, 0], 0.5)


def test_picture_animator_overlapping_transitions():
    """A second set_state supersedes the first; the first's deadline does
    not truncate the second."""
    clock = core.StepClock(T(1, 10))
    anim = mix.PictureAnimator(clock, canvas_size=(100, 100))
    anim.set_state(scene.ElementState(pic_pos=(0, 0), size=(10, 10)),
                   T(0, 1000))
    f1 = anim.set_state(scene.ElementState(pic_pos=(10, 10), size=(10, 10)),
                        T(1, 1))
    for _ in range(5):
        clock.step()
    target_c = scene.ElementState(pic_pos=(50, 50), size=(10, 10))
    f2 = anim.set_state(target_c, T(1, 1))
    for _ in range(6):
        clock.step()
    assert f1.done() and not f2.done()
    assert anim.next_state == target_c
    for _ in range(5):
        clock.step()
    assert f2.done() and anim.next_state is None
    assert anim.current_state == target_c


def _sound(pkg, gain, pos):
    clock = pkg.StepClock(pkg.TimePoint(1, 30))
    anim = pkg.SoundAnimator(clock)
    anim.set_state(pkg.ElementState(audio_gain=gain, audio_pos=pos),
                   pkg.TimePoint(0, 1000))
    s = _sample(pkg, np.zeros(64, np.int16), T(0, 48000))
    return np.array(anim(s).value().transform)


def test_sound_animator_gain_position():
    transform = _sound(PORT, 0.5, (0.25, -0.5))
    assert np.array_equal(transform, _sound(JAX, 0.5, (0.25, -0.5)))
    pos, gain = audio_position_gain(transform)
    assert abs(gain - 0.5) < 1e-6
    assert np.allclose(pos, [0.25, -0.5], atol=1e-6)


def test_sound_animator_immediate_cancels_transition():
    """An immediate set_state cancels a pending transition."""
    clock = core.StepClock(T(1, 10))
    anim = mix.SoundAnimator(clock)
    anim.set_state(scene.ElementState(audio_gain=1.0), T(0, 1000))
    anim.set_state(scene.ElementState(audio_gain=0.0), T(1, 1))
    clock.step()
    final = scene.ElementState(audio_gain=0.5)
    anim.set_state(final, T(0, 1000))
    assert anim.next_state is None and anim.transition_duration is None
    for _ in range(12):
        clock.step()
    assert anim.current_state == final


def test_hidden_and_muted_swallow_samples():
    clock = core.StepClock(T(1, 30))
    panim = mix.PictureAnimator(clock, canvas_size=(100, 100))
    panim.set_state(scene.ElementState(hidden=True), T(0, 1000))
    pic = media.create_picture_sample((8, 8), media.PixelFormat.y420p,
                                      asset_id="a", workspace_id="w")
    assert panim(pic).is_nothing()
    sanim = mix.SoundAnimator(clock)
    sanim.set_state(scene.ElementState(muted=True), T(0, 1000))
    assert sanim(_sample(PORT, np.zeros(4, np.int16),
                         T(0, 48000))).is_nothing()
