"""The audio half of the live tick, held exactly to the JAX package's.

A seeded long run (400 ticks of 10 ms) drives both packages' AudioMixer,
each asset behind its own SoundAnimator, on a StepClock, with the same
inputs: four assets of RTMP-quantised 1024-sample packets (pts in
milliseconds, jittered and out of order), 480-sample packets with pts at
90 kHz, 960-sample packets with a gap (the underrun re-anchor) and
960-sample packets behind a parent animator whose asset is removed mid-run.
An audio-gain fade with a pan runs on one animator, the mixer's delay
changes, and its frame duration is restated at another scale (the window's
end then sits at 1 kHz).  Each mixed frame's buffer, pts, constituents and
every stats sample it carries (``mix.audio.*`` with the underruns,
``audio.peak.N`` / ``audio.rms.N`` from ``audio_stats``) must equal the JAX
mixer's: the tolerance is 0.  After every tick the port's kept placements
and animator matrices are held to a fresh computation.

Also here: the one-pass peak/RMS of an interleaved buffer, bit-equal to the
per-channel float32 formula, and ``StatsReport``'s bucket index in integers
against the JAX package's TimePoint form.
"""

from types import SimpleNamespace

import numpy as np
import pytest

import swiftvideo_tpu.core as jcore
import swiftvideo_tpu.media as jmedia
import swiftvideo_tpu.mix as jmix
import swiftvideo_tpu.scene as jscene
import swiftvideo_tpu.utils.matrix as jm4
from swiftvideo_tpu.ops import audio as jaudio
from swiftvideo_tpu_torch import core, media, mix, scene
from swiftvideo_tpu_torch.ops import audio
from swiftvideo_tpu_torch.ops.registry import make_compute_context

SR = 48000
TICKS = 400
# tick at which each event of the run happens
FADE_AT, REMOVE_AT, DELAY_AT, RESTATE_AT, STILL_AT = 60, 170, 220, 260, 330


def _ns(c, m, x, s):
    return SimpleNamespace(core=c, media=m, mix=x, scene=s)


PORT = _ns(core, media, mix, scene)
JAX = _ns(jcore, jmedia, jmix, jscene)


def packets(seed: int = 7):
    """Each asset's packets as plain values, the same for both packages:
    (asset, tick it is sent before, pts value, pts scale, samples, int16
    interleaved stereo data)."""
    rng = np.random.default_rng(seed)
    out = []

    def pcm(n, amp):
        return (rng.standard_normal(2 * n) * amp).clip(
            -32768, 32767).astype(np.int16)

    # "rtmp": 1024 samples, pts truncated to ms, jittered by a ms either
    # way; a pair in about every eight arrives swapped
    rt = []
    for k in range(int(TICKS * 480 / 1024) + 2):
        ms = k * 1024 * 1000 // SR + int(rng.integers(-1, 2))
        rt.append([1 + (k * 1024 * 100) // SR, max(ms, 0), 1000, 1024,
                   pcm(1024, 6000)])
    for k in range(1, len(rt) - 1):
        if rng.random() < 0.125:
            rt[k][0], rt[k + 1][0] = rt[k + 1][0], rt[k][0]
    out += [("rtmp", *p) for p in rt]
    # "cam": 480 samples, pts at 90 kHz
    out += [("cam", k, k * 900, 90000, 480, pcm(480, 9000))
            for k in range(TICKS)]
    # "gap": 960 samples at the sample rate, silent for 12 ticks mid-run
    out += [("gap", 2 * k, 2 * k * 960, SR, 960, pcm(960, 12000))
            for k in range(TICKS // 2) if not 45 <= k < 51]
    # "guest": 960 samples, pts in ms, behind a parent animator
    out += [("guest", 2 * k + 1, 20 * k, 1000, 960, pcm(960, 30000))
            for k in range(TICKS // 2)]
    out.sort(key=lambda p: p[1])
    return out


class Run:
    """One package's mixer and animators through the long run."""

    def __init__(self, ns, *, dedup, fold):
        self.ns = ns
        TP = ns.core.TimePoint
        self.clock = ns.core.StepClock(TP(480, SR))
        self.records = []
        runner = self

        class Recording(ns.core.StatsReport):
            def add_sample(self, name, val):
                runner.records.append((name, (val.value, val.scale)
                                       if isinstance(val, TP) else val))
                super().add_sample(name, val)

        kw = {}
        if fold:
            kw = dict(compute_context=make_compute_context("cpu"),
                      device_min_elems=0)
        self.mixer = ns.mix.AudioMixer(
            self.clock, workspace_id="w", frame_duration=TP(480, SR),
            sample_rate=SR, channel_count=2, delay=TP(1920, SR),
            asset_id="live", dedup_overlap=dedup,
            stats_report=Recording(asset_id="live", clock=self.clock), **kw)
        self.out = []
        self._keep = [self.mixer >> ns.mix.audio_stats()
                      >> ns.core.Tx(self._take)]
        ES = ns.scene.ElementState
        self.parent = ns.mix.SoundAnimator(self.clock)
        self.parent.set_state(ES(audio_gain=0.5), TP(0, 1000))
        self.anims = {}
        for name, pos in (("rtmp", (0.0, 0.0)), ("cam", (-0.4, 0.0)),
                          ("gap", (0.3, 0.1)), ("guest", (0.0, 0.0))):
            anim = ns.mix.SoundAnimator(
                self.clock, parent=self.parent if name == "guest" else None)
            anim.set_state(ES(audio_pos=pos, audio_gain=0.8), TP(0, 1000))
            self.anims[name] = anim
            self._keep.append(anim >> self.mixer)

    def _take(self, sample):
        self.out.append(sample)
        return self.ns.core.EventBox.nothing(None)

    def send(self, asset, pts, scale, n, data):
        TP = self.ns.core.TimePoint
        sample = self.ns.media.AudioSample(
            buffers=(data.copy(),), frequency=SR, channels=2,
            format=self.ns.media.AudioFormat.s16i, sample_count=n,
            time_point=self.clock.current(), pts_value=TP(pts, scale),
            id_asset=asset, id_workspace="w")
        self._keep[1 + list(self.anims).index(asset)](sample)

    def event(self, tick):
        TP, ES = self.ns.core.TimePoint, self.ns.scene.ElementState
        if tick == FADE_AT:
            self.anims["cam"].set_state(
                ES(audio_gain=0.25, audio_pos=(0.7, -0.2)), TP(300, 1000))
        elif tick == REMOVE_AT:
            self.mixer.remove_asset("guest")
        elif tick == DELAY_AT:
            self.mixer.delay = TP(2400, SR)
        elif tick == RESTATE_AT:
            # the same 10 ms at 1 kHz: the window's end changes scale
            self.mixer.frame_duration = TP(10, 1000)
        elif tick == STILL_AT:
            self.anims["rtmp"].set_state(ES(audio_gain=1.2), TP(0, 1000))
            self.parent.set_state(ES(audio_gain=0.7), TP(150, 1000))


def frame_values(sample):
    return ([np.asarray(b).copy() for b in sample.data()],
            (sample.pts().value, sample.pts().scale),
            [(c.id_asset, (c.pts.value, c.pts.scale),
              (c.duration.value, c.duration.scale),
              (c.normalized_pts.value, c.normalized_pts.scale))
             for c in sample.constituents()])


def check_placements(mixer):
    """Each placement the port's mixer keeps equals a fresh TimePoint
    computation of the reference's window terms for its key."""
    TP = core.TimePoint
    for place in mixer._placed.values():
        work, offset, delay, ts_scale, end_scale = place[:5]
        duration = core.rescale(TP(work.number_samples(),
                                   work.sample_rate()), work.pts().scale)
        npts = work.pts() + offset + delay
        nend = npts + core.rescale(duration, npts.scale)
        got = [(t.value, t.scale) for t in place[5:7]] + list(place[7:])
        assert got == [(npts.value, npts.scale), (nend.value, nend.scale),
                       core.rescale(nend, ts_scale).value,
                       core.rescale(npts, ts_scale).value,
                       core.rescale(npts, end_scale).value]
    ts = mixer.pts
    assert all(p[3] == ts.scale for p in mixer._placed.values())


def check_matrices(port, jax):
    """Each port animator's matrix, kept or not, is bit-equal to the JAX
    animator's fresh T(pos) @ S(gain) at the same clock time."""
    for name in port.anims:
        a = port.anims[name].computed_matrix()
        b = jax.anims[name].computed_matrix()
        assert a.dtype == b.dtype and np.array_equal(a.view(np.uint32),
                                                     b.view(np.uint32))
        assert not a.flags.writeable
    assert np.array_equal(port.parent.computed_matrix(),
                          jax.parent.computed_matrix())


@pytest.mark.parametrize("dedup", [True, False])
@pytest.mark.parametrize("fold", [False, True], ids=["host", "cpu-fold"])
def test_long_run_equals_jax_mixer(dedup, fold):
    port = Run(PORT, dedup=dedup, fold=fold)
    jax = Run(JAX, dedup=dedup, fold=False)
    queue = packets()
    i = 0
    for tick in range(TICKS):
        for run in (port, jax):
            run.event(tick)
        while i < len(queue) and queue[i][1] <= tick:
            asset, _at, pts, scale, n, data = queue[i]
            if not (asset == "guest" and REMOVE_AT <= tick < REMOVE_AT + 8):
                for run in (port, jax):
                    run.send(asset, pts, scale, n, data)
            i += 1
        n_port, n_jax = len(port.records), len(jax.records)
        port.clock.step()
        jax.clock.step()
        assert len(port.out) == len(jax.out) == tick + 1
        a, b = frame_values(port.out[-1]), frame_values(jax.out[-1])
        assert len(a[0]) == len(b[0]) and all(
            np.array_equal(x, y) for x, y in zip(a[0], b[0])), tick
        assert a[1:] == b[1:], tick
        new_port, new_jax = port.records[n_port:], jax.records[n_jax:]
        assert [r[0] for r in new_port] == [r[0] for r in new_jax], tick
        for (name, x), (_n, y) in zip(new_port, new_jax):
            if isinstance(x, float):
                assert np.float32(x).view(np.uint32) == \
                    np.float32(y).view(np.uint32), (tick, name)
            else:
                assert x == y, (tick, name)
        check_placements(port.mixer)
        check_matrices(port, jax)
    names = [r[0] for r in port.records]
    # every branch the run is built to reach was reached
    assert names.count("mix.audio.underrun") >= 2
    assert {"audio.peak.0", "audio.rms.1"} <= set(names)
    assert any(len(s.constituents()) == 4 for s in port.out)
    assert any(np.any(s.data()[0]) for s in port.out[RESTATE_AT:])
    port.mixer.close()
    jax.mixer.close()


def test_placement_kept_while_its_key_stands():
    """A queued sample is placed once while its asset's offset, the delay
    and the window's scales stand, and placed again when one changes."""
    TP = core.TimePoint
    clock = core.StepClock(TP(480, SR))
    mixer = mix.AudioMixer(clock, workspace_id="w",
                           frame_duration=TP(480, SR), sample_rate=SR,
                           channel_count=2, delay=TP(1920, SR))
    calls = []
    place = mixer._place

    def counted(*args):
        calls.append(args[0])
        return place(*args)

    mixer._place = counted
    pcm = np.ones(1920, np.int16)
    for k in range(6):
        mixer(media.AudioSample(
            buffers=(pcm,), frequency=SR, channels=2,
            format=media.AudioFormat.s16i, sample_count=960,
            pts_value=TP(960 * k, SR), id_asset="a", id_workspace="w"))
    clock.step()
    assert len(calls) == 6
    clock.step()
    assert len(calls) == 6            # all kept
    mixer.delay = TP(1920, SR)         # equal value, a new object
    clock.step()
    assert len(calls) == 6 + len(mixer._placed)
    n = len(calls)
    mixer.frame_duration = TP(10, 1000)
    clock.step()
    assert len(calls) == n + len(mixer._placed)
    mixer.close()


def test_tick_constants_follow_the_frame_duration():
    """A mixer whose frame duration changes mid-run mixes windows of the new
    length from then on, exactly as the JAX mixer does."""
    rng = np.random.default_rng(5)
    pcm = [rng.integers(-9000, 9000, 960).astype(np.int16) for _ in range(40)]
    outs = []
    for ns in (PORT, JAX):
        TP = ns.core.TimePoint
        clock = ns.core.StepClock(TP(480, SR))
        mixer = ns.mix.AudioMixer(clock, workspace_id="w",
                                  frame_duration=TP(480, SR), sample_rate=SR,
                                  channel_count=2)
        got = []

        def take(sample, got=got, ns=ns):
            got.append(frame_values(sample))
            return ns.core.EventBox.nothing(None)

        keep = mixer >> ns.core.Tx(take)
        for k in range(40):
            if k == 12:
                mixer.frame_duration = TP(960, SR)
            mixer(ns.media.AudioSample(
                buffers=(pcm[k],), frequency=SR, channels=2,
                format=ns.media.AudioFormat.s16i, sample_count=480,
                pts_value=TP(480 * k, SR), id_asset="a", id_workspace="w"))
            clock.step()
        mixer.close()
        del keep
        outs.append(got)
    port, jax = outs
    assert len(port) == len(jax) and {len(f[0][0]) for f in port} == {960,
                                                                      1920}
    for (da, *ra), (db, *rb) in zip(port, jax):
        assert all(np.array_equal(x, y) for x, y in zip(da, db)) and ra == rb


def test_sound_matrix_kept_and_renewed():
    """The element matrix is one read-only object while no transition runs,
    a new one on each tick of a fade and after each set_state, and always
    bit-equal to a fresh T(pos) @ S(gain)."""
    TP = core.TimePoint
    clock = core.StepClock(TP(10, 1000))
    anim = mix.SoundAnimator(clock)
    anim.set_state(scene.ElementState(audio_gain=0.6, audio_pos=(0.2, 0.1)),
                   TP(0, 1000))
    first = anim.computed_matrix()
    assert anim.computed_matrix() is first and not first.flags.writeable
    fresh = jm4.translation3(0.2, 0.1) @ jm4.scale3(0.6)
    assert np.array_equal(first, fresh)
    anim.set_state(scene.ElementState(audio_gain=0.2, audio_pos=(-0.5, 0.0)),
                   TP(40, 1000))
    seen = []
    for _ in range(6):
        clock.step()
        seen.append(anim.computed_matrix())
    assert len({id(m) for m in seen[:3]}) == 3       # a fade: fresh each time
    assert seen[-1] is anim.computed_matrix()         # settled: kept
    assert np.array_equal(seen[-1], jm4.translation3(-0.5, 0.0)
                          @ jm4.scale3(0.2))
    anim.set_state(scene.ElementState(audio_gain=0.6, audio_pos=(0.2, 0.1)),
                   TP(0, 1000))
    assert anim.computed_matrix() is not first
    assert np.array_equal(anim.computed_matrix(), first)
    # a state put in place without set_state is followed too
    anim.current_state = scene.ElementState(audio_gain=0.9)
    assert np.array_equal(anim.computed_matrix(), jm4.scale3(0.9))


def _interleaved(rng, kind, n, channels):
    if kind == "random":
        return rng.integers(-32768, 32768, n * channels).astype(np.int16)
    if kind == "min":
        return np.full(n * channels, -32768, np.int16)
    if kind == "extremes":
        return np.where(rng.random(n * channels) < 0.5, -32768,
                        32767).astype(np.int16)
    return (rng.standard_normal(n * channels) * 3000).clip(
        -32768, 32767).astype(np.int16)


@pytest.mark.parametrize("channels", [1, 2, 6])
def test_peak_rms_one_pass_bit_equal(channels):
    """The one-pass peak and RMS of an interleaved buffer equal the JAX
    package's per-channel float32 formula bit for bit, on random buffers, on
    -32768 throughout and at both extremes, at sizes around the reduction's
    blocks, and leave the input as it was."""
    rng = np.random.default_rng(channels)
    sizes = [1, 2, 7, 8, 9, 127, 128, 129, 480, 960, 1024, 4097, 8193, 20000]
    for n in sizes:
        for kind in ("random", "min", "extremes", "speech"):
            buf = _interleaved(rng, kind, n, channels)
            before = buf.copy()
            ours = audio.audio_peak_rms((buf,), "s16i", channels)
            theirs = jaudio.audio_peak_rms((buf,), "s16i", channels)
            assert np.array_equal(buf, before)
            for a, b in zip(ours, theirs):
                assert np.array_equal(a.view(np.uint32), b.view(np.uint32)), \
                    (n, kind)
    for fmt, buf in (("f32i", rng.uniform(-1, 1, 960 * channels)
                      .astype(np.float32)),
                     ("s16i", np.zeros(0, np.int16)),
                     ("s16i", np.arange(2 * channels + 1, dtype=np.int16))):
        before = buf.copy()
        ours = audio.audio_peak_rms((buf,), fmt, channels)
        theirs = jaudio.audio_peak_rms((buf,), fmt, channels)
        assert np.array_equal(buf, before)
        for a, b in zip(ours, theirs):
            assert np.array_equal(a.view(np.uint32), b.view(np.uint32))


def test_bucket_index_equals_timepoint_form():
    """StatsReport's bucket index kept in integers per scale equals the JAX
    package's TimePoint form at every scale a run meets, and follows an
    epoch replaced by ``merging``."""
    rng = np.random.default_rng(3)

    def reports(ns):
        clock = ns.StepClock(ns.TimePoint(1000, 30000))
        for _ in range(7):
            clock.step()
        a = ns.StatsReport(period=ns.TimePoint(5000, 1000), clock=clock)
        b = ns.StatsReport(period=ns.TimePoint(3, 2), clock=ns.StepClock(
            ns.TimePoint(1, 1)))
        return [a, b, b.merging(a), a.merging(b)]

    port, jax = reports(core), reports(jcore)
    for _ in range(400):
        scale = int(rng.choice([1000, 30000, 48000, 90000, 100000, 7, 1]))
        value = int(rng.integers(-10 ** 9, 10 ** 12))
        for p, j in zip(port, jax):
            assert p._bucket_index(core.TimePoint(value, scale)) == \
                j._bucket_index(jcore.TimePoint(value, scale)), (value, scale)
    for p, j in zip(port, jax):
        p._epoch = core.TimePoint(123457, 48000)
        j._epoch = jcore.TimePoint(123457, 48000)
        for value in (0, 5, 10 ** 7, -(10 ** 7)):
            for scale in (48000, 1000):
                assert p._bucket_index(core.TimePoint(value, scale)) == \
                    j._bucket_index(jcore.TimePoint(value, scale))
