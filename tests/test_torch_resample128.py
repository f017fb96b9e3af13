"""The SRC stage (``mix/src_audio.py`` over ``ops/resample.py``) against the
benchmark's plain reference (``svbench/reference/resample.py``), on both
of the resampler's routes: the host route, and the device route with its
product run by torch on the CPU (``use_device=True, device="cpu"``).

Four seeded stereo streams a case, as f32p (a decoder's planar float, with
peaks past full scale so the s16 clip runs) and as s16i, fed in AAC's
1024-sample frames, in ragged frames, across a ``flush()`` and across a
mid-stream rate change.  Every emitted sample's count and pts are exact;
its s16 samples within 1 LSB (the two sides sum the same 24 float32
products in different orders, so the rounding can flip at a half LSB).
"""

import numpy as np
import pytest
import torch

from swiftvideo_tpu_torch.core import TimePoint
from swiftvideo_tpu_torch.media.audio import AudioFormat, AudioSample
from swiftvideo_tpu_torch.mix.src_audio import AudioSampleRateConversion

from svbench.reference import resample as ref

SEED = 2**31 + 24
STREAMS, CHANNELS, OUT = 4, 2, 48000

# (input rate, frame sizes) segments; "flush" flushes the stage there
FEEDS = {
    "aac frames": [(44100, [1024] * 12)],
    "ragged": [(44100, [7, 441, 2048, 7, 7, 441, 2048, 1024, 3])],
    "flush": [(44100, [1024] * 4 + [441]), "flush", (44100, [1024] * 3)],
    "rate change": [(44100, [1024] * 4 + [7]), (32000, [1024, 441, 2048])],
}


def _signal(rng, n):
    """[2, n] float32: two tones and noise near -12 dBFS, with a few
    samples past full scale."""
    t = np.arange(n) / 44100.0
    x = np.stack([0.2 * np.sin(2 * np.pi * f * t + rng.uniform(0, 6.3))
                  + 0.15 * np.sin(2 * np.pi * 3.7 * f * t)
                  for f in rng.uniform(80, 9000, CHANNELS)])
    x += 0.02 * rng.standard_normal(x.shape)
    x[:, rng.integers(0, n, 8)] = rng.choice([-1.3, 1.3], (CHANNELS, 8))
    return x.astype(np.float32)


def _buffers(x, fmt):
    """[C, n] float32 (multiples of 1 / 32768 for s16i) as ``fmt``'s
    buffers."""
    if fmt == AudioFormat.s16i:
        return (np.rint(x * 32768).astype(np.int16).T.reshape(-1),)
    return tuple(np.ascontiguousarray(c) for c in x)


def _stream(seed, fmt, feed):
    """A stream's segments: (rate, sizes, input [C, n] float32 as the stage
    reads it, input pts), and flush markers."""
    rng = np.random.default_rng(seed)
    pts = int(rng.integers(0, 2**31))
    out = []
    for seg in feed:
        if seg == "flush":
            out.append(seg)
            continue
        rate, sizes = seg
        x = _signal(rng, sum(sizes))
        if fmt == AudioFormat.s16i:
            x = np.rint(np.clip(x, -1, 1) * 32767).astype(np.float32) / 32768
        out.append((rate, sizes, x, pts))
        pts += sum(sizes)
    return out


def _run_stage(stage, segments, fmt):
    """Every emitted sample: (count, pts value, pts scale, s16 samples)."""
    got = []
    for seg in segments:
        if seg == "flush":
            got += [(s.number_samples(), s.pts().value, s.pts().scale,
                     s.data()[0]) for s in stage.flush()]
            continue
        rate, sizes, x, pts = seg
        at = 0
        for n in sizes:
            sample = AudioSample(
                buffers=_buffers(x[:, at:at + n], fmt), frequency=rate,
                channels=CHANNELS, format=fmt, sample_count=n,
                pts_value=TimePoint(pts + at, rate), id_asset="mic",
                id_workspace="w")
            out = stage(sample).value()
            if out is not None:
                got.append((out.number_samples(), out.pts().value,
                            out.pts().scale, out.data()[0]))
            at += n
    return got


def _expected(segments):
    """The reference's emitted samples for the same feed: a rate change
    starts a fresh filter on the running pts, a flush drains one window of
    zeros and the next sample anchors the pts anew."""
    want, pts, last = [], None, None
    for seg in segments:
        if seg == "flush":
            rate, fed, x = last
            d = ref.design(rate, OUT)
            n0 = ref.emitted(d, fed)
            n1 = ref.emitted(d, fed + ref.flush_samples(d))
            if n1 > n0:
                want.append((n1 - n0, pts, ref.to_s16(ref.outputs(
                    d, torch.from_numpy(x), n0, n1))))
            pts = last = None
            continue
        rate, sizes, x, first = seg
        d = ref.design(rate, OUT)
        if pts is None:
            pts = ref.first_pts(first, rate, OUT)
        fed = 0
        for n in sizes:
            n0, n1 = ref.emitted(d, fed), ref.emitted(d, fed + n)
            fed += n
            if n1 > n0:
                want.append((n1 - n0, pts, ref.to_s16(ref.outputs(
                    d, torch.from_numpy(x), n0, n1))))
                pts += n1 - n0
        last = (rate, fed, x)
    return want


ROUTES = {"host": {}, "device route": {"use_device": True, "device": "cpu"}}


@pytest.mark.parametrize("feed", sorted(FEEDS))
@pytest.mark.parametrize("fmt", [AudioFormat.f32p, AudioFormat.s16i])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_stage_against_the_reference(route, fmt, feed):
    for k in range(STREAMS):
        segments = _stream(SEED + k, fmt, FEEDS[feed])
        stage = AudioSampleRateConversion(OUT, CHANNELS, AudioFormat.s16i,
                                          **ROUTES[route])
        got = _run_stage(stage, segments, fmt)
        want = _expected(segments)
        assert [(c, p, s) for c, p, s, _ in got] == \
            [(c, p, OUT) for c, p, _ in want]
        for (_c, _p, _s, pcm), (_c2, _p2, expect) in zip(got, want):
            assert pcm.dtype == np.int16
            assert int(np.abs(pcm.astype(np.int32)
                              - expect.numpy().astype(np.int32)).max()) <= 1


def test_aac_frames_emit_six_or_seven_cycles():
    """44.1 to 48 kHz in 1024-sample frames: 960 or 1120 samples a frame
    (six or seven cycles of 160), 1024 · 160 / 147 on average."""
    d = ref.design(44100, OUT)
    counts = [ref.emitted(d, 1024 * (k + 1)) - ref.emitted(d, 1024 * k)
              for k in range(147)]
    assert set(counts) == {960, 1120}
    assert sum(counts) == ref.emitted(d, 147 * 1024) == 1024 * 160


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_f32p_and_s16i_of_one_signal_agree(route):
    """The decoder's planar float and interleaved s16 of the same signal
    give the same counts, pts and samples."""
    seg = _stream(SEED, AudioFormat.s16i, FEEDS["ragged"])
    outs = [_run_stage(AudioSampleRateConversion(
        OUT, CHANNELS, AudioFormat.s16i, **ROUTES[route]), seg, fmt)
        for fmt in (AudioFormat.f32p, AudioFormat.s16i)]
    assert [o[:3] for o in outs[0]] == [o[:3] for o in outs[1]]
    assert all(np.array_equal(a[3], b[3]) for a, b in zip(*outs))
