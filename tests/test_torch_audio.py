"""The port's saturating s16 folds (aligned, windowed, batched) against the
host loop and the JAX package's device folds, and the resampler's and the
SRC stage's device routes against the JAX package's, on the CPU.
Tolerance: exact equality for the folds (integer arithmetic), the
polyphase design and the SRC bookkeeping; < 1e-4 for resampled float32
audio.  Cases follow tests/test_audio_ops.py."""

import numpy as np
import pytest
import torch

from swiftvideo_tpu.core import TimePoint as JaxTimePoint
from swiftvideo_tpu.media.audio import AudioFormat as JaxAudioFormat
from swiftvideo_tpu.media.audio import AudioSample as JaxAudioSample
from swiftvideo_tpu.mix.src_audio import AudioSampleRateConversion as JaxSRC
from swiftvideo_tpu.ops import audio as jax_audio
from swiftvideo_tpu.ops import resample as jax_resample
from swiftvideo_tpu_torch import interop
from swiftvideo_tpu_torch.media.audio import AudioFormat
from swiftvideo_tpu_torch.mix.src_audio import AudioSampleRateConversion
from swiftvideo_tpu_torch.ops import audio, registry, resample


def _host_fold(sources, gains, base):
    out = base.copy()
    for s in range(sources.shape[0]):
        audio.apply_mix_s16(sources[s], gains[s], out)
    return out


def test_fold_basic_trunc_toward_zero():
    inp = torch.tensor([[100, -100, 32000, -32000, 1, 2, 3, 4]],
                       dtype=torch.int16)
    out = audio.mix_s16_device(inp, [[1.0, 0.5]])
    assert out.tolist() == [100, -50, 32000, -16000, 1, 1, 3, 2]


@pytest.mark.parametrize("level", [30000, -30000])
def test_fold_saturates(level):
    inp = torch.full((1, 4), level, dtype=torch.int16)
    base = torch.full((4,), level, dtype=torch.int16)
    out = audio.mix_s16_device(inp, [[1.0]], base=base)
    assert out.tolist() == [32767 if level > 0 else -32768] * 4


@pytest.mark.parametrize("seed", [7, 8, 9])
def test_fold_matches_host_and_jax(seed):
    rng = np.random.default_rng(seed)
    sources = rng.integers(-32768, 32767, (4, 960 * 2),
                           np.int64).astype(np.int16)
    gains = rng.uniform(0.0, 1.2, (4, 2)).astype(np.float32)
    base = rng.integers(-32768, 32767, 960 * 2, np.int64).astype(np.int16)
    ours = audio.mix_s16_device(torch.from_numpy(sources), gains,
                                base=torch.from_numpy(base)).numpy()
    assert np.array_equal(ours, _host_fold(sources, gains, base))
    theirs = np.asarray(jax_audio.mix_s16_device(sources, gains, base=base))
    assert np.array_equal(ours, theirs)


def test_fold_zero_base_matches_host():
    rng = np.random.default_rng(12)
    sources = rng.integers(-32768, 32767, (6, 64), np.int64).astype(np.int16)
    gains = rng.uniform(0.0, 1.5, (6, 3)).astype(np.float32)
    ours = audio.mix_s16_device(torch.from_numpy(sources), gains).numpy()
    assert np.array_equal(ours, _host_fold(sources, gains,
                                           np.zeros(64, np.int16)))


@pytest.mark.parametrize("trial", range(12))
def test_windowed_matches_host_and_jax(trial):
    """Offset/partial-window contributions with saturation interleaving
    and odd backing offsets that shift the gain phase (the cases of
    tests/test_audio_ops.py::test_device_mix_windowed_matches_host)."""
    rng = np.random.default_rng(1100 + trial)
    window = 960 * 2
    n_src = int(rng.integers(1, 6))
    host = rng.integers(-32768, 32767, window, np.int64).astype(np.int16)
    contribs = []
    for _ in range(n_src):
        size = int(rng.integers(8, 2400))
        data = rng.integers(-32768, 32767, size, np.int64).astype(np.int16)
        if trial % 2:
            data = (data.astype(np.int32) | 0x4000).astype(np.int16)
        g = rng.uniform(0.0, 1.5, 2).astype(np.float32)
        contribs.append((data, g, int(rng.integers(0, window - 1)),
                         int(rng.integers(0, size - 1))))
    expect = host.copy()
    for data, g, b_off, i_off in contribs:
        audio.apply_mix_s16(data, g, expect, backing_start=b_off,
                            input_start=i_off)
    inputs = np.zeros((n_src, window), np.int16)
    starts = np.zeros(n_src, np.int32)
    ends = np.zeros(n_src, np.int32)
    gains = np.stack([g for _d, g, _b, _i in contribs])
    for k, (data, _g, b_off, i_off) in enumerate(contribs):
        n = min(window - b_off, data.size - i_off)
        inputs[k, b_off:b_off + n] = data[i_off:i_off + n]
        starts[k], ends[k] = b_off, b_off + n
    ours = audio.mix_s16_device_windowed(
        torch.from_numpy(inputs), gains, starts, ends,
        base=torch.from_numpy(host)).numpy()
    assert np.array_equal(ours, expect)
    theirs = np.asarray(jax_audio.mix_s16_device_windowed(
        inputs, gains, starts, ends, base=host))
    assert np.array_equal(ours, theirs)


def test_fold_rejects_non_int16():
    with pytest.raises(TypeError):
        audio.mix_s16_device(torch.zeros(2, 8, dtype=torch.int32), [[1.0]])
    with pytest.raises(TypeError):
        audio.mix_s16_device(np.zeros((2, 8), np.int16), [[1.0]])


@pytest.mark.parametrize("fmt,channels", [("s16i", 2), ("s16p", 2),
                                          ("f32i", 1)])
def test_host_helpers_match_jax(fmt, channels):
    rng = np.random.default_rng(4)
    if fmt.startswith("s16"):
        bufs = [rng.integers(-32768, 32767, 480 * (1 if fmt.endswith("p")
                                                   else channels),
                             np.int64).astype(np.int16)
                for _ in range(channels if fmt.endswith("p") else 1)]
    else:
        bufs = [rng.uniform(-1, 1, 480 * channels).astype(np.float32)]
    for a, b in zip(audio.audio_peak_rms(bufs, fmt, channels),
                    jax_audio.audio_peak_rms(bufs, fmt, channels)):
        assert np.array_equal(a, b)
    for pos in ((0.0, 0.0), (0.7, -0.2)):
        assert np.array_equal(audio.channel_gains(pos, 0.8, channels),
                              jax_audio.channel_gains(pos, 0.8, channels))


# --- batched fold (ops/audio.py: mix_s16_device_batched) ------------------

@pytest.mark.parametrize("seed", [20, 21, 22])
def test_batched_fold_matches_host_and_jax(seed):
    """[B, S, n] x [B, S, C] -> [B, n]: every stream is its own ordered
    fold; exact against the host loop and the JAX package."""
    rng = np.random.default_rng(seed)
    b, s, n, c = 4, 5, 96, int(rng.integers(1, 4))
    sources = rng.integers(-32768, 32767, (b, s, n), np.int64).astype(np.int16)
    gains = rng.uniform(0.0, 1.5, (b, s, c)).astype(np.float32)
    base = rng.integers(-32768, 32767, (b, n), np.int64).astype(np.int16)
    ours = audio.mix_s16_device_batched(torch.from_numpy(sources), gains,
                                        base=torch.from_numpy(base)).numpy()
    assert ours.shape == (b, n) and ours.dtype == np.int16
    for k in range(b):
        assert np.array_equal(ours[k], _host_fold(sources[k], gains[k],
                                                  base[k]))
    theirs = np.asarray(jax_audio.mix_s16_device_batched(sources, gains,
                                                         base=base))
    assert np.array_equal(ours, theirs)


@pytest.mark.parametrize("level", [30000, -30000])
def test_batched_fold_saturates_per_stream(level):
    """Stream 0 saturates, stream 1 cancels back from the rail: the clamp
    after every source makes the order matter, per stream."""
    sources = np.array([[[level] * 4, [level] * 4, [-level] * 4],
                        [[level] * 4, [-level] * 4, [level] * 4]], np.int16)
    gains = np.ones((2, 3, 2), np.float32)
    ours = audio.mix_s16_device_batched(torch.from_numpy(sources),
                                        gains).numpy()
    rail = 32767 if level > 0 else -32768
    assert ours[0].tolist() == [rail - level] * 4
    assert ours[1].tolist() == [level] * 4
    theirs = np.asarray(jax_audio.mix_s16_device_batched(sources, gains))
    assert np.array_equal(ours, theirs)


def test_batched_fold_zero_base_and_rejects():
    rng = np.random.default_rng(3)
    sources = rng.integers(-1000, 1000, (3, 2, 64), np.int64).astype(np.int16)
    gains = np.ones((3, 2, 2), np.float32)
    ours = audio.mix_s16_device_batched(torch.from_numpy(sources),
                                        gains).numpy()
    theirs = np.asarray(jax_audio.mix_s16_device_batched(sources, gains))
    assert np.array_equal(ours, theirs)
    with pytest.raises(TypeError):
        audio.mix_s16_device_batched(torch.from_numpy(sources[0]), gains[0])
    with pytest.raises(TypeError):
        audio.mix_s16_device_batched(torch.from_numpy(sources).int(), gains)


# --- the resampler's device route (ops/resample.py) -----------------------

@pytest.mark.parametrize("rates,taps", [((44100, 48000), 24),
                                        ((48000, 44100), 24),
                                        ((48000, 16000), 16),
                                        ((22050, 48000), 32)])
def test_polyphase_design_bit_equal_jax(rates, taps):
    ours = resample.design_polyphase(*rates, taps)
    theirs = jax_resample.design_polyphase(*rates, taps)
    assert ours[0].dtype == theirs[0].dtype
    assert np.array_equal(ours[0], theirs[0])
    assert ours[1:] == theirs[1:]


# tolerance of the device route against the JAX device route: the JAX
# package's own bound between its device and host routes
# (tests/test_audio_ops.py::test_resampler_device_matches_numpy)
RESAMPLE_TOL = 1e-4


@pytest.mark.parametrize("rates,channels", [((44100, 48000), 2),
                                            ((48000, 44100), 3),
                                            ((32000, 48000), 1)])
def test_device_route_matches_jax_device_route(rates, channels):
    """Several ``process`` calls of uneven lengths (shorter than one window,
    odd, long): equal output counts call by call, and < 1e-4 apart."""
    rng = np.random.default_rng(sum(rates) + channels)
    ours = resample.PolyphaseResampler(*rates, channels, use_device=True,
                                       device="cpu")
    theirs = jax_resample.PolyphaseResampler(*rates, channels,
                                             use_device=True)
    host = resample.PolyphaseResampler(*rates, channels)
    assert ours.device == torch.device("cpu")
    total = 0
    for n in (5, 100, 1, 4099, 0, 777, 3000):
        x = rng.standard_normal((channels, n)).astype(np.float32)
        a, b, h = ours.process(x), theirs.process(x), host.process(x)
        assert isinstance(a, np.ndarray) and a.dtype == np.float32
        assert a.shape == b.shape == h.shape
        if a.size:
            assert np.abs(a - np.asarray(b)).max() < RESAMPLE_TOL
            assert np.abs(a - h).max() < RESAMPLE_TOL
        total += a.shape[1]
    assert total > 0
    assert (ours._state.base, ours._state.next_cycle) == \
        (theirs._state.base, theirs._state.next_cycle)
    assert ours._state.buffer.shape == theirs._state.buffer.shape


def test_device_route_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(registry.ComputeError, match="deviceNotAvailable"):
        resample.PolyphaseResampler(44100, 48000, 2, use_device=True)
    with pytest.raises(registry.ComputeError, match="deviceNotAvailable"):
        AudioSampleRateConversion(48000, 2, AudioFormat.s16i,
                                  use_device=True)
    assert resample.PolyphaseResampler(44100, 48000, 2).device is None


def _jax_s16_sample(rng, n, pts, rate=44100, channels=2):
    pcm = rng.integers(-20000, 20000, n * channels, np.int64).astype(np.int16)
    return JaxAudioSample(buffers=(pcm,), frequency=rate, channels=channels,
                          format=JaxAudioFormat.s16i, sample_count=n,
                          pts_value=pts, id_asset="mic", id_workspace="w")


def test_src_device_route_bookkeeping_matches_jax():
    """``AudioSampleRateConversion(use_device=True)``: every emitted sample's
    pts and count equal the JAX stage's exactly, through a flush; the PCM
    within 1 LSB (s16 ``rint`` of two float32 routes < 1e-4 apart)."""
    rng = np.random.default_rng(31)
    ours = AudioSampleRateConversion(48000, 2, AudioFormat.s16i,
                                     use_device=True, device="cpu")
    theirs = JaxSRC(48000, 2, JaxAudioFormat.s16i, use_device=True)
    got, want = [], []
    pts = JaxTimePoint(1234, 44100)
    for n in (1024, 17, 441, 2048, 5, 999):
        jax_sample = _jax_s16_sample(rng, n, pts)
        pts = pts + JaxTimePoint(n, 44100)
        a = ours(interop.audio_sample(jax_sample))
        b = theirs(jax_sample)
        assert (a.value() is None) == (b.value() is None)
        got += [a.value()] if a.value() is not None else []
        want += [b.value()] if b.value() is not None else []
    got += ours.flush()
    want += theirs.flush()
    assert len(got) == len(want) > 3
    for a, b in zip(got, want):
        assert a.number_samples() == b.number_samples()
        assert (a.pts().value, a.pts().scale) == (b.pts().value, b.pts().scale)
        assert np.abs(a.data()[0].astype(int)
                      - np.asarray(b.data()[0]).astype(int)).max() <= 1
