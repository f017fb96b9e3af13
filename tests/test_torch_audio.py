"""The port's saturating s16 folds against the host loop and the JAX
package's device folds, on the CPU.  Tolerance: exact equality (the fold
is integer arithmetic).  Cases follow tests/test_audio_ops.py."""

import numpy as np
import pytest
import torch

from swiftvideo_tpu.ops import audio as jax_audio
from swiftvideo_tpu_torch.ops import audio


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
