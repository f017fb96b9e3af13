"""The mixing wall's audio mix (``ops/audio.py::mix_wall_s16_cuda``, kernel
``csrc/audio_mix.cu``) on the CPU.

* The plain version (``mix_wall_s16_torch``) is the wall's formula: gain,
  float32 sum over the streams, trunc, s16 clamp, on random s16 audio with
  unity, power-of-two and zero gains and with saturating sums; every sum
  there is an exact float32 integer, so it also equals the exact sum.
* The kernel's order, emulated in float32 (stream 0 first, each product
  and add rounded on its own), equals the plain version wherever every sum
  is exact, and tells orders apart where a sum is not.
* The routes: a wall on a ``cuda`` device with the C library stubbed (its
  tensors CPU tensors that report the card) makes one launch a tick with
  the audio's, the kept gains' and the output's pointers, the streams, the
  samples, the card and the current stream's handle, no plain call, and
  counts its mix and its kernel mix; the stubbed launch, run as the kernel
  runs, gives the plain mix.  A CPU wall and a rank-split wall take the
  plain path and launch nothing.
* The kernel mix is counted where the kernel launched; a CPU wall keeps
  the lenient inputs it took before the kernel; a card wall makes explicit
  gains float32 on the card after its cell launches.
* The wrapper raises on a wrong dtype, shape, device or layout, and
  launches nothing for no samples.
"""

import ctypes

import numpy as np
import pytest
import torch

from swiftvideo_tpu_torch.core import spans
from swiftvideo_tpu_torch.ops import audio as audio_ops
from swiftvideo_tpu_torch.ops import frame
from swiftvideo_tpu_torch.parallel import MixingWall
from swiftvideo_tpu_torch.parallel import wall as wall_mod
from wall_audio_cases import EXACT_KINDS, case as _case

STREAM = (32, 16)


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself on the card (cuda:0), so that a
    process without a card takes the card's route."""

    @property
    def device(self):
        return torch.device("cuda", 0)

    @property
    def is_cuda(self):
        return True


def _formula(audio, gains):
    """The wall's mix as the port wrote it before the kernel."""
    total = torch.sum(audio.to(torch.float32) * gains[:, None], dim=0)
    return torch.clamp(torch.trunc(total), -32768, 32767).to(torch.int16)


@pytest.mark.parametrize("kind", EXACT_KINDS)
def test_plain_version_is_the_walls_formula(kind):
    audio, gains = _case(kind)
    got = audio_ops.mix_wall_s16_torch(audio, gains)
    assert got.dtype == torch.int16 and got.shape == (1600,)
    assert torch.equal(got, _formula(audio, gains))
    exact = np.clip(np.trunc((audio.numpy().astype(np.float64)
                              * gains.numpy()[:, None]).sum(0)), -32768, 32767)
    assert np.array_equal(got.numpy(), exact)
    if kind == "saturating":
        assert set(got.tolist()) == {-32768, 32767}
    # the wrapper takes the plain version for CPU tensors
    assert torch.equal(audio_ops.mix_wall_s16_cuda(audio, gains), got)


@pytest.mark.parametrize("kind", EXACT_KINDS)
def test_kernel_order_equals_plain_where_every_sum_is_exact(kind):
    audio, gains = _case(kind, seed=1)
    assert torch.equal(audio_ops.mix_wall_s16_in_order(audio, gains),
                       audio_ops.mix_wall_s16_torch(audio, gains))


def test_kernel_order_tells_orders_apart():
    """2**24 + 1 rounds back to 2**24 in float32: stream 0 first gives 0,
    the reverse order 1."""
    audio = torch.tensor([[16384], [1], [-16384]], dtype=torch.int16)
    gains = torch.tensor([1024.0, 1.0, 1024.0])
    in_order = audio_ops.mix_wall_s16_in_order
    assert in_order(audio, gains).tolist() == [0]
    assert in_order(audio.flip(0), gains.flip(0)).tolist() == [1]


class _Lib:
    """The C library's stand-in: records each launch and runs it as the
    kernel does, on the CPU memory its pointers hold."""

    def __init__(self):
        self.calls = []

    def sv_wall_audio(self, audio, gains, out, streams, samples, device,
                      stream):
        self.calls.append((audio, gains, out, streams, samples, device,
                           stream))
        a = np.ctypeslib.as_array((ctypes.c_int16 * (streams * samples))
                                  .from_address(audio)).reshape(streams,
                                                                samples)
        g = np.ctypeslib.as_array((ctypes.c_float * streams)
                                  .from_address(gains))
        mixed = audio_ops.mix_wall_s16_in_order(
            torch.from_numpy(a.copy()), torch.from_numpy(g.copy())).numpy()
        ctypes.memmove(out, mixed.ctypes.data, mixed.nbytes)
        return 0


def _no_plain(*args, **kwargs):
    raise AssertionError("the plain version ran on the card's route")


@pytest.fixture
def card(monkeypatch):
    """A process that believes it has a card: walls default to cuda:0, the
    C library is ``_Lib``, the current stream's handle is 0x5eed, and a
    ``torch.empty`` on the card is a CPU tensor that reports the card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 0x5eed, raising=False)
    empty = torch.empty

    def card_empty(*shape, device=None, **kwargs):
        if device is not None and torch.device(device).type == "cuda":
            return empty(*shape, **kwargs).as_subclass(_OnCard)
        return empty(*shape, device=device, **kwargs)

    monkeypatch.setattr(torch, "empty", card_empty)
    lib = _Lib()
    monkeypatch.setattr(audio_ops, "build", lambda: lib)
    return lib


def _cells(cell_size, planes, fmt, uniforms, *, grid=None):
    """The cell launch's stand-in: blank canvas planes of the grid."""
    (w, h), (cols, rows) = cell_size, grid
    return [torch.zeros((rows * ph, cols * pw), dtype=torch.uint8)
            for ph, pw in ((h, w), (h // 2, w // 2), (h // 2, w // 2))]


def _frames(n):
    sw, sh = STREAM
    return (torch.zeros((n, sh, sw), dtype=torch.uint8),
            torch.zeros((n, sh // 2, sw // 2), dtype=torch.uint8),
            torch.zeros((n, sh // 2, sw // 2), dtype=torch.uint8))


@pytest.mark.parametrize("n,samples,canvas", [
    (16, 16, (64, 32)), (64, 1600, (128, 64)), (5, 13, (96, 32))],
    ids=["16 x 16", "64 x 1600", "5 x 13"])
def test_card_wall_makes_one_audio_launch_a_tick(card, monkeypatch, n,
                                                 samples, canvas):
    monkeypatch.setattr(frame, "composite_cells_cuda", _cells)
    monkeypatch.setattr(audio_ops, "mix_wall_s16_torch", _no_plain)
    monkeypatch.setattr(wall_mod, "wall_sum_f32", _no_plain)
    wall = MixingWall(n_streams=n, stream_size=STREAM, canvas_size=canvas,
                      audio_samples=samples, channels=1)
    assert wall.device == torch.device("cuda", 0) and wall.group is None
    audio, gains = _case("power of two", n, samples, seed=n)
    audio = audio.as_subclass(_OnCard)
    # the wall's kept gains, already float32 on the card
    wall.__dict__["_gains"] = kept = gains.as_subclass(_OnCard)
    launches = audio_ops.launches
    spans.start()
    try:
        mixed = wall.step(*_frames(n), audio)[3]
    finally:
        rec = spans.stop()
    assert audio_ops.launches == launches + 1
    assert card.calls == [(audio.data_ptr(), kept.data_ptr(),
                           mixed.data_ptr(), n, samples, 0, 0x5eed)]
    assert mixed.is_cuda and mixed.dtype == torch.int16
    assert mixed.shape == (samples,)
    assert torch.equal(mixed.as_subclass(torch.Tensor),
                       _formula(audio.as_subclass(torch.Tensor), gains))
    assert rec.counters["wall.audio_mixes"] == 1
    assert rec.counters["wall.audio_kernel_mixes"] == 1


def _launched(*args, **kwargs):
    raise AssertionError("the wall's mix kernel was built or launched")


def test_cpu_wall_takes_the_plain_path(monkeypatch):
    monkeypatch.setattr(audio_ops, "build", _launched)
    wall = MixingWall(n_streams=4, stream_size=STREAM, canvas_size=(64, 32),
                      audio_samples=8, device="cpu")
    audio, gains = _case("power of two", 4, 16, seed=4)
    launches = audio_ops.launches
    spans.start()
    try:
        mixed = wall.step(*_frames(4), audio, gains,
                          uniforms=wall.default_uniforms())[3]
    finally:
        rec = spans.stop()
    assert audio_ops.launches == launches
    assert torch.equal(mixed, _formula(audio, gains))
    assert rec.counters["wall.audio_mixes"] == 1
    assert "wall.audio_kernel_mixes" not in rec.counters


def test_rank_split_wall_takes_the_plain_path(card, monkeypatch):
    """A rank of a group on the card: its float32 partial sum goes through
    the all_reduce (here doubled, as two equal ranks would add it) before
    the trunc and clamp; no launch."""
    monkeypatch.setattr(audio_ops, "build", _launched)
    monkeypatch.setattr(wall_mod.dist, "get_world_size", lambda g: 2)
    monkeypatch.setattr(wall_mod.dist, "get_rank", lambda g: 0)
    reduced = []

    def all_reduce(total, group):
        reduced.append(total.dtype)
        total.mul_(2)

    monkeypatch.setattr(wall_mod.dist, "all_reduce", all_reduce)
    wall = MixingWall(n_streams=8, stream_size=STREAM, canvas_size=(64, 32),
                      grid=(4, 2), audio_samples=8, group=object())
    assert wall.device.type == "cuda" and wall.local == 4
    audio, gains = _case("zero", 4, 16, seed=5)
    # the wall's kept gains, float32 on the card
    wall.__dict__["_gains"] = gains.as_subclass(_OnCard)
    launches = audio_ops.launches
    spans.start()
    try:
        mixed = wall._mix_audio(audio.as_subclass(_OnCard))
    finally:
        rec = spans.stop()
    assert audio_ops.launches == launches and reduced == [torch.float32]
    assert torch.equal(mixed.as_subclass(torch.Tensor),
                       _formula(torch.cat([audio, audio]),
                                torch.cat([gains, gains])))
    assert rec.counters["wall.audio_mixes"] == 1
    assert "wall.audio_kernel_mixes" not in rec.counters


def test_kernel_mix_is_counted_only_where_the_kernel_launched(card,
                                                               monkeypatch):
    """A card mix that returns without a launch counts a mix and no kernel
    mix: the count follows the wrapper's launches, not where the output
    lives."""
    wall = MixingWall(n_streams=4, stream_size=STREAM, canvas_size=(64, 32),
                      audio_samples=8, channels=1)
    audio, gains = _case("unity", 4, 8)
    wall.__dict__["_gains"] = gains.as_subclass(_OnCard)
    monkeypatch.setattr(audio_ops, "mix_wall_s16_cuda", lambda a, g: (
        audio_ops.mix_wall_s16_torch(a.as_subclass(torch.Tensor),
                                     g.as_subclass(torch.Tensor))
        .as_subclass(_OnCard)))
    spans.start()
    try:
        mixed = wall._mix_audio(audio.as_subclass(_OnCard))
    finally:
        rec = spans.stop()
    assert mixed.is_cuda and card.calls == []
    assert rec.counters["wall.audio_mixes"] == 1
    assert "wall.audio_kernel_mixes" not in rec.counters


@pytest.mark.parametrize("how", ["int32 audio", "strided audio",
                                 "gains a list", "float64 gains"])
def test_cpu_wall_keeps_its_lenient_inputs(monkeypatch, how):
    """A CPU wall mixes what it mixed before the kernel: any integer audio
    and any layout, gains of any float type or a list."""
    monkeypatch.setattr(audio_ops, "build", _launched)
    wall = MixingWall(n_streams=4, stream_size=STREAM, canvas_size=(64, 32),
                      audio_samples=8, device="cpu")
    audio, gains = _case("power of two", 4, 32, seed=6)
    want = _formula(audio[:, ::2], gains)
    audio, gains = {
        "int32 audio": (audio[:, ::2].int(), gains),
        "strided audio": (audio[:, ::2], gains),
        "gains a list": (audio[:, ::2].contiguous(), gains.tolist()),
        "float64 gains": (audio[:, ::2].contiguous(), gains.double()),
    }[how]
    assert torch.equal(wall.step(*_frames(4), audio, gains)[3], want)


def test_card_wall_converts_explicit_gains_after_the_cells(card,
                                                          monkeypatch):
    """Explicit host gains on a card wall are made float32 on the card only
    once the cell launches are made, then take the kernel."""
    order = []

    def cells(*args, **kwargs):
        order.append("cells")
        return _cells(*args, **kwargs)

    as_tensor = torch.as_tensor

    def tracked(data, *args, **kwargs):
        order.append("gains")
        out = as_tensor(data, *args, **{**kwargs, "device": "cpu"})
        return out.as_subclass(_OnCard)

    monkeypatch.setattr(frame, "composite_cells_cuda", cells)
    monkeypatch.setattr(wall_mod.torch, "as_tensor", tracked)
    wall = MixingWall(n_streams=4, stream_size=STREAM, canvas_size=(64, 32),
                      audio_samples=8, channels=1)
    audio, gains = _case("power of two", 4, 8, seed=7)
    mixed = wall.step(*_frames(4), audio.as_subclass(_OnCard),
                      gains.numpy())[3]
    assert order == ["cells", "gains"] and len(card.calls) == 1
    assert torch.equal(mixed.as_subclass(torch.Tensor),
                       _formula(audio, gains))


def test_wrapper_launches_nothing_for_no_samples(card):
    audio, gains = _case("unity", 4, 0)
    launches = audio_ops.launches
    mixed = audio_ops.mix_wall_s16_cuda(audio.as_subclass(_OnCard),
                                        gains.as_subclass(_OnCard))
    assert mixed.shape == (0,) and mixed.dtype == torch.int16
    assert audio_ops.launches == launches and card.calls == []


def _bad(case):
    audio, gains = _case("unity", 4, 16)
    on_card = audio.as_subclass(_OnCard)
    return {
        "int32 audio": (audio.int(), gains),
        "float64 gains": (audio, gains.double()),
        "gains a list": (audio, gains.tolist()),
        "1-D audio": (audio[0], gains[:1]),
        "gains too short": (audio, gains[:3]),
        "2-D gains": (audio, gains[:, None]),
        "strided audio": (audio[:, ::2], gains),
        "strided gains": (audio, torch.ones(8)[::2]),
        "gains off the card": (on_card, gains),
        "meta tensors": (audio.to("meta"), gains.to("meta")),
    }[case]


@pytest.mark.parametrize("case", [
    "int32 audio", "float64 gains", "gains a list", "1-D audio",
    "gains too short", "2-D gains", "strided audio", "strided gains",
    "gains off the card", "meta tensors"])
def test_wrapper_refuses_bad_inputs(card, case):
    audio, gains = _bad(case)
    with pytest.raises((TypeError, ValueError)):
        audio_ops.mix_wall_s16_cuda(audio, gains)
    assert card.calls == []
