"""The live tick's host side, on the CPU: what the frame kernels receive is
unchanged by the caches that save host time.

* ``frame.descriptors`` (rows built from box and uniform bytes cached by
  value) gives the bytes of a fresh structured build (below: the launch
  path's earlier code, kept here as the reference), and so does every
  launch's ``FrameParams``: on the live stack, twice (the second time from
  the caches), and on stacks of 70 and 5 sources (chained launches past 32
  sources) whose uniforms are ImageUniforms objects and packed vectors in
  turn.  CPU tensors have real ``data_ptr`` values.
* ``VideoMixer.uniforms`` (cached by value) is bit for bit what a fresh
  ``np.linalg.inv`` of each matrix packs, over an animated scene whose
  matrices change every tick, stays within ``UNIFORM_CACHE`` entries, and
  still skips a zero-size element; ``AudioMixer.gains`` likewise against a
  fresh ``channel_gains``.
* The upload barrier's cpu route shares the numpy memory and pins nothing.
"""

import numpy as np
import pytest
import torch

from swiftvideo_tpu_torch.core import EventBox, StepClock, TimePoint, Tx
from swiftvideo_tpu_torch.media import (BufferType, PixelFormat,
                                        create_picture_sample)
from swiftvideo_tpu_torch.mix import VideoMixer, video_mixer
from swiftvideo_tpu_torch.ops import (barriers, composite, frame,
                                      make_compute_context)
from swiftvideo_tpu_torch.ops.uniforms import ImageUniforms, rect_uniforms
from swiftvideo_tpu_torch.utils import matrix as m4

CPU = torch.device("cpu")
PF = PixelFormat


# --- the reference: a fresh structured build ------------------------------

def fresh_descriptors(size, sources, out_fmt):
    table = np.zeros(len(sources), frame._DESC)
    if not sources:
        return table
    ptrs, codes, dims, us = [], [], [], []
    for planes, fmt, uni in sources:
        ptrs.append([t.data_ptr() for t in planes] + [0] * (3 - len(planes)))
        codes.append(frame._SRC_CODES[fmt])
        chroma = planes[1] if len(planes) > 1 else planes[0]
        dims.append(tuple(planes[0].shape[:2]) + tuple(chroma.shape[:2]))
        us.append(np.asarray(uni.pack() if hasattr(uni, "pack") else uni,
                             np.float32))
    u = np.stack(us)
    table["plane"] = ptrs
    table["fmt"] = codes
    table["dims"] = dims
    table["box"] = frame.border_boxes(u, size, out_fmt)
    table["u"] = u
    return table


def _u8(rng, *shape):
    return torch.from_numpy(rng.integers(0, 256, shape, np.int64)
                            .astype(np.uint8))


def live_stack(w=1920, h=1080, ov_h=216):
    """The live station's stack (PERF.md, section 4): four w x h y420p
    cameras 2:1 into the quadrants at opacity 0.9, an RGBA lower third."""
    srcs = [([torch.empty(s, dtype=torch.uint8)
              for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2))],
             PF.y420p, rect_uniforms((w, h), (w, h), x=(s % 2) * w / 2,
                                     y=(s // 2) * h / 2, w=w / 2, h=h / 2,
                                     opacity=0.9))
            for s in range(4)]
    srcs.append(([torch.empty((ov_h, w, 4), dtype=torch.uint8)], PF.RGBA,
                 rect_uniforms((w, ov_h), (w, h), x=0, y=h - ov_h - 40, w=w,
                               h=ov_h)))
    return srcs


def mixed_stack(rng, n, size=(96, 64)):
    """n sources cycling through y420p, nv12, BGRA (rotated) and RGBA (fill
    and border), as ImageUniforms or packed vectors in turn."""
    cw, ch = size
    srcs = []
    for s in range(n):
        kind = s % 4
        fmt = (PF.y420p, PF.nv12, PF.BGRA, PF.RGBA)[kind]
        sw, sh = (48, 32) if kind < 2 else (24, 16)
        planes = {PF.y420p: lambda: [_u8(rng, sh, sw), _u8(rng, sh // 2, sw // 2),
                                     _u8(rng, sh // 2, sw // 2)],
                  PF.nv12: lambda: [_u8(rng, sh, sw), _u8(rng, sh // 2, sw // 2, 2)],
                  }.get(fmt, lambda: [_u8(rng, sh, sw, 4)])()
        x, y = (s * 13) % (cw - 20) - 8.25, (s * 7) % (ch - 12) - 4.5
        uni = rect_uniforms((sw, sh), size, x=x, y=y, w=30.0 + s % 7,
                            h=20.0 + s % 5, opacity=0.55 + 0.005 * s,
                            rotation=0.3 if kind == 2 else 0.0,
                            fill_color=(0.2, 0.5, 0.7, 0.6) if kind == 3
                            else (0, 0, 0, 0))
        srcs.append((planes, fmt, uni if s % 2 else uni.pack()))
    return srcs


def launches(size, sources, out_fmt, chained_target=False):
    """(FrameParams bytes, a fresh build's) of each launch
    ``composite_frame_cuda`` makes for ``sources``."""
    outs = composite.clear_planes(out_fmt, size, CPU)
    table = frame.descriptors(size, sources, out_fmt)
    fresh = fresh_descriptors(size, sources, out_fmt)
    assert table.dtype == frame._DESC and table.tobytes() == fresh.tobytes()
    return [(frame.pack_params(size, out_fmt, outs, table[a:b],
                               a > 0 or chained_target).tobytes(),
             frame.pack_params(size, out_fmt, outs, fresh[a:b],
                               a > 0 or chained_target).tobytes())
            for a, b in frame.launch_plan(len(sources))]


@pytest.mark.parametrize("out_fmt", [PF.y420p, PF.y422p, PF.nv12, PF.RGBA],
                         ids=lambda f: f.value)
def test_live_stack_params_equal_a_fresh_build(out_fmt):
    for chained in (False, True):  # the second time from the caches
        for got, want in launches((1920, 1080), live_stack(), out_fmt,
                                  chained):
            assert got == want


def test_long_stacks_equal_a_fresh_build():
    """70 sources (three launches, two chained), then 5."""
    rng = np.random.default_rng(5)
    first = launches((96, 64), mixed_stack(rng, 70), PF.y420p)
    second = launches((96, 64), mixed_stack(rng, 5), PF.nv12)
    assert (len(first), len(second)) == (3, 1)
    for got, want in first + second:
        assert got == want


def test_descriptors_of_no_sources():
    table = frame.descriptors((96, 64), [], PF.y420p)
    assert table.dtype == frame._DESC and len(table) == 0


# --- the mixer's uniforms ----------------------------------------------------

def fresh_uniforms(img, output_size) -> np.ndarray:
    return ImageUniforms(
        transform_inv=np.linalg.inv(
            img.matrix().astype(np.float64)).astype(np.float32),
        texture_inv=np.linalg.inv(
            img.texture_matrix().astype(np.float64)).astype(np.float32),
        border_inv=np.linalg.inv(
            img.border_matrix().astype(np.float64)).astype(np.float32),
        fill_color=np.asarray(img.fill_color(), np.float32),
        input_size=img.size(), output_size=output_size,
        opacity=img.opacity()).pack()


def _sample(rev, y, rect, rotation=0.0, opacity=1.0, texture=None):
    s = create_picture_sample((32, 32), PF.y420p, asset_id=rev,
                              workspace_id="w")
    s.planes()[0][:] = y
    x, yy, w, h = rect
    model = (m4.ortho(64, 64) @ m4.translation(x, yy, 0)
             @ m4.rotation_z(rotation) @ m4.scale(w, h))
    kw = dict(matrix=model, revision=rev, opacity=opacity)
    if texture is not None:
        kw["texture_matrix"] = texture
    return s.with_(**kw)


def test_cached_uniforms_bit_equal_fresh_inverse_over_an_animated_scene(
        monkeypatch):
    """Three sources over 150 ticks: one still, one moving and turning every
    tick (a new matrix each time), one cycling through four states.  Every
    uniform vector the mixer hands the composite equals a fresh inverse's
    bit for bit, and the cache never holds more than UNIFORM_CACHE."""
    clock = StepClock(TimePoint(1000, 30000))
    mixer = VideoMixer(clock, workspace_id="w", frame_duration=TimePoint(
        1000, 30000), output_size=(64, 64), output_format=PF.y420p,
        compute_context=make_compute_context("cpu"), asset_id="mix")
    frames = []
    keep = mixer >> Tx(lambda s: (frames.append(s), EventBox.just(s))[1])
    seen = []
    real = video_mixer.composite_frame

    def spy(ctx, fmt, size, sources, target=None):
        seen.append([u for _p, _f, u in sources])
        return real(ctx, fmt, size, sources, target)

    monkeypatch.setattr(video_mixer, "composite_frame", spy)
    want, sizes = [], []
    for t in range(150):
        samples = [
            _sample("still", 50, (0, 0, 32, 32), opacity=0.9),
            _sample("moving", 120, (3.25 + 0.37 * t, 7.5 - 0.11 * t, 20, 14),
                    rotation=0.01 * t, opacity=0.5 + (t % 7) / 20),
            _sample("cycling", 200, (16 + 4 * (t % 4), 16, 24, 24),
                    texture=m4.scale(1.0 + 0.25 * (t % 4), 1.0))]
        for s in samples:
            mixer.apply(EventBox.just(s))
        clock.step()
        want.append([fresh_uniforms(s, (64, 64)) for s in sorted(
            samples, key=lambda s: s.z_index())])
        sizes.append(len(mixer._uniforms))
    assert len(frames) == 150 and len(seen) == 150
    for got, ref in zip(seen, want):
        # every tick holds this tick's three sources and, from the previous
        # generation, none that a fresh one replaced (same revisions)
        assert len(got) == 3
        for g, r in zip(got, ref):
            assert g.dtype == np.float32 and not g.flags.writeable
            assert np.array_equal(g.view(np.uint32), r.view(np.uint32))
    assert max(sizes) == video_mixer.UNIFORM_CACHE
    mixer.close()
    del keep


def test_cache_hits_return_the_same_vector():
    clock = StepClock(TimePoint(1000, 30000))
    mixer = VideoMixer(clock, workspace_id="w", frame_duration=TimePoint(
        1000, 30000), output_size=(64, 64), output_format=PF.y420p,
        compute_context=make_compute_context("cpu"))
    a = mixer.uniforms(_sample("a", 1, (0, 0, 32, 32)))
    b = mixer.uniforms(_sample("a", 1, (0, 0, 32, 32)))
    c = mixer.uniforms(_sample("a", 1, (0, 0, 32, 32), opacity=0.5))
    assert a is b and c is not a and len(mixer._uniforms) == 2
    with pytest.raises(ValueError):
        a[22] = 0.0
    mixer.close()


def test_zero_size_element_still_skipped():
    """A singular source is remembered as such: every tick skips it and
    composites the rest."""
    clock = StepClock(TimePoint(1000, 30000))
    mixer = VideoMixer(clock, workspace_id="w", frame_duration=TimePoint(
        1000, 30000), output_size=(64, 64), output_format=PF.y420p,
        compute_context=make_compute_context("cpu"), asset_id="mix")
    frames = []
    keep = mixer >> Tx(lambda s: (frames.append(s), EventBox.just(s))[1])
    for _ in range(3):
        mixer.apply(EventBox.just(_sample("good", 150, (0, 0, 64, 64))))
        mixer.apply(EventBox.just(_sample("bad", 99, (0, 0, 0, 0))))
        clock.step()
    assert len(frames) == 3
    bad = _sample("bad", 99, (0, 0, 0, 0))
    assert mixer.uniforms(bad) is None
    for f in frames:
        assert abs(int(f.planes()[0][32, 32]) - 150) <= 1
    mixer.close()
    del keep


# --- the upload barrier's cpu route ------------------------------------------

def test_cpu_upload_shares_numpy_memory_and_pins_nothing():
    rng = np.random.default_rng(2)
    planes = [rng.integers(0, 256, s, np.int64).astype(np.uint8)
              for s in ((36, 64), (18, 32), (18, 32))]
    for p in planes:
        t = barriers.upload(p, CPU)
        assert t.data_ptr() == p.ctypes.data and np.shares_memory(t.numpy(), p)
        assert not t.is_pinned()
    s = create_picture_sample((64, 36), PF.y420p, asset_id="cam",
                              workspace_id="w")
    s = s.with_(img=s.img.with_buffers(planes, BufferType.cpu))
    out = barriers.GPUBarrierUpload(make_compute_context("cpu"))(s).value()
    assert out.buffer_type() == BufferType.cpu
    for t, p in zip(out.planes(), planes):
        assert isinstance(t, torch.Tensor) and not t.is_pinned()
        assert t.data_ptr() == p.ctypes.data


# --- the audio mixer's channel gains ---------------------------------------

def test_cached_gains_bit_equal_fresh_and_bounded():
    """Gains kept by transform equal a fresh ``channel_gains`` bit for bit,
    are read-only, and the table never holds more than GAIN_CACHE."""
    from swiftvideo_tpu_torch.mix import audio_mixer
    from swiftvideo_tpu_torch.ops.audio import channel_gains
    from swiftvideo_tpu_torch.utils.matrix import audio_position_gain
    clock = StepClock(TimePoint(960, 48000))
    mixer = audio_mixer.AudioMixer(clock, workspace_id="w",
                                   frame_duration=TimePoint(960, 48000),
                                   sample_rate=48000, channel_count=2)
    sizes = []
    for k in range(3 * audio_mixer.GAIN_CACHE):
        t = np.eye(3, dtype=np.float32)  # gain 0.1 + k / 50 at (x, y)
        t[0, 0] = t[1, 1] = 0.1 + k / 50
        t[0, 2], t[1, 2] = np.sin(k * 0.1), 0.3 * np.cos(k * 0.07)
        half = t.copy()  # the same first row, half the gain
        half[1, 1] *= 0.5
        for tr in (t, half, m4.identity3()):
            got = mixer.gains(tr)
            want = channel_gains(*audio_position_gain(tr), channel_count=2)
            assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
            assert not got.flags.writeable
        sizes.append(len(mixer._gains))
    assert max(sizes) == audio_mixer.GAIN_CACHE
    assert mixer.gains(m4.identity3()) is mixer.gains(m4.identity3())
    mixer.close()
