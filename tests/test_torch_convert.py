"""The port's RGBA / BGRA targets against the JAX package, on the CPU.

The frame wrapper (ops/frame.py, which takes the plain version for CPU
tensors) onto RGBA and BGRA canvases against ``golden.composite_stack``
and the Pallas RGBA-target kernel ``convert_frame_pallas`` in interpret
mode; the registry's ``img_y420p_rgba`` (BASELINE config 1) against the JAX
registry; and a CPU ``VideoMixer`` with an RGBA output against the JAX
``VideoMixer``, tick for tick.  Inputs come from ``np.random.default_rng``
as the JAX package's objects and reach the port through ``interop``.
Tolerance: at most 1 LSB per channel.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swiftvideo_tpu.core import EventBox, StepClock, TimePoint, Tx
from swiftvideo_tpu.media import PixelFormat as PF
from swiftvideo_tpu.media import create_picture_sample
from swiftvideo_tpu.mix import VideoMixer as JaxVideoMixer
from swiftvideo_tpu.ops import golden
from swiftvideo_tpu.ops import make_compute_context as jax_context
from swiftvideo_tpu.ops import rect_uniforms
from swiftvideo_tpu.ops import registry as jax_registry
from swiftvideo_tpu.ops.pallas_frame import convert_frame_pallas
from swiftvideo_tpu.utils import matrix as m4
import swiftvideo_tpu_torch.core as port_core
from swiftvideo_tpu_torch import interop
from swiftvideo_tpu_torch.mix import VideoMixer
from swiftvideo_tpu_torch.ops import color, composite, frame, nvcc, registry

TOL = 1
CPU = torch.device("cpu")
W, H = 320, 180


def _u8(rng, *shape):
    return rng.integers(0, 256, shape, np.int64).astype(np.uint8)


def _planes(rng, fmt, w, h):
    if fmt == PF.y420p:
        return [_u8(rng, h, w), _u8(rng, h // 2, w // 2),
                _u8(rng, h // 2, w // 2)]
    if fmt in (PF.nv12, PF.nv21):
        return [_u8(rng, h, w), _u8(rng, h // 2, w // 2, 2)]
    return [_u8(rng, h, w, 4)]


def _live(rng, cam_fmt=PF.y420p, ov_fmt=PF.RGBA):
    """The live station at 320x180: four cameras 2:1 into the quadrants,
    one with fill and border, and a lower third with an alpha ramp."""
    srcs = []
    for s in range(4):
        extra = {}
        if s == 2:
            extra = dict(fill_color=(0.1, 0.6, 0.3, 0.7),
                         border=(-4, H / 2 - 3, W / 2 + 8, H / 2 + 6))
        srcs.append((_planes(rng, cam_fmt, W, H), cam_fmt, rect_uniforms(
            (W, H), (W, H), x=(s % 2) * W / 2, y=(s // 2) * H / 2, w=W / 2,
            h=H / 2, opacity=0.9, **extra)))
    lower = _planes(rng, ov_fmt, W, 40)
    lower[0][..., 3] = np.linspace(0, 255, W).astype(np.uint8)[None, :]
    srcs.append((lower, ov_fmt, rect_uniforms((W, 40), (W, H), x=0.25,
                                              y=H - 46.0, w=W, h=40)))
    return srcs


def _rotated(rng):
    return [
        (_planes(rng, PF.nv21, W, H), PF.nv21, rect_uniforms(
            (W, H), (W, H), x=60, y=30, w=150, h=90, rotation=0.35,
            opacity=0.8, fill_color=(0.9, 0.2, 0.1, 0.6),
            border=(54, 24, 162, 102))),
        (_planes(rng, PF.BGRA, 96, 48), PF.BGRA, rect_uniforms(
            (96, 48), (W, H), x=180, y=100, w=110, h=60, rotation=-0.5,
            fill_color=(0.2, 0.2, 0.9, 0.5), border=(176, 96, 118, 68))),
    ]


def _max_err(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == np.uint8
    return int(np.abs(got.astype(int) - ref.astype(int)).max())


STACKS = {
    "live-y420p+rgba": lambda r: _live(r),
    "live-nv12+bgra": lambda r: _live(r, PF.nv12, PF.BGRA),
    "rotated-nv21+bgra": _rotated,
}


@pytest.mark.parametrize("out_fmt", [PF.RGBA, PF.BGRA], ids=lambda f: f.value)
@pytest.mark.parametrize("stack", sorted(STACKS))
def test_wrapper_matches_golden(stack, out_fmt):
    srcs = STACKS[stack](np.random.default_rng(31))
    launches, calls = frame.launches, composite.calls
    got = frame.composite_frame_cuda((W, H), interop.to_port_sources(srcs, CPU),
                                     interop.pixel_format(out_fmt))
    assert frame.launches == launches and composite.calls == calls + 1
    ref = golden.composite_stack(out_fmt, (W, H), srcs)
    assert len(got) == 1 and _max_err(got[0], ref[0]) <= TOL


# the geometries of tests/test_pallas_frame.py's convert_frame cases: 1280x720
# into a 640x360 canvas at exactly 2:1 (BASELINE config 1), and a 768x512
# source placed at a fractional offset with opacity and fill
_PALLAS_CASES = {
    "config1-rgba": (PF.RGBA, (720, 1280), dict(x=0, y=0, w=640, h=360,
                                                 opacity=1.0)),
    "placed-bgra": (PF.BGRA, (512, 768), dict(
        x=40.3, y=20.7, w=384, h=256, opacity=0.85,
        fill_color=(0.3, 0.1, 0.6, 0.4))),
}


@pytest.mark.parametrize("case", sorted(_PALLAS_CASES))
def test_wrapper_matches_convert_frame_pallas_interpret(case):
    out_fmt, (h, w), place = _PALLAS_CASES[case]
    src = _planes(np.random.default_rng(80), PF.y420p, w, h)
    srcs = [(src, PF.y420p, rect_uniforms((w, h), (640, 360), **place))]
    ref = convert_frame_pallas((640, 360), srcs, out_fmt, interpret=True)
    assert ref is not None
    got = frame.composite_frame_cuda((640, 360),
                                     interop.to_port_sources(srcs, CPU),
                                     interop.pixel_format(out_fmt))
    assert _max_err(got[0], ref) <= TOL


def test_registry_config1_matches_jax_registry():
    """apply_compute_image with img_y420p_rgba: a 1280x720 y420p picture
    scaled into a 640x360 RGBA canvas."""
    rng = np.random.default_rng(81)
    image = create_picture_sample((1280, 720), PF.y420p, asset_id="cam",
                                  workspace_id="w")
    for p, v in zip(image.planes(), _planes(rng, PF.y420p, 1280, 720)):
        p[:] = v
    image = image.with_(matrix=m4.ortho(640, 360) @ m4.scale(640, 360))
    target = create_picture_sample((640, 360), PF.RGBA, asset_id="out",
                                   workspace_id="w")
    target.planes()[0][:] = _u8(rng, 360, 640, 4)
    theirs = jax_registry.apply_compute_image(jax_context("golden"), image,
                                              target)
    kernel = registry.default_compute_kernel_from_string("img_y420p_rgba")
    ours = registry.apply_compute_image(registry.make_compute_context("cpu"),
                                        interop.picture_sample(image),
                                        interop.picture_sample(target), kernel)
    assert _max_err(ours.planes()[0], theirs.planes()[0]) <= TOL


def test_kernel_yuv2rgb_literals_match_the_table():
    """The RGBA-target kernel writes YUV2RGB as hex float literals; they are
    ops/color.py's float32 table bit for bit."""
    text = (nvcc.CSRC / "frame_composite.cu").read_text()
    body = re.search(r"kYuv2Rgb\[3\]\[4\] = \{(.*?)\};", text, re.S).group(1)
    vals = [float.fromhex(v.rstrip("f"))
            for v in re.findall(r"-?0x[0-9a-f.]+p[+-]\d+f", body)]
    assert np.array_equal(np.array(vals, np.float32).reshape(3, 4),
                          color.YUV2RGB[:3])


def _mixer_sources(rng):
    """Samples of the JAX package: three y420p cameras and an nv12 camera
    on a 320x180 canvas, one at a fractional offset and scale, and an RGBA
    lower third at a quarter-pixel offset.  (The JAX mixer sends a rotated
    source through its warp sampler, held to golden only on smooth content,
    and may put an element edge on an exact pixel row on either side.)"""
    pics = []
    places = [(0, 0, 160, 90, 0), (160, 0, 160, 90, 1), (40.5, 70.25, 200, 100, 2),
              (180, 90, 140, 90, 3)]
    for k, (x, y, w, h, z) in enumerate(places):
        fmt = PF.nv12 if k == 3 else PF.y420p
        pic = create_picture_sample((W, H), fmt, asset_id=f"cam{k}",
                                    workspace_id="w")
        for p, v in zip(pic.planes(), _planes(rng, fmt, W, H)):
            p[:] = v
        model = m4.ortho(W, H) @ m4.translation(x, y, z) @ m4.scale(w, h)
        pics.append(pic.with_(matrix=model, revision=f"r{k}",
                              opacity=0.85 if k == 2 else 1.0))
    lower = create_picture_sample((W, 40), PF.RGBA, asset_id="lt",
                                  workspace_id="w")
    rgba = _u8(rng, 40, W, 4)
    rgba[..., 3] = np.linspace(0, 255, W).astype(np.uint8)[None, :]
    lower.planes()[0][:] = rgba
    pics.append(lower.with_(matrix=m4.ortho(W, H) @ m4.translation(0, 134.25, 9)
                            @ m4.scale(W, 40), revision="lt"))
    return pics


def _drive_mixer(mixer, clock, tx, append, pics_by_tick):
    frames = []
    keep = mixer >> tx(lambda s: (frames.append(s), s)[1])
    for pics in pics_by_tick:
        for pic in pics:
            mixer.apply(append(pic))
        clock.step()
    del keep
    return frames


@pytest.mark.parametrize("out_fmt", [PF.RGBA, PF.BGRA], ids=lambda f: f.value)
def test_video_mixer_rgba_output_matches_jax_mixer(out_fmt):
    rng = np.random.default_rng(82)
    ticks = [_mixer_sources(rng), _mixer_sources(rng)[:2], []]
    frame_duration = TimePoint(1000, 30000)

    jax_clock = StepClock(frame_duration)
    theirs_mixer = JaxVideoMixer(jax_clock, workspace_id="w",
                                 frame_duration=frame_duration,
                                 output_size=(W, H), output_format=out_fmt,
                                 compute_context=jax_context("jax"),
                                 asset_id="mix")
    theirs = _drive_mixer(theirs_mixer, jax_clock,
                          lambda f: Tx(lambda s: EventBox.just(f(s))),
                          EventBox.just, ticks)

    port_clock = port_core.StepClock(interop.time_point(frame_duration))
    ours_mixer = VideoMixer(port_clock, workspace_id="w",
                            frame_duration=interop.time_point(frame_duration),
                            output_size=(W, H),
                            output_format=interop.pixel_format(out_fmt),
                            compute_context=registry.make_compute_context("cpu"),
                            asset_id="mix")
    launches, calls = frame.launches, composite.calls
    ours = _drive_mixer(ours_mixer, port_clock,
                        lambda f: port_core.Tx(
                            lambda s: port_core.EventBox.just(f(s))),
                        lambda pic: port_core.EventBox.just(
                            interop.picture_sample(pic)), ticks)
    assert frame.launches == launches
    assert composite.calls == calls + len(ours)
    assert len(ours) == len(theirs) == len(ticks)
    for a, b in zip(ours, theirs):
        assert (a.pts().value, a.pts().scale) == (b.pts().value, b.pts().scale)
        assert a.pixel_format() is interop.pixel_format(out_fmt)
        (plane,) = a.planes()
        assert isinstance(plane, torch.Tensor) and plane.shape == (H, W, 4)
        assert _max_err(plane, np.asarray(jnp.asarray(b.planes()[0]))) <= TOL
    # the scene is on screen, and the last tick repeats the held sources
    assert int(ours[-1].planes()[0][..., :3].float().std()) > 10
