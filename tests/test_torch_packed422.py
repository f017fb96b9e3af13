"""Packed 4:2:2 (yuvs / zvuy) sources and targets in the port, on the CPU.

The port unpacks a packed source to y422p planes and folds a packed target
as y422p, packing it again, as ``golden.composite_stack`` and the JAX
``composite_stack_device`` do.  Each case goes through the port and through
the JAX package on the same inputs from ``np.random.default_rng``: the
plain composite, ``registry.composite_frame`` and a ``VideoMixer`` tick
with a yuvs camera (which used to raise in the mixer and emit no frame).
Tolerance: 1 LSB against golden and the JAX device fold (the JAX package's
own contract); the unpack and repack are exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swiftvideo_tpu.core import EventBox, StepClock, TimePoint, Tx
from swiftvideo_tpu.media import PixelFormat as PF
from swiftvideo_tpu.media import create_picture_sample
from swiftvideo_tpu.media.pixel import packed422_to_planar as jax_unpack
from swiftvideo_tpu.media.pixel import planar_to_packed422 as jax_pack
from swiftvideo_tpu.mix import VideoMixer as JaxVideoMixer
from swiftvideo_tpu.ops import composite as jax_composite
from swiftvideo_tpu.ops import golden, rect_uniforms
from swiftvideo_tpu.ops import make_compute_context as jax_context
from swiftvideo_tpu.utils import matrix as m4
import swiftvideo_tpu_torch.core as port_core
from swiftvideo_tpu_torch import interop
from swiftvideo_tpu_torch.media.pixel import (packed422_to_planar,
                                              planar_to_packed422)
from swiftvideo_tpu_torch.mix import VideoMixer
from swiftvideo_tpu_torch.ops import composite, frame, registry

TOL = 1
PACKED = [PF.yuvs, PF.zvuy]


def _err(ours, theirs):
    return max(int(np.abs(o.numpy().astype(int)
                          - np.asarray(t).astype(int)).max())
               for o, t in zip(ours, theirs))


def _case(fmt, seed=31, w=48, h=32):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, 256, (16, 32, 2), np.int64).astype(np.uint8)
    uni = rect_uniforms((32, 16), (w, h), x=6.3, y=4.7, w=36.4, h=24.2,
                        opacity=0.9)
    return [([src], fmt, uni)]


@pytest.mark.parametrize("fmt", PACKED, ids=lambda f: f.value)
def test_packed_422_composite_in_out(fmt):
    """Twin of the JAX package's test of the same name: a packed source
    onto a packed target, and onto a planar one, against golden and the
    JAX device fold; the packed result is the planar fold packed."""
    W, H = 48, 32
    sources = _case(fmt)
    port_fmt = interop.pixel_format(fmt)
    ours = composite.composite_stack_torch(
        port_fmt, (W, H), interop.to_port_sources(sources, "cpu"), "cpu")
    assert len(ours) == 1 and tuple(ours[0].shape) == (H, W, 2)
    assert _err(ours, golden.composite_stack(fmt, (W, H), sources)) <= TOL
    assert _err(ours, jax_composite.composite_stack_device(
        fmt, (W, H), sources)) <= TOL
    planar = composite.composite_stack_torch(
        interop.pixel_format(PF.y422p), (W, H), interop.to_port_sources(
            [(jax_unpack(sources[0][0][0], fmt), PF.y422p, sources[0][2])],
            "cpu"), "cpu")
    assert torch.equal(ours[0], planar_to_packed422(planar, port_fmt, torch))
    for out_fmt in (PF.y420p, PF.nv12, PF.RGBA):
        ours = composite.composite_stack_torch(
            interop.pixel_format(out_fmt), (W, H),
            interop.to_port_sources(sources, "cpu"), "cpu")
        assert _err(ours, golden.composite_stack(out_fmt, (W, H),
                                                 sources)) <= TOL
        assert _err(ours, jax_composite.composite_stack_device(
            out_fmt, (W, H), sources)) <= TOL


@pytest.mark.parametrize("fmt", PACKED, ids=lambda f: f.value)
def test_unpack_and_pack_are_torch_ops_and_exact(fmt):
    rng = np.random.default_rng(2)
    arr = rng.integers(0, 256, (8, 12, 2), np.int64).astype(np.uint8)
    port_fmt = interop.pixel_format(fmt)
    planes = packed422_to_planar(torch.from_numpy(arr), port_fmt, torch)
    assert all(isinstance(p, torch.Tensor) for p in planes)
    for ours, theirs in zip(planes, jax_unpack(arr, fmt)):
        assert np.array_equal(ours.numpy(), theirs)
    assert np.array_equal(planar_to_packed422(planes, port_fmt, torch).numpy(),
                          arr)


@pytest.mark.parametrize("fmt", PACKED, ids=lambda f: f.value)
def test_registry_composite_frame_packed(fmt):
    """``registry.composite_frame`` on a cpu context: a packed source onto
    y420p and onto a packed target that already holds a picture."""
    W, H = 48, 32
    sources = _case(fmt, seed=8)
    ctx = registry.make_compute_context("cpu")
    port_sources = interop.to_port_sources(sources, "cpu")
    launches = frame.launches
    ours = registry.composite_frame(ctx, interop.pixel_format(PF.y420p),
                                    (W, H), port_sources)
    assert _err(ours, golden.composite_stack(PF.y420p, (W, H),
                                             sources)) <= TOL
    rng = np.random.default_rng(9)
    base = rng.integers(0, 256, (H, W, 2), np.int64).astype(np.uint8)
    ours = registry.composite_frame(
        ctx, interop.pixel_format(fmt), (W, H), port_sources,
        target=[torch.from_numpy(base)])
    # golden's y422p fold over the same starting planes, packed again
    want = jax_unpack(base, fmt)
    for src, in_fmt, uni in sources:
        want = golden.apply_composite(want, PF.y422p,
                                      jax_unpack(src[0], in_fmt), PF.y422p,
                                      uni)
    assert tuple(ours[0].shape) == (H, W, 2)
    assert _err(ours, [jax_pack(want, fmt)]) <= TOL
    assert frame.launches == launches


def _mixer_pictures(rng, fmt, W, H):
    cam = create_picture_sample((64, 36), fmt, asset_id="cam",
                                workspace_id="w")
    cam.planes()[0][:] = rng.integers(0, 256, cam.planes()[0].shape,
                                      np.int64).astype(np.uint8)
    model = m4.ortho(W, H) @ m4.translation(10.25, 6.5, 1) @ m4.scale(90, 50)
    base = create_picture_sample((W, H), PF.y420p, asset_id="bg",
                                 workspace_id="w")
    for p in base.planes():
        p[:] = rng.integers(0, 256, p.shape, np.int64).astype(np.uint8)
    return [base.with_(matrix=m4.ortho(W, H) @ m4.scale(W, H), revision="b"),
            cam.with_(matrix=model, revision="c", opacity=0.8)]


@pytest.mark.parametrize("fmt", PACKED, ids=lambda f: f.value)
def test_video_mixer_with_packed_camera_emits_frames(fmt):
    """A VideoMixer tick with a packed camera over a y420p background emits
    a frame (it raised and emitted none before), within 1 LSB of the JAX
    VideoMixer's."""
    W, H = 128, 72
    rng = np.random.default_rng(61)
    pics = _mixer_pictures(rng, fmt, W, H)
    duration = TimePoint(1000, 30000)

    jax_clock = StepClock(duration)
    theirs_mixer = JaxVideoMixer(jax_clock, workspace_id="w",
                                 frame_duration=duration, output_size=(W, H),
                                 output_format=PF.y420p,
                                 compute_context=jax_context("jax"),
                                 asset_id="mix")
    theirs = []
    keep = theirs_mixer >> Tx(lambda s: EventBox.just(
        (theirs.append(s), s)[1]))
    for pic in pics:
        theirs_mixer.apply(EventBox.just(pic))
    jax_clock.step()
    del keep

    port_clock = port_core.StepClock(interop.time_point(duration))
    ours_mixer = VideoMixer(port_clock, workspace_id="w",
                            frame_duration=interop.time_point(duration),
                            output_size=(W, H),
                            output_format=interop.pixel_format(PF.y420p),
                            compute_context=registry.make_compute_context("cpu"),
                            asset_id="mix")
    ours = []
    keep = ours_mixer >> port_core.Tx(lambda s: port_core.EventBox.just(
        (ours.append(s), s)[1]))
    for pic in pics:
        ours_mixer.apply(port_core.EventBox.just(interop.picture_sample(pic)))
    port_clock.step()
    del keep
    assert len(ours) == len(theirs) == 1
    assert _err(ours[0].planes(),
                [jnp.asarray(p) for p in theirs[0].planes()]) <= TOL
    # the camera is on screen: its region differs from the background's
    cam_luma = ours[0].planes()[0][10:50, 15:90].numpy()
    bg_luma = pics[0].planes()[0][10:50, 15:90]
    assert not np.array_equal(cam_luma, bg_luma)
