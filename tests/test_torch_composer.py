"""The port's Composer against the JAX package's, tick for tick, on the CPU.

Both composers get the same scene (four cameras 2:1 into the quadrants of
a 320x180 y420p canvas, a 320x40 RGBA lower third, four stereo s16 audio
assets) and the same samples, and step the same StepClock ticks.  Each
side builds its scene, clock, buses and samples from its own package's
core / media / scene (the two packages' types are distinct); the sample
data comes from one numpy seed.  Per tick: frames within 1 LSB, mixed audio
exactly equal, the same pts.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import swiftvideo_tpu.core as jax_core
import swiftvideo_tpu.media as jax_media
import swiftvideo_tpu.scene as jax_scene
import swiftvideo_tpu_torch.core as port_core
import swiftvideo_tpu_torch.media as port_media
import swiftvideo_tpu_torch.scene as port_scene
from swiftvideo_tpu.compose import Composer as JaxComposer
from swiftvideo_tpu.ops import make_compute_context as jax_context
from swiftvideo_tpu_torch.compose import Composer, ComposerError
from swiftvideo_tpu_torch.ops import make_compute_context

JAX_NS = SimpleNamespace(core=jax_core, media=jax_media, scene=jax_scene)
PORT_NS = SimpleNamespace(core=port_core, media=port_media, scene=port_scene)

W, H = 320, 180
OV_H = 40
TOL = 1
STEPS = 45  # 10 ms audio steps: 450 ms, 13 video ticks at 30 fps


def _composition(ns):
    Element, ElementState = ns.scene.Element, ns.scene.ElementState
    TimePoint = ns.core.TimePoint
    cams = tuple(Element(name=f"cam{s}", z_index=s, initial_state=ElementState(
        pic_pos=((s % 2) * W / 2, (s // 2) * H / 2), size=(W / 2, H / 2),
        transparency=0.1, audio_gain=0.5 + 0.25 * s,
        fill_color=(0.2, 0.4, 0.6, 0.5) if s == 2 else None,
        border_size=(3.0, 2.0, 3.0, 2.0) if s == 2 else (0.0, 0.0, 0.0, 0.0)))
        for s in range(4))
    lower = Element(name="lower_third", z_index=9, initial_state=ElementState(
        pic_pos=(0.0, H - OV_H - 6.5), size=(float(W), float(OV_H))))
    return ns.scene.Composition(
        name="live", canvas_size=(W, H), frame_duration=TimePoint(1000, 30000),
        audio_frame_duration=TimePoint(480, 48000), sample_rate=48000,
        channel_count=2,
        scenes=(ns.scene.Scene(name="main", elements=cams + (lower,)),),
        initial_scene="main")


def _inputs(seed):
    rng = np.random.default_rng(seed)

    def u8(*shape):
        return rng.integers(0, 256, shape, np.int64).astype(np.uint8)
    cams = [[[u8(H, W), u8(H // 2, W // 2), u8(H // 2, W // 2)]
             for _ in range(4)] for _gen in range(2)]
    lower = u8(OV_H, W, 4)
    lower[..., 3] = np.linspace(0, 255, W).astype(np.uint8)[None, :]
    pcm = [rng.integers(-12000, 12000, (STEPS, 960), np.int64).astype(np.int16)
           for _ in range(4)]
    return cams, lower, pcm


def _drive(ns, composer, clock, audio_bus, picture_bus, planes_of, seed):
    """Feed the scene's samples, built from ``ns``'s core / media, for
    STEPS clock steps; returns the mixed frames and audio samples in
    emission order."""
    EventBox, Tx, TimePoint = ns.core.EventBox, ns.core.Tx, ns.core.TimePoint
    PixelFormat, AudioFormat = ns.media.PixelFormat, ns.media.AudioFormat
    cams, lower, pcm = _inputs(seed)
    frames, mixed = [], []
    keep = [picture_bus.subscribe(Tx(
                lambda s: (frames.append(s), EventBox.just(s))[1]
                if s.asset_id() == "live" else EventBox.nothing(None))),
            audio_bus.subscribe(Tx(
                lambda s: (mixed.append(s), EventBox.just(s))[1]
                if s.asset_id() == "live" else EventBox.nothing(None)))]
    for s in range(4):
        composer.bind(f"cam{s}", f"cam{s}")
    composer.bind("lt", "lower_third")

    def picture(asset, fmt, planes):
        h, w = np.shape(planes[0])[:2]
        img = ns.media.ImageBuffer(
            pixel_format=fmt, buffer_type=ns.media.BufferType.cpu, size=(w, h),
            planes=tuple(ns.media.planes_for_format(fmt, (w, h))),
            buffers=tuple(planes_of(planes)))
        return ns.media.PictureSample(img, asset, "w",
                                      time_point=clock.current(),
                                      pts_value=clock.current())

    picture_bus.append(EventBox.just(picture("lt", PixelFormat.RGBA,
                                             [lower])))
    pts = TimePoint(0, 48000)
    for step in range(STEPS):
        if step % 3 == 0:
            for s, planes in enumerate(cams[(step // 3) % 2]):
                picture_bus.append(EventBox.just(
                    picture(f"cam{s}", PixelFormat.y420p, planes)))
        for k in range(4):
            audio_bus.append(EventBox.just(ns.media.AudioSample(
                buffers=(pcm[k][step],), frequency=48000, channels=2,
                format=AudioFormat.s16i, sample_count=480, pts_value=pts,
                id_asset=f"cam{k}", id_workspace="w")))
        pts = pts + TimePoint(480, 48000)
        clock.step()
    composer.close()
    del keep
    return frames, mixed


def _run(port: bool, device_fold: bool):
    ns = PORT_NS if port else JAX_NS
    clock = ns.core.StepClock(ns.core.TimePoint(480, 48000))
    audio_bus, picture_bus = ns.core.Bus(clock), ns.core.Bus(clock)
    if port:
        composer = Composer(clock, workspace_id="w",
                            composition=_composition(ns),
                            audio_bus=audio_bus, picture_bus=picture_bus,
                            compute_context=make_compute_context(
                                torch.device("cpu")),
                            output_format=ns.media.PixelFormat.y420p)

        def planes_of(planes):
            # JAX-produced planes carried across as numpy, as interop does
            return [torch.from_numpy(np.array(jnp.asarray(p)))
                    for p in planes]
    else:
        composer = JaxComposer(clock, workspace_id="w",
                               composition=_composition(ns),
                               audio_bus=audio_bus, picture_bus=picture_bus,
                               compute_context=jax_context("jax"),
                               output_format=ns.media.PixelFormat.y420p)

        def planes_of(planes):
            return [jnp.asarray(p) for p in planes]
    if device_fold:
        composer.audio_mixer.device_min_elems = 0
    return _drive(ns, composer, clock, audio_bus, picture_bus, planes_of,
                  seed=21)


def _tp(tp):
    return (tp.value, tp.scale)


@pytest.mark.parametrize("device_fold", [False, True],
                         ids=["host-fold", "device-fold"])
def test_port_composer_matches_jax_composer(device_fold):
    ours_v, ours_a = _run(True, device_fold)
    theirs_v, theirs_a = _run(False, device_fold)
    assert len(ours_v) == len(theirs_v) >= 12
    for a, b in zip(ours_v, theirs_v):
        assert _tp(a.pts()) == _tp(b.pts())
        assert a.buffer_type() == port_media.BufferType.cpu
        for p, q in zip(a.planes(), b.planes()):
            assert isinstance(p, torch.Tensor)
            err = np.abs(p.numpy().astype(int)
                         - np.asarray(q).astype(int)).max()
            assert err <= TOL, err
    # the scene is on screen: cameras and lower third composited
    assert int(ours_v[-1].planes()[0].float().std()) > 10
    assert len(ours_a) == len(theirs_a) == STEPS
    for a, b in zip(ours_a, theirs_a):
        assert _tp(a.pts()) == _tp(b.pts()) and a.number_samples() == 480
        assert np.array_equal(np.asarray(a.data()[0]),
                              np.asarray(b.data()[0]))
        assert [c.id_asset for c in a.constituents()] == \
            [c.id_asset for c in b.constituents()]
    assert np.any(np.asarray(ours_a[-1].data()[0]))


def test_media_commands_need_an_action():
    """An action still claims a media command first.  Without one the
    built-in handler runs (it raised while the codec layer was not ported):
    SetText renders the text and publishes it under the asset id."""
    from concurrent.futures import Future

    from swiftvideo_tpu_torch.scene import ComposerCommand, SetTextCommand
    clock = port_core.StepClock(port_core.TimePoint(480, 48000))
    pictures = port_core.Bus(clock)
    composer = Composer(clock, workspace_id="w",
                        composition=_composition(PORT_NS),
                        audio_bus=port_core.Bus(clock),
                        picture_bus=pictures,
                        compute_context=make_compute_context("cpu"))
    published = []
    keep = pictures.subscribe(port_core.Tx(
        lambda s: (published.append(s), port_core.EventBox.nothing(None))[1]))
    cmd = ComposerCommand(set_text=SetTextCommand(asset_id="t", value="hi"))
    claimed: Future = Future()
    claimed.set_result(True)
    assert composer.run_command(cmd, action=lambda c: claimed).result(1)
    assert published == []
    assert composer.run_command(cmd).result(1)
    (text,) = [s for s in published if s.asset_id() == "t"]
    assert text.pixel_format() is port_media.PixelFormat.RGBA
    assert int(np.asarray(text.planes()[0])[..., 3].max()) > 0
    del keep
    composer.close()
