"""The port's own copies of the host layers (core, media, scene, utils)
against the JAX package's, and ``interop``'s conversions between the two.

Each behaviour runs on both packages with the same inputs, each package
building its own objects, and the results are compared by value: exact.
"""

import gc
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Optional

import numpy as np
import pytest
import torch

import swiftvideo_tpu.core as jax_core
import swiftvideo_tpu.media as jax_media
import swiftvideo_tpu.scene as jax_scene
import swiftvideo_tpu.utils.matrix as jax_m4
import swiftvideo_tpu_torch.core as port_core
import swiftvideo_tpu_torch.media as port_media
import swiftvideo_tpu_torch.scene as port_scene
import swiftvideo_tpu_torch.utils.matrix as port_m4
from swiftvideo_tpu.ops import rect_uniforms as jax_rect_uniforms
from swiftvideo_tpu_torch import interop
from swiftvideo_tpu_torch.ops.uniforms import ImageUniforms

PACKAGES = {
    "jax": SimpleNamespace(core=jax_core, media=jax_media, scene=jax_scene,
                           m4=jax_m4),
    "port": SimpleNamespace(core=port_core, media=port_media, scene=port_scene,
                            m4=port_m4),
}


def _both(fn):
    """fn(namespace) on both packages; the two results."""
    return fn(PACKAGES["jax"]), fn(PACKAGES["port"])


def _tp(tp):
    return (tp.value, tp.scale)


def test_copies_are_distinct_modules():
    assert port_core.TimePoint is not jax_core.TimePoint
    assert port_media.PixelFormat.y420p != jax_media.PixelFormat.y420p
    assert interop.pixel_format(jax_media.PixelFormat.y420p) \
        is port_media.PixelFormat.y420p


def test_timepoint_arithmetic_and_rescale():
    def run(ns):
        TP, core = ns.core.TimePoint, ns.core
        a, b = TP(1001, 30000), TP(7, 48000)
        out = [a + b, a - b, b - a, a * 5, a / 7, a // 3, a % b, -a,
               core.rescale(a, 48000), core.rescale(b, 90000),
               core.rescale(TP(-5, 3), 7), core.simplify(TP(960, 48000)),
               core.minimum(a, b), core.maximum(a, b),
               core.clamp_time(TP(5, 1), a, TP(1, 1)),
               core.from_seconds(1.2345, 90000), TP(2 ** 63 + 5, 1)]
        return ([_tp(t) for t in out],
                [a > b, a < b, a >= TP(2002, 60000), a == TP(2002, 60000),
                 core.seconds(a)])
    assert run(PACKAGES["jax"]) == run(PACKAGES["port"])


def test_step_clock_runs_events_in_time_order():
    def run(ns):
        TP = ns.core.TimePoint
        clock = ns.core.StepClock(TP(10, 1000))
        seen = []

        def at(ms, tag):
            clock.schedule(TP(ms, 1000), lambda ev: seen.append(
                (tag, _tp(ev.time()), _tp(clock.current()))))
        for ms, tag in ((30, "c"), (10, "a"), (20, "b"), (20, "b2"), (5, "z"),
                        (40, "late")):
            at(ms, tag)
        # a callback may schedule more work; it runs at its own time
        clock.schedule(TP(10, 1000), lambda ev: at(25, "nested"))
        steps = [_tp(clock.step()) for _ in range(3)]
        return seen, steps, clock.pending_count()
    assert run(PACKAGES["jax"]) == run(PACKAGES["port"])


@dataclass
class _Event:
    idx: int

    def type(self) -> str:
        return "test"

    def time(self):
        return None

    def asset_id(self) -> str:
        return "a"

    def workspace_id(self) -> str:
        return "w"

    def workspace_token(self) -> Optional[str]:
        return None

    def info(self):
        return None


def test_bus_holds_subscribers_weakly():
    def run(ns):
        core = ns.core
        bus = core.Bus(core.StepClock(core.TimePoint(1, 1000)))
        seen = []
        keep = bus.subscribe(core.Tx(
            lambda e: (seen.append(("keep", e.idx)), core.EventBox.just(e))[1]))
        dropped = bus.subscribe(core.Tx(
            lambda e: (seen.append(("drop", e.idx)), core.EventBox.just(e))[1]))
        bus.append(core.EventBox.just(_Event(0)))
        del dropped
        gc.collect()
        bus.append(core.EventBox.just(_Event(1)))
        del keep
        gc.collect()
        bus.append(core.EventBox.just(_Event(2)))
        return seen
    jax_seen, port_seen = _both(run)
    assert jax_seen == port_seen == [("keep", 0), ("drop", 0), ("keep", 1)]


def test_picture_sample_matrices():
    def run(ns):
        m4 = ns.m4
        pic = ns.media.create_picture_sample((64, 36), ns.media.PixelFormat.nv12,
                                             asset_id="a", workspace_id="w")
        model = (m4.ortho(320, 180) @ m4.translation(30.5, 20.25, 3.0)
                 @ m4.rotation_z(0.3) @ m4.scale(120, 60))
        moved = pic.with_(matrix=model, texture_matrix=m4.scale(0.5, 0.25),
                          opacity=0.7)
        bordered = moved.with_(border_matrix=m4.translation(1, 2))
        return (pic.border_matrix(), pic.z_index(), moved.matrix(),
                moved.border_matrix(), moved.texture_matrix(), moved.z_index(),
                bordered.border_matrix(), bordered.matrix(), moved.opacity(),
                [p.shape for p in pic.planes()], pic.size())
    jax_out, port_out = _both(run)
    for a, b in zip(jax_out, port_out):
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        else:
            assert a == b


def test_scene_json_matches():
    def run(ns):
        sc = ns.scene
        comp = sc.Composition(
            name="c", canvas_size=(640, 360),
            scenes=(sc.Scene(name="m", elements=(sc.Element(
                name="e", z_index=3, initial_state=sc.ElementState(
                    pic_pos=(10.0, 20.0), size=(320.0, 180.0),
                    transparency=0.25, audio_gain=0.5))),)),
            initial_scene="m")
        cmd = sc.ComposerCommand(set_text=sc.SetTextCommand(asset_id="t",
                                                            value="hi"))
        return (sc.composition_to_json(comp), sc.command_to_json(cmd),
                sc.command_to_json(sc.command_from_json(sc.command_to_json(cmd))))
    jax_out, port_out = _both(run)
    assert jax_out == port_out and jax_out[1] == jax_out[2]


def test_interop_carries_pictures_audio_and_uniforms():
    rng = np.random.default_rng(4)
    pic = jax_media.create_picture_sample((32, 16), jax_media.PixelFormat.y420p,
                                          asset_id="cam", workspace_id="w")
    for p in pic.planes():
        p[:] = rng.integers(0, 256, p.shape, np.int64).astype(np.uint8)
    pic = pic.with_(matrix=jax_m4.translation(3, 4, 2), opacity=0.6,
                    pts=jax_core.TimePoint(7, 30), revision="r1",
                    fill_color=np.array([0.1, 0.2, 0.3, 0.4], np.float32))
    ours = interop.picture_sample(pic)
    assert isinstance(ours, port_media.PictureSample)
    assert ours.pixel_format() is port_media.PixelFormat.y420p
    assert ours.buffer_type() is port_media.BufferType.cpu
    assert ours.size() == (32, 16) and ours.z_index() == 2
    assert _tp(ours.pts()) == (7, 30) and ours.revision() == "r1"
    assert ours.opacity() == pytest.approx(0.6)
    assert np.array_equal(ours.matrix(), pic.matrix())
    assert np.array_equal(ours.fill_color(), pic.fill_color())
    for a, b in zip(ours.planes(), pic.planes()):
        assert isinstance(a, np.ndarray) and np.array_equal(a, b)
    assert ours.planes()[0] is not pic.planes()[0]

    pcm = rng.integers(-30000, 30000, 960, np.int64).astype(np.int16)
    snd = jax_media.AudioSample(
        buffers=(pcm,), frequency=48000, channels=2,
        format=jax_media.AudioFormat.s16i, sample_count=480,
        pts_value=jax_core.TimePoint(480, 48000), id_asset="mic",
        id_workspace="w", transform=jax_m4.identity3() * 0.5)
    sound = interop.audio_sample(snd)
    assert isinstance(sound, port_media.AudioSample)
    assert sound.format == port_media.AudioFormat.s16i
    assert (sound.number_samples(), sound.number_channels(),
            sound.sample_rate()) == (480, 2, 48000)
    assert _tp(sound.pts()) == (480, 48000) and sound.asset_id() == "mic"
    assert np.array_equal(sound.data()[0], pcm)
    assert np.array_equal(sound.transform, snd.transform)

    uni = jax_rect_uniforms((64, 32), (320, 180), x=3.5, y=2.25, w=100, h=50,
                            rotation=0.2, opacity=0.9)
    vec = interop.uniforms(uni)
    assert vec.dtype == np.float32 and vec.shape == (29,)
    assert np.array_equal(ImageUniforms.unpack(vec).pack(), uni.pack())
    (planes, fmt, packed), = interop.to_port_sources(
        [(pic.planes(), pic.pixel_format(), uni)], torch.device("cpu"))
    assert fmt is port_media.PixelFormat.y420p
    assert all(t.dtype == torch.uint8 for t in planes)
    assert np.array_equal(packed, vec)
