"""The port's VideoMixer and Composer on a ``"cpu"`` context: twins of
``tests/test_video_mixer.py`` retargeted at ``swiftvideo_tpu_torch``.

Mixed pixels are held against ``swiftvideo_tpu/ops/golden.py`` (sources,
formats and uniforms carried over by value) and against the JAX package's
mixer and Composer on the same inputs.  Tolerances, per test: 0 LSB
against golden where the port's plain composite computes golden's
float32 operations in golden's order (axis-aligned and rotated sources
alike, the contract K1 is held to on the card); 1 LSB against the JAX
package's device paths (its XLA fold rounds otherwise).  The JAX package's
warp path for rotated sources is not ported: the port samples a rotated
source exactly, in the frame kernel's one launch.
"""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import swiftvideo_tpu.core as jcore
import swiftvideo_tpu.media as jmedia
import swiftvideo_tpu.mix as jmix
import swiftvideo_tpu.scene as jscene
import swiftvideo_tpu.utils.matrix as jm4
from swiftvideo_tpu.compose import Composer as JaxComposer
from swiftvideo_tpu.ops import golden
from swiftvideo_tpu.ops import make_compute_context as jax_context
from swiftvideo_tpu_torch import core, interop, media, mix, scene
from swiftvideo_tpu_torch.compose import (BindCommand, Composer,
                                          ComposerCommand, ComposerError,
                                          SetSceneCommand, SetStateCommand)
from swiftvideo_tpu_torch.core import Bus, EventBox, StepClock, TimePoint, Tx
from swiftvideo_tpu_torch.media import BufferType, PixelFormat
from swiftvideo_tpu_torch.mix import video_mixer as vm_mod
from swiftvideo_tpu_torch.ops import (frame, make_compute_context,
                                      rect_uniforms)
from swiftvideo_tpu_torch.ops.registry import ComputeContext
from swiftvideo_tpu_torch.utils import matrix as m4

FRAME = TimePoint(1000, 30000)
PORT = SimpleNamespace(core=core, media=media, mix=mix, scene=scene, m4=m4)
JAX = SimpleNamespace(core=jcore, media=jmedia, mix=jmix, scene=jscene, m4=jm4)


def cpu():
    return make_compute_context("cpu")


def _source(ns, y_value, size=(32, 32), asset="cam", rev="r1", rect=None,
            canvas=(64, 64), z=0):
    s = ns.media.create_picture_sample(size, ns.media.PixelFormat.y420p,
                                       asset_id=asset, workspace_id="w")
    s.planes()[0][:] = y_value
    if rect is not None:
        x, y, w, h = rect
        model = (ns.m4.ortho(*canvas) @ ns.m4.translation(x, y, z)
                 @ ns.m4.scale(w, h))
        return s.with_(matrix=model, revision=rev)
    return s.with_(revision=rev)


def _mixer(ns, ctx, size=(64, 64)):
    """A y420p mixer of ``size`` in ``ns`` and the list its frames go to."""
    clock = ns.core.StepClock(ns.core.TimePoint(1000, 30000))
    mixer = ns.mix.VideoMixer(clock, workspace_id="w",
                              frame_duration=ns.core.TimePoint(1000, 30000),
                              output_size=size,
                              output_format=ns.media.PixelFormat.y420p,
                              compute_context=ctx, asset_id="mix")
    frames = []
    keep = mixer >> ns.core.Tx(lambda s: (frames.append(s),
                                          ns.core.EventBox.just(s))[1])
    return clock, mixer, frames, keep


def _y(sample) -> np.ndarray:
    p = sample.planes()[0]
    return p.numpy() if isinstance(p, torch.Tensor) else np.asarray(p)


def _planes(sample):
    return [p.numpy() if isinstance(p, torch.Tensor) else np.asarray(p)
            for p in sample.planes()]


def _golden_stack(size, srcs):
    """golden.composite_stack of [(port sample, port ImageUniforms)] onto a
    cleared y420p ``size`` canvas: formats by value, uniforms packed."""
    return golden.composite_stack(
        jmedia.PixelFormat(PixelFormat.y420p.value), size,
        [([np.asarray(p) for p in s.planes()],
          jmedia.PixelFormat(s.pixel_format().value), interop.uniforms(u))
         for s, u in srcs])


def test_mixer_composites_and_repeats():
    """Two-generation hold (mix.video.swift:105-114): a frame shows on the
    tick after it arrived and the next, then is gone; pts from the tick."""
    clock, mixer, frames, keep = _mixer(PORT, cpu())
    src = _source(PORT, 200, rect=(0, 0, 32, 32))
    mixer.apply(EventBox.just(src))
    for _ in range(3):
        clock.step()
    assert len(frames) == 3
    want = _golden_stack((64, 64), [(src, rect_uniforms(
        (32, 32), (64, 64), x=0, y=0, w=32, h=32))])
    for f in frames[:2]:
        for got, ref in zip(_planes(f), want):
            assert np.array_equal(got, ref)
    y0, y2 = _y(frames[0]), _y(frames[2])
    assert y0.shape == (64, 64)
    assert abs(int(y0[16, 16]) - 200) <= 1 and y0[48, 48] == 0
    assert y2[16, 16] == 0
    assert frames[0].pts() == TimePoint(1000, 30000)
    assert frames[1].pts() == TimePoint(2000, 30000)
    mixer.close()


def test_mixer_z_order_matches_golden():
    """Arrival order is not z order: the frame is golden's z-sorted fold,
    0 LSB (port formats handed to golden by value)."""
    clock, mixer, frames, keep = _mixer(PORT, cpu())
    a = _source(PORT, 60, asset="a", rev="ra", rect=(0, 0, 48, 48), z=0)
    b = _source(PORT, 180, asset="b", rev="rb", rect=(16, 16, 48, 48), z=1)
    mixer.apply(EventBox.just(b))
    mixer.apply(EventBox.just(a))
    clock.step()
    want = _golden_stack((64, 64), [
        (a, rect_uniforms((32, 32), (64, 64), x=0, y=0, w=48, h=48)),
        (b, rect_uniforms((32, 32), (64, 64), x=16, y=16, w=48, h=48))])
    for got, ref in zip(_planes(frames[0]), want):
        assert np.array_equal(got, ref)
    mixer.close()


def test_mixer_cpu_context_against_jax_device_backend():
    """The JAX twin drives its jitted XLA path; the port's ``"cpu"`` context
    emits torch tensors on the CPU marked ``BufferType.cpu`` (the card
    gives ``BufferType.gpu``), within 1 LSB of the JAX mixer's frame."""
    out = {}
    for name, ns, ctx in (("port", PORT, cpu()), ("jax", JAX,
                                                  jax_context("jax"))):
        clock, mixer, frames, keep = _mixer(ns, ctx, (32, 32))
        mixer.apply(ns.core.EventBox.just(_source(
            ns, 120, size=(16, 16), rect=(0, 0, 32, 32), canvas=(32, 32))))
        clock.step()
        out[name] = frames[0]
        mixer.close()
    port = out["port"]
    assert port.buffer_type() == BufferType.cpu
    assert all(isinstance(p, torch.Tensor) and p.device.type == "cpu"
               for p in port.planes())
    assert abs(int(_y(port)[16, 16]) - 120) <= 1
    for got, ref in zip(_planes(port), _planes(out["jax"])):
        assert int(np.abs(got.astype(int) - ref.astype(int)).max()) <= 1


def test_mixer_skips_degenerate_source():
    """A zero-size (singular) source is skipped; the frame is golden's fold
    of the good one, 0 LSB."""
    clock, mixer, frames, keep = _mixer(PORT, cpu(), (32, 32))
    good = _source(PORT, 150, size=(16, 16), rect=(0, 0, 32, 32),
                   canvas=(32, 32))
    bad = _source(PORT, 99, size=(16, 16), asset="b", rev="rb",
                  rect=(0, 0, 0, 0), canvas=(32, 32))
    mixer.apply(EventBox.just(good))
    mixer.apply(EventBox.just(bad))
    clock.step()
    assert len(frames) == 1
    want = _golden_stack((32, 32), [(good, rect_uniforms(
        (16, 16), (32, 32), x=0, y=0, w=32, h=32))])
    for got, ref in zip(_planes(frames[0]), want):
        assert np.array_equal(got, ref)
    mixer.close()


def _rotated(ns):
    s = ns.media.create_picture_sample((32, 32), ns.media.PixelFormat.y420p,
                                       asset_id="cam", workspace_id="w")
    _yy, xx = np.mgrid[0:32, 0:32]
    s.planes()[0][:] = (128 + 60 * np.sin(xx / 5.0)).astype(np.uint8)
    model = (ns.m4.ortho(64, 64) @ ns.m4.translation(16, 16, 0)
             @ ns.m4.rotation_z(0.4) @ ns.m4.scale(32, 32))
    return s.with_(matrix=model, revision="r1")


def test_mixer_rotated_source_samples_exactly():
    """A rotated element (the JAX package routes it through its warp
    approximation, which is not ported) is sampled exactly: on the CPU the
    frame is golden's, 0 LSB, and within the JAX warp path's documented
    smooth-content tolerance of the JAX mixer's frame."""
    clock, mixer, frames, keep = _mixer(PORT, cpu())
    src = _rotated(PORT)
    mixer.apply(EventBox.just(src))
    clock.step()
    assert frames, "no frame emitted"
    uni = vm_mod.ImageUniforms(
        transform_inv=np.linalg.inv(src.matrix().astype(np.float64)
                                    ).astype(np.float32),
        texture_inv=np.eye(4, dtype=np.float32),
        border_inv=np.linalg.inv(src.border_matrix().astype(np.float64)
                                 ).astype(np.float32),
        fill_color=np.asarray(src.fill_color(), np.float32),
        input_size=(32, 32), output_size=(64, 64), opacity=1.0)
    want = _golden_stack((64, 64), [(src, uni)])
    y = _y(frames[0])
    assert y.shape == (64, 64) and y.max() > 0
    for got, ref in zip(_planes(frames[0]), want):
        assert np.array_equal(got, ref)
    mixer.close()
    jclock, jmixer, jframes, jkeep = _mixer(JAX, jax_context("jax"))
    jmixer.apply(jcore.EventBox.just(_rotated(JAX)))
    jclock.step()
    jy = _y(jframes[0]).astype(int)
    inner = np.abs(y.astype(int) - jy)[8:56, 8:56]
    assert np.median(inner) <= 1
    jmixer.close()


def test_mixer_rotated_source_takes_the_frame_kernel(monkeypatch):
    """On a card context the rotated source goes into the frame kernel's one
    launch with the axis-aligned ones (no warp path): the registry hands
    every source to ``frame.composite_frame_cuda``, and the plain version is
    never called.  The launch is recorded here, not run."""
    calls = []

    def recorder(size, sources, out_fmt, *, device=None, target=None):
        calls.append((size, [u for _p, _f, u in sources], out_fmt))
        return [torch.zeros(s, dtype=torch.uint8) for s in (
            (size[1], size[0]), (size[1] // 2, size[0] // 2),
            (size[1] // 2, size[0] // 2))]

    def plain(*a, **k):
        raise AssertionError("the plain composite ran on a card context")

    monkeypatch.setattr(frame, "composite_frame_cuda", recorder)
    monkeypatch.setattr(vm_mod.composite_frame.__globals__["composite"],
                        "composite_stack_torch", plain)
    ctx = ComputeContext(device=torch.device("cpu"))
    monkeypatch.setattr(ComputeContext, "kind", property(lambda self: "cuda"))
    clock, mixer, frames, keep = _mixer(PORT, ctx)
    mixer.apply(EventBox.just(_rotated(PORT)))
    mixer.apply(EventBox.just(_source(PORT, 90, asset="b", rev="rb",
                                      rect=(0, 0, 16, 16), z=1)))
    clock.step()
    assert len(calls) == 1 and len(calls[0][1]) == 2
    assert calls[0][0] == (64, 64) and calls[0][2] == PixelFormat.y420p
    rot = interop.uniforms(calls[0][1][0])
    assert abs(rot[1]) > 0.1 and abs(rot[2]) > 0.1   # the rotation's terms
    assert frames and frames[0].buffer_type() == BufferType.gpu
    mixer.close()


def _comp(ns, elements, name="comp", scenes=None, initial="main"):
    return ns.scene.Composition(
        name=name, canvas_size=(64, 64),
        frame_duration=ns.core.TimePoint(1000, 30000),
        audio_frame_duration=ns.core.TimePoint(480, 48000),
        sample_rate=48000, channel_count=2,
        scenes=scenes or (ns.scene.Scene(name="main", elements=elements),),
        initial_scene=initial)


def _composer(ns, comp, ctx):
    clock = ns.core.StepClock(ns.core.TimePoint(480, 48000))
    audio_bus, picture_bus = ns.core.Bus(clock), ns.core.Bus(clock)
    composer = (Composer if ns is PORT else JaxComposer)(
        clock, workspace_id="w", composition=comp, audio_bus=audio_bus,
        picture_bus=picture_bus, compute_context=ctx)
    got = []
    sub = picture_bus.subscribe(ns.core.Tx(
        lambda s: (got.append(s), ns.core.EventBox.just(s))[1]
        if s.asset_id() == comp.name else ns.core.EventBox.nothing(None)))
    return clock, audio_bus, picture_bus, composer, got, sub


def _left_right(ns):
    E, S = ns.scene.Element, ns.scene.ElementState
    return (E(name="left", initial_state=S(pic_pos=(0, 0), size=(32, 64))),
            E(name="right", initial_state=S(pic_pos=(32, 0), size=(32, 64)),
              z_index=1))


def test_composer_end_to_end():
    """Buses -> animators -> mixers: a bound asset shows in its element's
    rect, 0 LSB against the JAX Composer's golden frame."""
    last = {}
    for name, ns, ctx in (("port", PORT, cpu()),
                          ("jax", JAX, jax_context("golden"))):
        clock, _a, picture_bus, composer, got, sub = _composer(
            ns, _comp(ns, _left_right(ns)), ctx)
        composer.bind("camA", "left")
        picture_bus.append(ns.core.EventBox.just(_source(ns, 220,
                                                         asset="camA")))
        for _ in range(100):
            clock.step()
        assert got
        last[name] = got[-1]
        composer.close()
    y = _y(last["port"])
    assert abs(int(y[32, 8]) - 220) <= 1 and y[32, 48] == 0
    for a, b in zip(_planes(last["port"]), _planes(last["jax"])):
        assert np.array_equal(a, b)


def test_composer_run_command_tree():
    """Recursive command trees with after-continuations
    (composer.swift:141-183)."""
    E, S = scene.Element, scene.ElementState
    comp = _comp(PORT, None, name="c", initial="a", scenes=(
        scene.Scene(name="a", elements=(E(name="e1", initial_state=S(
            size=(32, 32))),)),
        scene.Scene(name="b", elements=(E(name="e2", initial_state=S(
            size=(16, 16))),))))
    _c, _a, _p, composer, _g, _s = _composer(PORT, comp, cpu())
    cmd = ComposerCommand(
        set_scene=SetSceneCommand(scene="b"),
        after=(ComposerCommand(bind=BindCommand(asset_id="cam", element="e2"),
                               after=(ComposerCommand(set_state=SetStateCommand(
                                   element="e2",
                                   state=S(size=(20, 20)))),)),))
    fut = composer.run_command(cmd)
    assert fut.done() and fut.result() is True
    assert composer.get_element_state("e2").size == (20, 20)
    assert any(a == "cam" for a, _e in composer._bindings)
    composer.close()


def test_composer_scene_change_keeps_bound_animators():
    """An element in both scenes keeps its animators and its bound asset;
    a parked element's parent is detached (composer.swift:111-135)."""
    E, S = scene.Element, scene.ElementState
    comp = _comp(PORT, None, initial="a", scenes=(
        scene.Scene(name="a", elements=(
            E(name="stay", initial_state=S(pic_pos=(0, 0), size=(32, 64))),
            E(name="park", parent="stay", initial_state=S(size=(8, 8))))),
        scene.Scene(name="b", elements=(
            E(name="stay", initial_state=S(pic_pos=(32, 0), size=(32, 64)),
              z_index=2),))))
    clock, _a, picture_bus, composer, got, sub = _composer(PORT, comp, cpu())
    composer.bind("camA", "stay")
    pic_before = composer._elements["stay"][1]
    park_pic = composer._elements["park"][1]
    assert park_pic.parent is pic_before
    composer.set_scene("b")
    assert composer._elements["stay"][1] is pic_before
    assert pic_before.z_index == 2
    assert composer._elements["park"][1] is park_pic
    assert park_pic.parent is None
    picture_bus.append(EventBox.just(_source(PORT, 220, asset="camA")))
    for _ in range(100):
        clock.step()
    assert got
    y = _y(got[-1])
    assert abs(int(y[32, 48]) - 220) <= 1 and y[32, 8] == 0
    composer.close()


def test_bus_digest_receives_stats():
    """Digest receivers collect per-dispatch results (bus.swift:156-158)."""
    bus = Bus(StepClock(TimePoint(480, 48000)))
    digests = []
    bus.set_digest_receiver(lambda results: digests.append(results))
    sub = bus.subscribe(Tx(lambda s: EventBox.just(s)))  # noqa: F841 (weak)
    bus.append(EventBox.just(_source(PORT, 100)))
    assert digests and len(digests[0]) == 1
    assert digests[0][0].is_just()


def test_composer_snapshot_restore():
    """Scene and binding state survive a Composer restart."""
    comp = _comp(PORT, (scene.Element(name="e1", initial_state=scene.ElementState(
        size=(32, 32))),), name="c")
    _c, _a, _p, c1, _g, _s = _composer(PORT, comp, cpu())
    c1.bind("cam", "e1")
    c1.set_state("e1", scene.ElementState(size=(48, 20), pic_pos=(4, 6),
                                          transparency=0.25))
    blob = json.dumps(c1.snapshot())
    c1.close()
    _c, _a, _p, c2, _g, _s = _composer(PORT, comp, cpu())
    c2.restore(json.loads(blob))
    st = c2.get_element_state("e1")
    assert st.size == (48, 20) and st.pic_pos == (4, 6)
    assert abs(st.transparency - 0.25) < 1e-6
    assert any(a == "cam" for a, _e in c2._bindings)
    c2.close()


def test_composer_audio_leg():
    """Bus -> SRC -> SoundAnimator -> AudioMixer: the element's gain is
    applied and the asset named; every mixed frame equals the JAX
    Composer's exactly (the s16 fold's integer contract)."""
    mixed = {}
    for name, ns, ctx in (("port", PORT, cpu()),
                          ("jax", JAX, jax_context("golden"))):
        comp = _comp(ns, (ns.scene.Element(
            name="e1", initial_state=ns.scene.ElementState(
                size=(64, 64), audio_gain=1.0)),))
        clock, audio_bus, _p, composer, _g, _s = _composer(ns, comp, ctx)
        out = []
        sub = audio_bus.subscribe(ns.core.Tx(  # noqa: F841 (weak)
            lambda s, out=out: (out.append(s), ns.core.EventBox.just(s))[1]
            if s.asset_id() == "comp" else ns.core.EventBox.nothing(None)))
        composer.bind("micA", "e1")
        pts = ns.core.TimePoint(0, 48000)
        for _ in range(30):
            audio_bus.append(ns.core.EventBox.just(ns.media.AudioSample(
                buffers=(np.full(480 * 2, 1000, np.int16),), frequency=48000,
                channels=2, format=ns.media.AudioFormat.s16i,
                sample_count=480, pts_value=pts, id_asset="micA",
                id_workspace="w")))
            pts = pts + ns.core.TimePoint(480, 48000)
            clock.step()
        mixed[name] = out
        composer.close()
    port = mixed["port"]
    assert port and len(port) == len(mixed["jax"])
    tail = np.asarray(port[-1].data()[0])
    assert tail.shape == (480 * 2,) and tail.max() >= 900
    assert any(c.id_asset == "micA" for c in port[-1].constituents())
    for a, b in zip(port, mixed["jax"]):
        assert np.array_equal(np.asarray(a.data()[0]), np.asarray(b.data()[0]))
        assert (a.pts().value, a.pts().scale) == (b.pts().value, b.pts().scale)


def test_stats_report_merging():
    """StatsReport.merging combines sample buckets (stats.swift:103-109)."""
    clock = StepClock(TimePoint(1000, 1000))
    a = core.StatsReport(asset_id="a", period=TimePoint(5000, 1000),
                         clock=clock)
    b = core.StatsReport(asset_id="b", period=TimePoint(5000, 1000),
                         clock=clock)
    while clock.current() <= TimePoint(10000, 1000):
        a.add_sample("m", 1)
        b.add_sample("m", 2)
        clock.step()
    assert a.merging(b).asset_id() == "b"


def test_composer_same_asset_two_elements():
    """One asset bound to two elements: bindings are per (asset, element);
    a narrow unbind removes one."""
    clock, _a, picture_bus, composer, got, sub = _composer(
        PORT, _comp(PORT, (
            scene.Element(name="main", initial_state=scene.ElementState(
                pic_pos=(0, 0), size=(32, 64))),
            scene.Element(name="pip", initial_state=scene.ElementState(
                pic_pos=(32, 0), size=(32, 64)), z_index=1))), cpu())
    composer.bind("cam", "main")
    composer.bind("cam", "pip")
    assert len(composer._bindings) == 2
    picture_bus.append(EventBox.just(_source(PORT, 200, asset="cam")))
    for _ in range(100):
        clock.step()
    y = _y(got[-1])
    assert abs(int(y[32, 8]) - 200) <= 1 and abs(int(y[32, 48]) - 200) <= 1
    composer.unbind("cam", "pip")
    assert list(composer._bindings) == [("cam", "main")]
    composer.unbind("cam")
    assert not composer._bindings
    composer.close()


def test_composer_run_command_set_state_failure():
    """A failed set_state fails the command's future and skips its after
    continuations."""
    _c, _a, _p, composer, _g, _s = _composer(PORT, _comp(PORT, (
        scene.Element(name="e1", initial_state=scene.ElementState(
            pic_pos=(0, 0), size=(32, 32))),)), cpu())
    cmd = ComposerCommand(
        set_state=SetStateCommand(element="no-such-element",
                                  state=scene.ElementState(size=(1, 1))),
        after=(ComposerCommand(set_state=SetStateCommand(
            element="e1", state=scene.ElementState(size=(9, 9)))),))
    fut = composer.run_command(cmd)
    assert fut.done()
    with pytest.raises(ComposerError):
        fut.result()
    assert composer.get_element_state("e1").size == (32, 32)
    composer.close()


def test_scene_change_disconnects_bindings_to_absent_elements():
    """A binding to an element absent from the new scene disconnects: no
    ghost overlay from its Repeater (composer.swift:117-131)."""
    E, S = scene.Element, scene.ElementState
    bg = E(name="bg", initial_state=S(pic_pos=(0, 0), size=(64, 64)))
    comp = _comp(PORT, None, initial="a", scenes=(
        scene.Scene(name="a", elements=(bg, E(name="pip", initial_state=S(
            pic_pos=(0, 0), size=(16, 16)), z_index=1))),
        scene.Scene(name="b", elements=(bg,))))
    clock, _a, picture_bus, composer, got, sub = _composer(PORT, comp, cpu())
    composer.bind("camBG", "bg")
    composer.bind("camPIP", "pip")
    picture_bus.append(EventBox.just(_source(PORT, 40, asset="camBG")))
    picture_bus.append(EventBox.just(_source(PORT, 250, asset="camPIP")))
    for _ in range(100):
        clock.step()
    assert abs(int(_y(got[-1])[4, 4]) - 250) <= 1
    composer.set_scene("b")
    assert ("camPIP", "pip") not in composer._bindings
    assert ("camBG", "bg") in composer._bindings
    got.clear()
    for rev in ("r2", "r3", "r4", "r5"):
        picture_bus.append(EventBox.just(_source(PORT, 40, asset="camBG",
                                                 rev=rev)))
        picture_bus.append(EventBox.just(_source(PORT, 250, asset="camPIP",
                                                 rev=rev)))
        for _ in range(40):
            clock.step()
    assert abs(int(_y(got[-1])[4, 4]) - 40) <= 1
    composer.close()


def test_picture_sample_carries_into_golden_by_value():
    """A port sample's planes and format reach golden through ``interop``
    (the JAX tests hand golden their own ``PixelFormat``; a port format
    must go by value): the port's plain composite of it equals golden's."""
    src = _source(PORT, 77, size=(16, 16), rect=(8, 8, 40, 24))
    uni = rect_uniforms((16, 16), (64, 64), x=8, y=8, w=40, h=24,
                        opacity=0.7)
    want = _golden_stack((64, 64), [(src, uni)])
    from swiftvideo_tpu_torch.ops import composite
    got = composite.composite_stack_torch(
        PixelFormat.y420p, (64, 64),
        [([torch.from_numpy(p) for p in src.planes()], PixelFormat.y420p,
          uni)], torch.device("cpu"))
    assert interop.pixel_format(jmedia.PixelFormat.y420p) is PixelFormat.y420p
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), w)
