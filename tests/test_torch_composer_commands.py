"""The port's Composer command surface: twins of
``tests/test_composer_commands.py``, each case of the JAX package's file
retargeted at ``swiftvideo_tpu_torch`` with its assertions unchanged.  The
Composer runs on a ``"cpu"`` context (the JAX cases use ``"golden"``).

Covered: the media command variants (loadFile / playFile / stopFile /
setText), the app ``action`` delegation hook, and their
RpcComposerCommand wire converters (composer.swift:141-183,
Rpc.public.proto:40-79).  The file-source cases run ``tests/mock_ffmpeg.py``
as the ffmpeg binary (``SWIFTVIDEO_FFMPEG``); it lies beside this file.
"""

import os
from concurrent.futures import Future

import numpy as np
import pytest

from swiftvideo_tpu_torch.compose import (
    BindCommand, Composer, ComposerCommand, Composition, Element,
    ElementState, LoadCommand, PlayFileCommand, Scene, SetSceneCommand,
    SetStateCommand, SetTextCommand, StopFileCommand, UnbindCommand,
    command_from_json, command_to_json)
from swiftvideo_tpu_torch.core import Bus, EventBox, StepClock, TimePoint, Tx
from swiftvideo_tpu_torch.ops.registry import make_compute_context

MOCK_FFMPEG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "mock_ffmpeg.py")


@pytest.fixture
def mock_ffmpeg(monkeypatch):
    monkeypatch.setenv("SWIFTVIDEO_FFMPEG", MOCK_FFMPEG)
    return MOCK_FFMPEG


def _write_mockav(path, w=32, h=16, n_frames=5, rate=48000, ch=2,
                  n_samples=3072):
    fsize = w * h * 3 // 2
    video = b"".join(bytes([(10 * i + 5) % 250]) * fsize
                     for i in range(n_frames))
    pcm = np.arange(n_samples * ch, dtype=np.int16)
    path.write_bytes(
        f"MOCKAV {w} {h} 25 1 {n_frames} {rate} {ch} {n_samples}\n"
        .encode() + video + pcm.tobytes())


def _composition():
    return Composition(
        name="comp", canvas_size=(64, 64),
        frame_duration=TimePoint(1000, 30000),
        audio_frame_duration=TimePoint(480, 48000),
        sample_rate=48000, channel_count=2,
        scenes=(Scene(name="main", elements=(
            Element(name="screen", initial_state=ElementState(
                pic_pos=(0, 0), size=(64, 64))),
            Element(name="overlay", initial_state=ElementState(
                pic_pos=(0, 48), size=(64, 16)), z_index=1),
        )),),
        initial_scene="main")


def _composer(clock):
    return Composer(clock, workspace_id="w", composition=_composition(),
                    audio_bus=Bus(clock), picture_bus=Bus(clock),
                    compute_context=make_compute_context("cpu"))


# --- JSON roundtrip of the new variants ------------------------------------

def test_command_json_roundtrip_media_variants():
    cmd = ComposerCommand(
        load_file=LoadCommand(uri="/media/a.mp4", asset_id="clip",
                              loop=True, autoplay=True, close_on_end=False),
        after=(
            ComposerCommand(play_file=PlayFileCommand(asset_id="clip")),
            ComposerCommand(stop_file=StopFileCommand(asset_id="clip")),
            ComposerCommand(set_text=SetTextCommand(
                value="LIVE", font_size=18, asset_id="txt",
                color=(1.0, 0.25, 0.0, 1.0))),
            ComposerCommand(set_state=SetStateCommand(
                element="screen", state_id="fullscreen",
                duration=TimePoint(250, 1000))),
        ))
    assert command_from_json(command_to_json(cmd)) == cmd


# --- protobuf wire converters ----------------------------------------------

@pytest.mark.skipif(
    not __import__("swiftvideo_tpu_torch.proto", fromlist=["available"]).available(),
    reason="google.protobuf not available")
def test_composer_command_proto_roundtrip():
    from swiftvideo_tpu_torch import proto as svproto
    cmds = (
        ComposerCommand(set_scene=SetSceneCommand(scene="b"), ident=7,
                        after=(ComposerCommand(
                            bind=BindCommand(asset_id="cam", element="e")),)),
        ComposerCommand(load_file=LoadCommand(
            uri="file:///x.mp4", asset_id="clip", workspace_token="tok",
            loop=False, autoplay=True, close_on_end=True)),
        ComposerCommand(play_file=PlayFileCommand(asset_id="clip")),
        ComposerCommand(stop_file=StopFileCommand(asset_id="clip")),
        ComposerCommand(set_text=SetTextCommand(
            value="hello", font_size=32, font_url="/f.ttf", asset_id="txt",
            color=(0.5, 0.25, 0.125, 1.0))),
        ComposerCommand(set_state=SetStateCommand(
            element="e", state_id="s1", duration=TimePoint(100, 1000))),
    )
    data = svproto.composer_command_to_wire(cmds)
    back = svproto.composer_command_from_wire(data)
    assert back == cmds


@pytest.mark.skipif(
    not __import__("swiftvideo_tpu_torch.proto", fromlist=["available"]).available(),
    reason="google.protobuf not available")
def test_composer_command_wire_rejects_unrepresentable():
    from swiftvideo_tpu_torch import proto as svproto
    # a raw ElementState has no wire form (StateSet carries a stateId)
    with pytest.raises(ValueError):
        svproto.composer_command_to_wire(ComposerCommand(
            set_state=SetStateCommand(element="e", state=ElementState())))
    # unbind does not exist in the reference protocol
    with pytest.raises(ValueError):
        svproto.composer_command_to_wire(ComposerCommand(
            unbind=UnbindCommand(asset_id="cam")))


@pytest.mark.skipif(
    not __import__("swiftvideo_tpu_torch.proto", fromlist=["available"]).available(),
    reason="google.protobuf not available")
def test_composer_command_wire_field_numbers():
    """The oneof field numbers ARE the interop contract
    (Rpc.public.proto:67-78): scene=3, elementState=4, bind=5,
    loadFile=6, playFile=7, stopFile=8, setText=9 inside Command,
    commands=1 at top, after=1 / ident=2 in Command."""
    from swiftvideo_tpu_torch import proto as svproto
    m = svproto.composer_command_to_pb(ComposerCommand(
        play_file=PlayFileCommand(asset_id="a"), ident=3))
    node = m.commands[0]
    assert node.DESCRIPTOR.fields_by_name["playFile"].number == 7
    assert node.DESCRIPTOR.fields_by_name["loadFile"].number == 6
    assert node.DESCRIPTOR.fields_by_name["setText"].number == 9
    assert node.DESCRIPTOR.fields_by_name["after"].number == 1
    assert m.DESCRIPTOR.fields_by_name["commands"].number == 1


# --- named states (wire StateSet) -------------------------------------------

def test_set_state_by_id_resolves_registered_state():
    clock = StepClock(TimePoint(480, 48000))
    composer = _composer(clock)
    composer.register_states("screen",
                             {"small": ElementState(size=(8.0, 8.0))})
    fut = composer.run_command(ComposerCommand(set_state=SetStateCommand(
        element="screen", state_id="small")))
    assert fut.done() and fut.result() is True
    assert composer.get_element_state("screen").size == (8.0, 8.0)
    # unknown id fails the command future (and skips after)
    ran = []
    fut = composer.run_command(ComposerCommand(
        set_state=SetStateCommand(element="screen", state_id="nope"),
        after=(ComposerCommand(set_scene=SetSceneCommand(scene="main")),)))
    assert fut.exception() is not None
    assert not ran
    composer.close()


# --- action delegation hook --------------------------------------------------

def test_action_claims_media_commands():
    """An action returning a Future owns the command; the built-in handler
    must not run, and `after` waits for the future
    (composer.swift:158-163)."""
    clock = StepClock(TimePoint(480, 48000))
    composer = _composer(clock)
    seen, gate = [], Future()

    def action(cmd):
        if cmd.load_file is not None:
            seen.append(cmd.load_file.asset_id)
            return gate
        return None

    order = []
    tree = ComposerCommand(
        load_file=LoadCommand(uri="app://special", asset_id="clip"),
        after=(ComposerCommand(
            bind=BindCommand(asset_id="clip", element="screen")),))
    fut = composer.run_command(tree, action)
    assert seen == ["clip"]
    assert "clip" not in composer._file_assets       # built-in skipped
    assert not fut.done()                            # waiting on the app
    assert not any(a == "clip" for a, _e in composer._bindings)
    gate.set_result(True)
    assert fut.result(timeout=1) is True
    assert any(a == "clip" for a, _e in composer._bindings)
    del order
    composer.close()


def test_action_decline_falls_through_to_builtin(tmp_path, mock_ffmpeg):
    """action returning None -> built-in Load handler runs."""
    clip = tmp_path / "clip.mockav"
    _write_mockav(clip)
    clock = StepClock(TimePoint(480, 48000))
    composer = _composer(clock)
    calls = []
    fut = composer.run_command(
        ComposerCommand(load_file=LoadCommand(uri=str(clip),
                                              asset_id="clip")),
        action=lambda cmd: calls.append(1) and None)
    assert fut.result(timeout=1) is True
    assert calls and "clip" in composer._file_assets
    composer.close()


# --- built-in handlers: end-to-end command-driven composition ----------------

def test_command_tree_drives_composition(tmp_path, mock_ffmpeg):
    """The VERDICT e2e: drive a composition purely by command tree —
    load a .mockav with autoplay, bind it into an element, overlay text,
    then unbind — and check the mixed frames show both."""
    clip = tmp_path / "clip.mockav"
    _write_mockav(clip, w=32, h=16, n_frames=50)
    clock = StepClock(TimePoint(480, 48000))
    audio_bus, picture_bus = Bus(clock), Bus(clock)
    composer = Composer(clock, workspace_id="w", composition=_composition(),
                        audio_bus=audio_bus, picture_bus=picture_bus,
                        compute_context=make_compute_context("cpu"))
    mixed = []
    sub = picture_bus.subscribe(Tx(
        lambda s: (mixed.append(s), EventBox.just(s))[1]
        if s.asset_id() == "comp" else EventBox.nothing(None)))

    tree = ComposerCommand(
        load_file=LoadCommand(uri=str(clip), asset_id="clip",
                              autoplay=True),
        after=(
            ComposerCommand(bind=BindCommand(asset_id="clip",
                                             element="screen")),
            ComposerCommand(
                set_text=SetTextCommand(value="LIVE", font_size=12,
                                        asset_id="txt",
                                        color=(1.0, 1.0, 1.0, 1.0)),
                after=(ComposerCommand(bind=BindCommand(
                    asset_id="txt", element="overlay")),)),
        ))
    fut = composer.run_command(tree)
    assert fut.result(timeout=2) is True
    assert "clip" in composer._file_assets
    assert "txt" in composer._text_assets

    for _ in range(120):          # 1.2 s: pacing emit-ahead is 250 ms
        clock.step()
    assert mixed, "command-driven composition produced no frames"
    y = np.asarray(mixed[-1].planes()[0])
    # the clip's frames are flat gray ramps (>=5); the screen element
    # covers the full canvas, so the top half must be non-zero
    assert y[8, 8] >= 4
    # the text overlay writes glyph pixels into rows 48..64
    assert int(np.asarray(y[48:64]).max()) > 60

    # unbind ends the clip's contribution
    composer.run_command(ComposerCommand(
        unbind=UnbindCommand(asset_id="clip")))
    assert not any(a == "clip" for a, _e in composer._bindings)
    del sub
    composer.close()


def test_play_stop_file(tmp_path, mock_ffmpeg):
    clip = tmp_path / "clip.mockav"
    # long enough that the 2 s read-ahead cannot drain it at play() time
    _write_mockav(clip, n_frames=200, n_samples=48000 * 8)
    clock = StepClock(TimePoint(480, 48000))
    composer = _composer(clock)
    fut = composer.run_command(ComposerCommand(load_file=LoadCommand(
        uri=str(clip), asset_id="clip")))      # autoplay=False
    assert fut.result(timeout=1) is True
    srcs = composer._file_assets["clip"][0]
    assert all(not s._playing for s in srcs)
    assert composer.run_command(ComposerCommand(
        play_file=PlayFileCommand(asset_id="clip"))).result(timeout=1)
    assert all(s._playing for s in srcs)
    assert composer.run_command(ComposerCommand(
        stop_file=StopFileCommand(asset_id="clip"))).result(timeout=1)
    assert all(not s._playing for s in srcs)
    # unknown asset fails
    fut = composer.run_command(ComposerCommand(
        play_file=PlayFileCommand(asset_id="ghost")))
    assert fut.exception() is not None
    composer.close()


def test_load_close_on_end_unloads(tmp_path, mock_ffmpeg):
    clip = tmp_path / "clip.mockav"
    _write_mockav(clip, n_frames=3, n_samples=1024)   # drains quickly
    clock = StepClock(TimePoint(480, 48000))
    composer = _composer(clock)
    fut = composer.run_command(ComposerCommand(load_file=LoadCommand(
        uri=str(clip), asset_id="clip", autoplay=True, close_on_end=True)))
    assert fut.result(timeout=2) is True
    for _ in range(400):          # 4 s >> 3 frames @25fps + read-ahead
        clock.step()
        if "clip" not in composer._file_assets:
            break
    assert "clip" not in composer._file_assets
    composer.close()


def test_load_duplicate_asset_rejected(tmp_path, mock_ffmpeg):
    clip = tmp_path / "clip.mockav"
    _write_mockav(clip)
    clock = StepClock(TimePoint(480, 48000))
    composer = _composer(clock)
    assert composer.run_command(ComposerCommand(load_file=LoadCommand(
        uri=str(clip), asset_id="clip"))).result(timeout=1)
    fut = composer.run_command(ComposerCommand(load_file=LoadCommand(
        uri=str(clip), asset_id="clip")))
    assert fut.exception() is not None
    composer.close()


def test_set_text_before_bind_latches(tmp_path):
    """setText then bind (either order) must latch the overlay: bind
    re-publishes the stored sample for the fresh Repeater."""
    clock = StepClock(TimePoint(480, 48000))
    audio_bus, picture_bus = Bus(clock), Bus(clock)
    composer = Composer(clock, workspace_id="w", composition=_composition(),
                        audio_bus=audio_bus, picture_bus=picture_bus,
                        compute_context=make_compute_context("cpu"))
    mixed = []
    sub = picture_bus.subscribe(Tx(
        lambda s: (mixed.append(s), EventBox.just(s))[1]
        if s.asset_id() == "comp" else EventBox.nothing(None)))
    assert composer.run_command(ComposerCommand(set_text=SetTextCommand(
        value="X", font_size=12, asset_id="txt"))).result(timeout=1)
    assert composer.run_command(ComposerCommand(
        bind=BindCommand(asset_id="txt", element="overlay"))).result(
            timeout=1)
    for _ in range(60):
        clock.step()
    assert mixed
    y = np.asarray(mixed[-1].planes()[0])
    assert int(y[48:64].max()) > 60
    del sub
    composer.close()


# --- regressions: looping, continuations, reaping ----------------------------


def test_load_loop_reopens_deferred_not_recursive(tmp_path, mock_ffmpeg):
    """loop=True on a clip shorter than the read-ahead window must re-open
    on a scheduled clock event, never recursively inside play(): the old
    path opened generation after generation in one call stack until
    RecursionError, then silently dropped the asset."""
    import sys

    clip = tmp_path / "clip.mockav"
    _write_mockav(clip, n_frames=3, n_samples=1024)   # ~0.12 s << 2 s
    clock = StepClock(TimePoint(480, 48000))
    composer = _composer(clock)
    limit = sys.getrecursionlimit()
    sys.setrecursionlimit(120)        # would trip the recursive re-open
    try:
        fut = composer.run_command(ComposerCommand(load_file=LoadCommand(
            uri=str(clip), asset_id="clip", autoplay=True, loop=True)))
        assert fut.result(timeout=2) is True
        generations = {id(composer._file_assets["clip"])}
        for _ in range(600):          # ~6 s of clock: many loop restarts
            clock.step()
            entry = composer._file_assets.get("clip")
            assert entry is not None, "looping asset vanished"
            generations.add(id(entry))
    finally:
        sys.setrecursionlimit(limit)
    assert len(generations) >= 3, "loop never re-opened"
    composer.close()


def test_run_command_continuation_error_fails_future():
    """A continuation raising inside a Future callback (here: bind of an
    unknown element behind an action-claimed future) must fail the
    command future, not hang it."""
    from concurrent.futures import Future

    clock = StepClock(TimePoint(480, 48000))
    composer = _composer(clock)
    app_fut: Future = Future()

    def action(cmd):
        return app_fut if cmd.bind is not None else None

    fut = composer.run_command(ComposerCommand(
        bind=BindCommand(asset_id="cam", element="MISSING")), action=action)
    assert not fut.done()
    app_fut.set_result(True)          # do_bind now raises ComposerError
    exc = fut.exception(timeout=2)
    assert exc is not None and "MISSING" in str(exc)
    composer.close()


def test_unload_and_close_reap_file_sources(tmp_path, mock_ffmpeg):
    """unload_asset and Composer.close must close() the demux sources
    (reaping their subprocesses), not merely stop() pacing."""
    clip = tmp_path / "clip.mockav"
    _write_mockav(clip, n_frames=200, n_samples=48000 * 4)
    clock = StepClock(TimePoint(480, 48000))
    composer = _composer(clock)
    closed = []
    for i, name in enumerate(("a", "b")):
        assert composer.run_command(ComposerCommand(load_file=LoadCommand(
            uri=str(clip), asset_id=name, autoplay=True))).result(timeout=2)
        for src in composer._file_assets[name][0]:
            orig = src.on_close
            src.on_close = (lambda o=orig, n=name:
                            (closed.append(n), o and o())[0] or None)
    composer.unload_asset("a")
    assert closed.count("a") == 2 and "b" not in closed   # video + audio
    composer.close()                  # reaps the rest
    assert closed.count("b") == 2


def test_synthetic_source_close_idempotent():
    from swiftvideo_tpu_torch.codec.file_source import SyntheticSource

    clock = StepClock(TimePoint(480, 48000))
    src = SyntheticSource(clock, lambda i: None,
                          frame_duration=TimePoint(1000, 30000))
    calls = []
    src.on_close = lambda: calls.append(1)
    src.close()
    src.close()
    assert calls == [1]
