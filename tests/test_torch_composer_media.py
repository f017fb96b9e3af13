"""The port's Composer media commands (Load / PlayFile / StopFile /
SetText) and a codec-fed station against the JAX package's, on the CPU.

Twins of the media cases of ``tests/test_composer_commands.py`` and of
``tests/test_live_station.py`` without its RTMP hops (``net/`` is not
ported yet): each case drives both packages' Composers with the same
commands over the same ``.mockav`` file or mock-encoded cameras
(``tests/mock_ffmpeg.py`` runs as the ffmpeg binary, a lossless stored
codec), on the same StepClock ticks.  The port runs on a ``"cpu"``
context, the JAX package on ``"golden"``.  Compared: command results, the
file sources' state, the mixed frames (within 1 LSB, the composite
contract) and the mixed PCM (exactly).
"""

import os
from concurrent.futures import Future
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import swiftvideo_tpu.codec as jax_codec
import swiftvideo_tpu.compose as jax_compose
import swiftvideo_tpu.core as jax_core
import swiftvideo_tpu.media as jax_media
from swiftvideo_tpu.ops.registry import make_compute_context as jax_context
import swiftvideo_tpu_torch.codec as port_codec
import swiftvideo_tpu_torch.compose as port_compose
import swiftvideo_tpu_torch.core as port_core
import swiftvideo_tpu_torch.media as port_media
from swiftvideo_tpu_torch.ops import make_compute_context

JAX = SimpleNamespace(codec=jax_codec, cp=jax_compose, core=jax_core,
                      media=jax_media, ctx=lambda: jax_context("golden"))
PORT = SimpleNamespace(codec=port_codec, cp=port_compose, core=port_core,
                       media=port_media, ctx=lambda: make_compute_context(
                           "cpu"))
MOCK_FFMPEG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "mock_ffmpeg.py")
TOL = 1


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for the port's small tensors: a tick is many tiny
    torch ops, which contend with the other test workers for the cores when
    each takes the whole thread pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
    path.write_bytes(f"MOCKAV {w} {h} 25 1 {n_frames} {rate} {ch} "
                     f"{n_samples}\n".encode() + video + pcm.tobytes())


def _composition(m):
    cp, TP = m.cp, m.core.TimePoint
    return cp.Composition(
        name="comp", canvas_size=(64, 64), frame_duration=TP(1000, 30000),
        audio_frame_duration=TP(480, 48000), sample_rate=48000,
        channel_count=2,
        scenes=(cp.Scene(name="main", elements=(
            cp.Element(name="screen", initial_state=cp.ElementState(
                pic_pos=(0, 0), size=(64, 64))),
            cp.Element(name="overlay", initial_state=cp.ElementState(
                pic_pos=(0, 48), size=(64, 16)), z_index=1),
        )),), initial_scene="main")


class Station:
    """One package's Composer on a StepClock, collecting its mixed frames
    and audio."""

    def __init__(self, m):
        self.m = m
        self.clock = m.core.StepClock(m.core.TimePoint(480, 48000))
        self.audio_bus = m.core.Bus(self.clock)
        self.picture_bus = m.core.Bus(self.clock)
        self.composer = m.cp.Composer(
            self.clock, workspace_id="w", composition=_composition(m),
            audio_bus=self.audio_bus, picture_bus=self.picture_bus,
            compute_context=m.ctx())
        self.frames, self.audio = [], []
        Tx, EventBox = m.core.Tx, m.core.EventBox
        self._keep = [
            self.picture_bus.subscribe(Tx(
                lambda s: (self.frames.append(s), EventBox.just(s))[1]
                if s.asset_id() == "comp" else EventBox.nothing(None))),
            self.audio_bus.subscribe(Tx(
                lambda s: (self.audio.append(s), EventBox.just(s))[1]
                if s.asset_id() == "comp" else EventBox.nothing(None)))]

    def run(self, command, action=None):
        return self.composer.run_command(command, action)

    def step(self, n):
        for _ in range(n):
            self.clock.step()

    def luma(self, k=-1):
        return np.asarray(self.frames[k].planes()[0]).astype(int)

    def pcm(self):
        return [np.asarray(a.data()[0]).tolist() for a in self.audio]

    def close(self):
        self.composer.close()


def _cmd(m, **kw):
    return m.cp.ComposerCommand(**kw)


def test_action_claims_media_commands():
    """An action's future owns the command: no built-in handler runs, and
    ``after`` waits for the future, in both packages."""
    def run(m):
        st = Station(m)
        seen, gate = [], Future()

        def action(cmd):
            if cmd.load_file is not None:
                seen.append(cmd.load_file.asset_id)
                return gate
            return None
        fut = st.run(_cmd(m, load_file=m.cp.LoadCommand(
            uri="app://special", asset_id="clip"),
            after=(_cmd(m, bind=m.cp.BindCommand(asset_id="clip",
                                                 element="screen")),)),
            action)
        before = (seen[:], "clip" in st.composer._file_assets, fut.done(),
                  any(a == "clip" for a, _e in st.composer._bindings))
        gate.set_result(True)
        out = before + (fut.result(timeout=1), any(
            a == "clip" for a, _e in st.composer._bindings))
        st.close()
        return out
    ours = run(PORT)
    assert ours == (["clip"], False, False, False, True, True)
    assert ours == run(JAX)


def test_action_decline_falls_through_to_builtin(tmp_path, mock_ffmpeg):
    clip = tmp_path / "clip.mockav"
    _write_mockav(clip)

    def run(m):
        st = Station(m)
        calls = []
        fut = st.run(_cmd(m, load_file=m.cp.LoadCommand(uri=str(clip),
                                                        asset_id="clip")),
                     action=lambda cmd: calls.append(1) and None)
        out = (fut.result(timeout=1), calls, "clip" in st.composer._file_assets)
        st.close()
        return out
    ours = run(PORT)
    assert ours == (True, [1], True)
    assert ours == run(JAX)


def test_command_tree_drives_composition(tmp_path, mock_ffmpeg):
    """Load with autoplay, bind, SetText into the overlay, then unbind:
    the mixed frames show the clip and the text, within 1 LSB of the JAX
    Composer's, and the mixed audio is equal."""
    clip = tmp_path / "clip.mockav"
    _write_mockav(clip, n_frames=50)

    def run(m):
        st = Station(m)
        cp = m.cp
        fut = st.run(_cmd(
            m, load_file=cp.LoadCommand(uri=str(clip), asset_id="clip",
                                        autoplay=True),
            after=(_cmd(m, bind=cp.BindCommand(asset_id="clip",
                                               element="screen")),
                   _cmd(m, set_text=cp.SetTextCommand(
                       value="LIVE", font_size=12, asset_id="txt",
                       color=(1.0, 1.0, 1.0, 1.0)),
                       after=(_cmd(m, bind=cp.BindCommand(
                           asset_id="txt", element="overlay")),)))))
        assert fut.result(timeout=2) is True
        assert {"clip"} <= set(st.composer._file_assets)
        assert "txt" in st.composer._text_assets
        st.step(120)
        st.run(_cmd(m, unbind=cp.UnbindCommand(asset_id="clip")))
        bound = any(a == "clip" for a, _e in st.composer._bindings)
        st.close()
        return st, bound
    ours, bound = run(PORT)
    theirs, _ = run(JAX)
    assert not bound and ours.frames
    y = ours.luma()
    assert y[8, 8] >= 4 and int(y[48:64].max()) > 60
    assert len(ours.frames) == len(theirs.frames)
    for k in range(len(ours.frames)):
        assert np.abs(ours.luma(k) - theirs.luma(k)).max() <= TOL
    assert ours.pcm() == theirs.pcm() and ours.audio


def test_play_stop_file(tmp_path, mock_ffmpeg):
    clip = tmp_path / "clip.mockav"
    _write_mockav(clip, n_frames=200, n_samples=48000 * 8)

    def run(m):
        st = Station(m)
        cp = m.cp
        states = [st.run(_cmd(m, load_file=cp.LoadCommand(
            uri=str(clip), asset_id="clip"))).result(timeout=1)]
        srcs = st.composer._file_assets["clip"][0]
        states.append([s._playing for s in srcs])
        for kind, command in (("play_file", cp.PlayFileCommand),
                              ("stop_file", cp.StopFileCommand)):
            states.append(st.run(_cmd(m, **{kind: command(
                asset_id="clip")})).result(timeout=1))
            states.append([s._playing for s in srcs])
        ghost = st.run(_cmd(m, play_file=cp.PlayFileCommand(asset_id="ghost")))
        states.append(type(ghost.exception()).__name__)
        st.close()
        return states
    ours = run(PORT)
    assert ours == [True, [False, False], True, [True, True], True,
                    [False, False], "ComposerError"]
    assert ours == run(JAX)


def test_load_close_on_end_and_duplicate(tmp_path, mock_ffmpeg):
    """close_on_end drops a drained asset; a second Load of a loaded
    asset id fails."""
    short, clip = tmp_path / "short.mockav", tmp_path / "clip.mockav"
    _write_mockav(short, n_frames=3, n_samples=1024)
    _write_mockav(clip)

    def run(m):
        st = Station(m)
        cp = m.cp
        out = [st.run(_cmd(m, load_file=cp.LoadCommand(
            uri=str(short), asset_id="s", autoplay=True,
            close_on_end=True))).result(timeout=2)]
        for n in range(400):
            st.step(1)
            if "s" not in st.composer._file_assets:
                break
        out.append("s" in st.composer._file_assets)
        out.append(st.run(_cmd(m, load_file=cp.LoadCommand(
            uri=str(clip), asset_id="clip"))).result(timeout=1))
        dup = st.run(_cmd(m, load_file=cp.LoadCommand(uri=str(clip),
                                                      asset_id="clip")))
        out.append(type(dup.exception()).__name__)
        st.close()
        return out, n
    ours, steps = run(PORT)
    assert ours == [True, False, True, "ComposerError"]
    assert (ours, steps) == run(JAX)


def test_set_text_before_bind_latches():
    def run(m):
        st = Station(m)
        cp = m.cp
        assert st.run(_cmd(m, set_text=cp.SetTextCommand(
            value="X", font_size=12, asset_id="txt"))).result(timeout=1)
        assert st.run(_cmd(m, bind=cp.BindCommand(
            asset_id="txt", element="overlay"))).result(timeout=1)
        st.step(60)
        st.close()
        return st
    ours, theirs = run(PORT), run(JAX)
    assert ours.frames and int(ours.luma()[48:64].max()) > 60
    assert len(ours.frames) == len(theirs.frames)
    assert np.abs(ours.luma() - theirs.luma()).max() <= TOL


def test_load_loop_reopens_and_close_reaps(tmp_path, mock_ffmpeg):
    """loop=True re-opens a short clip on clock events, and unload_asset
    and close() close every demux source, in both packages."""
    short, clip = tmp_path / "short.mockav", tmp_path / "clip.mockav"
    _write_mockav(short, n_frames=3, n_samples=1024)
    _write_mockav(clip, n_frames=200, n_samples=48000 * 4)

    def run(m):
        st = Station(m)
        cp = m.cp
        assert st.run(_cmd(m, load_file=cp.LoadCommand(
            uri=str(short), asset_id="loop", autoplay=True,
            loop=True))).result(timeout=2)
        generations = {id(st.composer._file_assets["loop"])}
        for _ in range(600):       # 6 s of clock at most
            if len(generations) >= 3:
                break
            st.step(1)
            generations.add(id(st.composer._file_assets["loop"]))
        closed = []
        for name in ("a", "b"):
            assert st.run(_cmd(m, load_file=cp.LoadCommand(
                uri=str(clip), asset_id=name,
                autoplay=True))).result(timeout=2)
            for src in st.composer._file_assets[name][0]:
                orig = src.on_close
                src.on_close = (lambda o=orig, n=name:
                                (closed.append(n), o and o())[0] or None)
        st.composer.unload_asset("a")
        after_unload = sorted(closed)
        st.close()
        return len(generations) >= 3, after_unload, sorted(closed), \
            sorted(st.composer._file_assets)
    ours = run(PORT)
    assert ours == (True, ["a", "a"], ["a", "a", "b", "b"], [])
    assert ours == run(JAX)


def _encode_cam(m, fmt, luma, asset, n):
    enc = m.codec.VideoEncoder(getattr(m.media.MediaFormat, fmt))
    frames = []
    for i in range(n):
        pict = m.media.create_picture_sample((48, 28),
                                             m.media.PixelFormat.y420p,
                                             asset_id=asset, workspace_id="w")
        pict.planes()[0][:] = luma
        pict.planes()[1][:] = 128
        pict.planes()[2][:] = 128
        frames.append(pict.with_(pts=m.core.TimePoint(i * 33, 1000)))
    return _drain(enc, frames)


def _encode_cam_audio(m, fmt, amp, asset, n):
    enc = m.codec.AudioEncoder(getattr(m.media.MediaFormat, fmt),
                               frame_size=1024)
    return _drain(enc, [m.media.AudioSample(
        buffers=(np.full(2048, amp, np.int16),), frequency=48000, channels=2,
        format=m.media.AudioFormat.s16i, sample_count=1024, id_asset=asset,
        id_workspace="w", pts_value=m.core.TimePoint(i * 1024, 48000))
        for i in range(n)])


def _drain(stage, items):
    out = []
    for item in items:
        box = stage(item)
        if box.is_just():
            v = box.value()
            out.extend(v if isinstance(v, list) else [v])
    out.extend(stage.flush())
    stage.close()
    return out


def _station(m, vfmt, afmt):
    """Two cameras encoded as ``vfmt`` / ``afmt``, decoded onto the buses,
    mixed by the Composer into the left and right halves of a 96x56 canvas,
    the mixed frames and audio encoded again (the live-station topology
    without its RTMP hops).  Returns the decoded program frames and PCM."""
    cp, core = m.cp, m.core
    comp = cp.Composition(
        name="program", canvas_size=(96, 56),
        frame_duration=core.TimePoint(1000, 30000),
        audio_frame_duration=core.TimePoint(480, 48000), sample_rate=48000,
        channel_count=2,
        scenes=(cp.Scene(name="main", elements=(
            cp.Element(name="left", z_index=0, initial_state=cp.ElementState(
                pic_pos=(0, 0), size=(48, 28))),
            cp.Element(name="right", z_index=1,
                       initial_state=cp.ElementState(pic_pos=(48, 28),
                                                     size=(48, 28))))),),
        initial_scene="main")
    clock = core.StepClock(core.TimePoint(480, 48000))
    audio_bus, picture_bus = core.Bus(clock), core.Bus(clock)
    composer = cp.Composer(clock, workspace_id="w", composition=comp,
                           audio_bus=audio_bus, picture_bus=picture_bus,
                           compute_context=m.ctx())
    out_v, out_a = [], []
    venc = m.codec.VideoEncoder(getattr(m.media.MediaFormat, vfmt))
    aenc = m.codec.AudioEncoder(getattr(m.media.MediaFormat, afmt),
                                frame_size=1024)
    flat, Tx, EventBox = m.codec.flat, core.Tx, core.EventBox

    def collect(out):
        return flat(Tx(lambda s: (out.append(s), EventBox.nothing(None))[1]))

    keep = [picture_bus.subscribe(core.asset_filter("program") >> flat(venc)
                                  >> collect(out_v)),
            audio_bus.subscribe(core.asset_filter("program") >> flat(aenc)
                                >> collect(out_a))]
    composer.bind("cam1", "left")
    composer.bind("cam2", "right")
    cams = [(name, _encode_cam(m, vfmt, luma, name, 30),
             _encode_cam_audio(m, afmt, amp, name, 45),
             m.codec.VideoDecoder(), m.codec.AudioDecoder(), [0])
            for name, luma, amp in (("cam1", 60, 1000), ("cam2", 180, 3000))]

    def feed(bus, box, name):
        if box.is_just():
            v = box.value()
            for item in (v if isinstance(v, list) else [v]):
                bus.append(EventBox.just(item.with_(asset_id=name)))

    for i in range(30):
        for name, coded, coded_a, vdec, adec, aidx in cams:
            feed(picture_bus, vdec(coded[i]), name)
            while (aidx[0] < len(coded_a)
                   and aidx[0] * 1024 * 1000 <= (i + 1) * 33 * 48000):
                feed(audio_bus, adec(coded_a[aidx[0]]), name)
                aidx[0] += 1
        for _ in range(3):
            clock.step()
    for _ in range(20):
        clock.step()
    composer.close()
    for _n, _c, _a, vdec, adec, _i in cams:
        vdec.close()
        adec.close()
    out_v.extend(venc.flush())
    venc.close()
    out_a.extend(aenc.flush())
    aenc.close()
    del keep
    frames = _drain(m.codec.VideoDecoder(), out_v)
    pcm = _drain(m.codec.AudioDecoder(), out_a)
    return ([np.asarray(f.planes()[0]).astype(int) for f in frames],
            np.concatenate([np.asarray(a.data()[0]) for a in pcm]))


def _probe(y):
    """The JAX live-station test's probes: each camera in its element,
    the background clear."""
    assert abs(y[10, 10] - 60) <= 1 and abs(y[42, 70] - 180) <= 1
    assert y[10, 70] <= 1 and y[42, 10] <= 1


def test_codec_fed_station_equals_jax():
    """Uncompressed codec (synchronous, so the two runs see the same
    ticks): every program frame within 1 LSB of the JAX package's, the
    mixed PCM equal sample for sample."""
    ours_v, ours_a = _station(PORT, "uncompressed", "uncompressed")
    theirs_v, theirs_a = _station(JAX, "uncompressed", "uncompressed")
    assert len(ours_v) == len(theirs_v) >= 20
    for a, b in zip(ours_v, theirs_v):
        assert np.abs(a - b).max() <= TOL
    _probe(ours_v[-1])
    assert np.array_equal(ours_a, theirs_a)
    # both cameras at unity gain mix to exactly 1000 + 3000 while both
    # play; silence before they join and after they end
    assert set(np.unique(ours_a)) <= {0, 1000, 3000, 4000}
    assert (ours_a == 4000).mean() > 0.8


def test_codec_fed_station_through_the_mock_binary(mock_ffmpeg):
    """AVC and AAC legs through the mock ffmpeg subprocesses, whose
    decoders may lag a packet, so the two runs need not see the same
    ticks: the steady state is compared, the last program frame within
    1 LSB of the JAX package's, and in both packages' PCM only the exact
    mix levels, most of it both cameras' 1000 + 3000."""
    ours_v, ours_a = _station(PORT, "avc", "aac")
    theirs_v, theirs_a = _station(JAX, "avc", "aac")
    assert len(ours_v) >= 20 and len(theirs_v) >= 20
    _probe(ours_v[-1])
    assert np.abs(ours_v[-1] - theirs_v[-1]).max() <= TOL
    for pcm in (ours_a, theirs_a):
        values, counts = np.unique(pcm, return_counts=True)
        assert set(values.tolist()) <= {0, 1000, 3000, 4000}
        assert values[counts.argmax()] == 4000
