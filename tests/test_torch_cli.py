"""Twin of ``tests/test_cli.py`` on the port: ``python -m
swiftvideo_tpu_torch`` mix, transcode, probe, serve, under
``SV_DEVICE=cpu`` (the port's commands otherwise need a card), then the
port's outputs against the JAX CLI's: ``mix`` frames within 1 LSB, its
RGBA conversion within 1 LSB of golden, its PNGs read back by cv2 as the
image written, ``transcode`` and ``probe`` outputs byte-equal.

CLI tests (python -m swiftvideo_tpu_torch ...): mix, transcode, probe, serve.

The reference's user-facing flows live in compiled Examples
(Examples/Mixing/main.swift etc.); the CLI wraps the same graphs, so
these tests drive each subcommand end-to-end on CPU — transcode through
the mock ffmpeg binary's real subprocess pipes.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from swiftvideo_tpu_torch import cli
from swiftvideo_tpu_torch.codec import containers

MOCK_FFMPEG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "mock_ffmpeg.py")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch ops here are many and small: one intra-op thread, so that an
    xdist worker sharing its cores with five others waits on no OpenMP
    barrier (with a thread per core a small op can wait a scheduler slice)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def cpu_device(monkeypatch):
    """The port's mix and transcode run on the card unless SV_DEVICE=cpu."""
    monkeypatch.setenv("SV_DEVICE", "cpu")


@pytest.fixture
def mock_ffmpeg(monkeypatch):
    monkeypatch.setenv("SWIFTVIDEO_FFMPEG", MOCK_FFMPEG)
    return MOCK_FFMPEG


def _write_mockav(path, w=32, h=16, n_frames=5, rate=48000, ch=2,
                  n_samples=3072):
    fsize = w * h * 3 // 2
    video = b"".join(bytes([10 * i + 5]) * fsize for i in range(n_frames))
    pcm = np.arange(n_samples * ch, dtype=np.int16)
    path.write_bytes(
        f"MOCKAV {w} {h} 25 1 {n_frames} {rate} {ch} {n_samples}\n"
        .encode() + video + pcm.tobytes())


def test_mix_default_composition(tmp_path):
    out = tmp_path / "png"
    rc = cli.main(["mix", "--frames", "6", "--every", "3",
                   "--out", str(out)])
    assert rc == 0
    pngs = sorted(out.glob("*.png"))
    assert len(pngs) == 2
    import cv2
    img = cv2.imread(str(pngs[-1]))
    assert img.shape[:2] == (360, 640)
    assert img.std() > 1.0          # composited content, not a clear frame


def test_mix_from_json_manifest(tmp_path):
    from swiftvideo_tpu_torch.compose import composition_to_json
    comp = cli._default_composition()
    manifest = tmp_path / "comp.json"
    manifest.write_text(composition_to_json(comp))
    out = tmp_path / "png"
    rc = cli.main(["mix", str(manifest), "--frames", "3", "--every", "1",
                   "--out", str(out)])
    assert rc == 0
    assert len(list(out.glob("*.png"))) == 3


def test_transcode_video_and_audio(tmp_path, mock_ffmpeg):
    src = tmp_path / "clip.mockav"
    _write_mockav(src)
    vout = tmp_path / "out.ivf"
    aout = tmp_path / "out.opus"
    rc = cli.main(["transcode", str(src), "--video-out", str(vout),
                   "--vcodec", "vp8", "--audio-out", str(aout)])
    assert rc == 0

    data = vout.read_bytes()
    header, frames, rest = containers.parse_ivf(data)
    assert header["codec"] == b"VP80"
    assert header["width"] == 32 and header["height"] == 16
    assert header["n_frames"] == len(frames) == 5 and not rest

    reader = containers.OggPacketReader()
    reader.feed(aout.read_bytes())
    packets = [p for p, _ in reader.packets()]
    assert packets[0][:8] == b"OpusHead"
    assert packets[1][:8] == b"OpusTags"
    assert len(packets) > 2


def test_transcode_av1_ivf(tmp_path, mock_ffmpeg):
    """CLI AV1 transcode end-to-end through real subprocess pipes: AV01
    IVF out, temporal units parse, keyframes flagged."""
    from swiftvideo_tpu_torch.codec import bitstream
    src = tmp_path / "clip.mockav"
    _write_mockav(src)
    vout = tmp_path / "out.ivf"
    rc = cli.main(["transcode", str(src), "--video-out", str(vout),
                   "--vcodec", "av1"])
    assert rc == 0
    header, frames, rest = containers.parse_ivf(vout.read_bytes())
    assert header["codec"] == b"AV01"
    assert header["n_frames"] == len(frames) == 5 and not rest
    assert bitstream.av1_frame_size(frames[0][1]) == (32, 16)
    assert bitstream.av1_is_keyframe(frames[0][1])


def test_transcode_uncompressed_y4m_flush_tail(tmp_path, mock_ffmpeg):
    """--vcodec uncompressed: VideoEncoder returns SINGLE samples; the
    flush-tail path must normalize them like the live chain's flat()
    (it used to raise TypeError iterating a CodedMediaSample)."""
    src = tmp_path / "clip.mockav"
    _write_mockav(src)
    vout = tmp_path / "out.y4m"
    rc = cli.main(["transcode", str(src), "--video-out", str(vout),
                   "--vcodec", "uncompressed"])
    assert rc == 0
    data = vout.read_bytes()
    assert data.startswith(b"YUV4MPEG2")
    assert data.count(b"FRAME") == 5       # every decoded frame written


def test_transcode_container_passes_every_frame(tmp_path, monkeypatch):
    """Real-media CLI transcode: mp4 in -> hevc+opus mkv out, and EVERY
    source frame reaches the output.  Regression: the post-EOF drain used
    a fixed 64-tick budget, but a FileSource's 2 s read-ahead leaves the
    whole tail scheduled on the clock the moment pulling hits EOF — a
    45-frame file came out as 13 frames (StepClock.pending_count drain)."""
    from swiftvideo_tpu_torch.codec.codecs import bitstream_backend
    from swiftvideo_tpu_torch.codec.libav import LibavVideoDecoder
    monkeypatch.delenv("SWIFTVIDEO_FFMPEG", raising=False)
    if bitstream_backend() != "libav":
        pytest.skip("libav backend not available")
    from tests.test_avformat import _encode_media, _write_mp4
    from swiftvideo_tpu_torch.codec.avformat import MediaFileReader
    from swiftvideo_tpu_torch.media.coded import MediaFormat, MediaType

    n = 40                                # > 0.64 s of 30 fps stream time
    vpkts, apkts = _encode_media(n_frames=n)
    src = tmp_path / "clip.mp4"
    _write_mp4(src, vpkts, apkts)
    out = tmp_path / "out.mkv"
    rc = cli.main(["transcode", str(src), "--video-out", str(out),
                   "--audio-out", str(out),
                   "--vcodec", "hevc", "--acodec", "opus"])
    assert rc == 0
    with MediaFileReader(str(out)) as rd:
        fmts = {s.media_type: s.media_format for s in rd.streams}
        assert fmts[MediaType.video] == MediaFormat.hevc
        assert fmts[MediaType.audio] == MediaFormat.opus
        vcount = acount = 0
        dec = LibavVideoDecoder()
        frames = []
        for idx, pkt in rd.packets():
            if rd.streams[idx].media_type == MediaType.video:
                vcount += 1
                box = dec(pkt)
                if box.is_just():
                    frames.extend(box.value())
            else:
                acount += 1
        frames.extend(dec.flush())
    assert vcount == n                    # the drain bug dropped 2/3 here
    assert acount > 0
    assert len(frames) == n
    assert tuple(frames[0].img.size) == (64, 48)


def test_transcode_annexb_h264(tmp_path, mock_ffmpeg):
    src = tmp_path / "clip.mockav"
    _write_mockav(src)
    vout = tmp_path / "out.h264"
    rc = cli.main(["transcode", str(src), "--video-out", str(vout)])
    assert rc == 0
    data = vout.read_bytes()
    assert data.startswith(b"\x00\x00\x00\x01")
    from swiftvideo_tpu_torch.codec.ffmpeg_subprocess import split_annexb
    nals = split_annexb(data)
    types = {n[0] & 0x1F for n in nals if n}
    assert 7 in types and 8 in types          # SPS + PPS re-emitted in-band


def test_probe_ivf_y4m_adts_ogg_annexb_mockav(tmp_path, mock_ffmpeg,
                                              capsys):
    # ivf
    ivf = tmp_path / "v.ivf"
    ivf.write_bytes(containers.ivf_header("vp9", 64, 48)
                    + containers.ivf_frame(b"\x00" * 10, 0))
    assert cli.main(["probe", str(ivf)]) == 0
    info = json.loads(capsys.readouterr().out)
    assert info["container"] == "ivf" and info["width"] == 64

    # y4m
    y4m = tmp_path / "v.y4m"
    y4m.write_bytes(containers.make_y4m_header(32, 16))
    assert cli.main(["probe", str(y4m)]) == 0
    info = json.loads(capsys.readouterr().out)
    assert info == {**info, "container": "y4m", "width": 32, "height": 16}

    # ogg opus
    w = containers.OggOpusWriter(2)
    opus = tmp_path / "a.opus"
    opus.write_bytes(w.header() + w.page(b"\xfc\x01"))
    assert cli.main(["probe", str(opus)]) == 0
    info = json.loads(capsys.readouterr().out)
    assert info["container"] == "ogg" and info["codec"] == "opus"
    assert info["pre_skip"] == 312

    # adts
    from swiftvideo_tpu_torch.codec.ffmpeg_subprocess import adts_header
    adts = tmp_path / "a.adts"
    adts.write_bytes(adts_header(48000, 2, 8) + b"\x00" * 8)
    assert cli.main(["probe", str(adts)]) == 0
    info = json.loads(capsys.readouterr().out)
    assert info["container"] == "adts" and info["sample_rate"] == 48000
    assert info["channels"] == 2 and info["frames"] == 1

    # mockav
    mav = tmp_path / "c.mockav"
    _write_mockav(mav)
    assert cli.main(["probe", str(mav)]) == 0
    info = json.loads(capsys.readouterr().out)
    assert info["container"] == "mockav" and info["frames"] == 5

    # unknown
    other = tmp_path / "x.bin"
    other.write_bytes(b"\x42" * 16)
    assert cli.main(["probe", str(other)]) == 1


def test_probe_annexb_sps(tmp_path, capsys):
    from tests.test_bitstream import make_sps  # spec-built H.264 SPS
    sps = make_sps(3, 2)                       # 3x2 macroblocks = 48x32
    annexb = tmp_path / "v.h264"
    annexb.write_bytes(b"\x00\x00\x00\x01" + sps
                       + b"\x00\x00\x00\x01\x68\xce\x3c\x80"
                       + b"\x00\x00\x00\x01\x65\x88\x80\x10")
    assert cli.main(["probe", str(annexb)]) == 0
    info = json.loads(capsys.readouterr().out)
    assert info["container"] == "annexb" and info["codec"] == "avc"
    assert (info["width"], info["height"]) == (48, 32)


def test_serve_smoke_max_seconds(tmp_path):
    """serve binds, runs for max-seconds, exits cleanly."""
    rc = cli.main(["serve", "--host", "127.0.0.1", "--port", "0",
                   "--max-seconds", "0.2"])
    assert rc == 0


def test_serve_records_published_stream(tmp_path):
    """A real RTMP publisher against `serve --record`: the server accepts
    the loopback publish and records the AVC track as Annex-B
    (Examples/RtmpServer topology over the CLI)."""
    import socket
    import subprocess
    import time

    from tests.test_bitstream import make_sps

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    rec = tmp_path / "rec"
    env = dict(os.environ, SV_DEVICE="cpu",
               PYTHONPATH=os.path.dirname(os.path.dirname(
                   os.path.abspath(__file__))))
    proc = subprocess.Popen(
        [sys.executable, "-m", "swiftvideo_tpu_torch", "serve",
         "--host", "127.0.0.1", "--port", str(port),
         "--record", str(rec), "--max-seconds", "6"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, env=env)
    try:
        line = proc.stdout.readline().decode()   # "rtmp://host:port/ ..."
        assert "rtmp://" in line

        import asyncio

        from swiftvideo_tpu_torch.core import EventBox, TimePoint, WallClock
        from swiftvideo_tpu_torch.media import (CodedMediaSample, MediaFormat,
                                          MediaType)

        sps = make_sps(2, 1)                     # 32x16
        pps = b"\x68\xce\x3c\x80"
        from tests.test_ffmpeg_pipe import make_avcdcr
        config = make_avcdcr(sps, pps)

        async def publish():
            from swiftvideo_tpu_torch.net.rtmp import Rtmp
            client = Rtmp(WallClock())
            pub, _ = await client.connect(
                f"rtmp://127.0.0.1:{port}/live/cam", max_attempts=3,
                retry_delay=0.3)
            await asyncio.sleep(0.3)             # metadata grace timer
            for i in range(10):
                nal = bytes([0x65]) + bytes([i]) * 40
                pub.apply(EventBox.just(CodedMediaSample(
                    buffer=len(nal).to_bytes(4, "big") + nal,
                    pts_value=TimePoint(i * 33, 1000),
                    dts_value=TimePoint(i * 33, 1000),
                    media_type=MediaType.video,
                    media_format=MediaFormat.avc, id_asset="cam",
                    side={"config": config})))
                await asyncio.sleep(0.01)
            await asyncio.sleep(0.3)
            pub.close()

        asyncio.run(publish())
        proc.wait(timeout=12)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    recorded = list(rec.glob("*.h264"))
    assert recorded, f"nothing recorded in {rec}"
    data = recorded[0].read_bytes()
    from swiftvideo_tpu_torch.codec.ffmpeg_subprocess import split_annexb
    nals = split_annexb(data)
    # SPS re-emitted in-band + the published IDR slices
    assert any(n[0] & 0x1F == 7 for n in nals if n)
    idrs = [n for n in nals if n and n[0] & 0x1F == 5]
    assert len(idrs) == 10
    assert idrs[3][1] == 3


def test_serve_record_paths_app_qualified(tmp_path):
    """Two publishers on DIFFERENT apps with the SAME stream name must
    record to distinct, app-qualified files (a bare play_path key would
    make /a/cam0 and /b/cam0 overwrite each other)."""
    import asyncio
    import socket
    import subprocess

    from tests.test_bitstream import make_sps
    from tests.test_ffmpeg_pipe import make_avcdcr

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    rec = tmp_path / "rec"
    env = dict(os.environ, SV_DEVICE="cpu",
               PYTHONPATH=os.path.dirname(os.path.dirname(
                   os.path.abspath(__file__))))
    proc = subprocess.Popen(
        [sys.executable, "-m", "swiftvideo_tpu_torch", "serve",
         "--host", "127.0.0.1", "--port", str(port),
         "--record", str(rec), "--max-seconds", "6"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, env=env)
    try:
        line = proc.stdout.readline().decode()
        assert "rtmp://" in line

        from swiftvideo_tpu_torch.core import EventBox, TimePoint, WallClock
        from swiftvideo_tpu_torch.media import (CodedMediaSample, MediaFormat,
                                          MediaType)

        sps = make_sps(2, 1)
        config = make_avcdcr(sps, b"\x68\xce\x3c\x80")

        async def publish():
            from swiftvideo_tpu_torch.net.rtmp import Rtmp
            pubs = []
            for app in ("a", "b"):
                client = Rtmp(WallClock())
                pub, _ = await client.connect(
                    f"rtmp://127.0.0.1:{port}/{app}/cam0",
                    max_attempts=3, retry_delay=0.3)
                pubs.append((app, pub))
            await asyncio.sleep(0.3)
            for i in range(5):
                for k, (app, pub) in enumerate(pubs):
                    nal = bytes([0x65, 0x10 + k]) + bytes([i]) * 20
                    pub.apply(EventBox.just(CodedMediaSample(
                        buffer=len(nal).to_bytes(4, "big") + nal,
                        pts_value=TimePoint(i * 33, 1000),
                        dts_value=TimePoint(i * 33, 1000),
                        media_type=MediaType.video,
                        media_format=MediaFormat.avc, id_asset="cam0",
                        side={"config": config})))
                await asyncio.sleep(0.01)
            await asyncio.sleep(0.3)
            for _, pub in pubs:
                pub.close()

        asyncio.run(publish())
        proc.wait(timeout=12)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    recorded = sorted(p.name for p in rec.glob("*.h264"))
    assert recorded == ["a_cam0.h264", "b_cam0.h264"], recorded
    # the two recordings carry their own publisher's payloads, not a mix
    from swiftvideo_tpu_torch.codec.ffmpeg_subprocess import split_annexb
    for k, name in enumerate(recorded):
        nals = split_annexb((rec / name).read_bytes())
        idrs = [n for n in nals if n and n[0] & 0x1F == 5]
        assert idrs and all(n[1] == 0x10 + k for n in idrs), (name, idrs)


@pytest.mark.parametrize("codec", ["avc", "hevc"])
def test_serve_records_real_video_decodable(tmp_path, codec):
    """REAL media over the wire: libav-encoded H.264/H.265 is published
    via a real RTMP loopback to `serve --record`, and the recorded
    Annex-B file decodes back through libavcodec to the original frame
    content.  This closes the full network<->codec loop the reference
    exercises with its linked FFmpeg (Examples/RtmpServer +
    dec.video.ffmpeg.swift:24-221) using real codec bytes end to end —
    and for HEVC it drives the E-RTMP fourCC wire path (beyond the
    reference's AVC-only RTMP) with real bitstream bytes."""
    from swiftvideo_tpu_torch.codec.libav import libav_available
    if not libav_available():
        pytest.skip("libav shim not available")
    import asyncio
    import socket
    import subprocess

    from swiftvideo_tpu_torch.codec.libav import (LibavVideoDecoder,
                                            LibavVideoEncoder)
    from swiftvideo_tpu_torch.core import EventBox, WallClock
    from swiftvideo_tpu_torch.media import MediaFormat

    from tests.test_torch_libav import PORT, make_frame

    fmt = MediaFormat[codec]
    # encode real frames up front (the publish loop just ships bytes)
    sent = [make_frame(PORT, 64, 48, i) for i in range(8)]
    enc = LibavVideoEncoder(fmt, bitrate=400_000, fps=30)
    packets = []
    for f in sent:
        box = enc(f)
        assert not box.is_error(), box.err()
        if box.is_just():
            packets.extend(box.value())
    packets.extend(enc.flush())
    enc.close()
    assert len(packets) == len(sent)

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    rec = tmp_path / "rec"
    env = dict(os.environ, SV_DEVICE="cpu",
               PYTHONPATH=os.path.dirname(os.path.dirname(
                   os.path.abspath(__file__))))
    proc = subprocess.Popen(
        [sys.executable, "-m", "swiftvideo_tpu_torch", "serve",
         "--host", "127.0.0.1", "--port", str(port),
         "--record", str(rec), "--max-seconds", "6"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, env=env)
    try:
        line = proc.stdout.readline().decode()
        assert "rtmp://" in line

        async def publish():
            from swiftvideo_tpu_torch.net.rtmp import Rtmp
            client = Rtmp(WallClock())
            pub, _ = await client.connect(
                f"rtmp://127.0.0.1:{port}/live/real", max_attempts=3,
                retry_delay=0.3)
            await asyncio.sleep(0.3)
            for p in packets:
                pub.apply(EventBox.just(p))
                await asyncio.sleep(0.01)
            await asyncio.sleep(0.3)
            pub.close()

        asyncio.run(publish())
        proc.wait(timeout=12)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()

    recorded = list(rec.glob("*.h264" if codec == "avc" else "*.h265"))
    assert recorded, f"nothing recorded in {rec}"
    data = recorded[0].read_bytes()
    # decode the recording: parameter sets travel in-band in Annex-B, so
    # the decoder opens with no extradata (start-code packet mode)
    from swiftvideo_tpu_torch.codec.ffmpeg_subprocess import split_annexb
    nals = split_annexb(data)
    if codec == "avc":
        assert any(n[0] & 0x1F == 7 for n in nals if n)   # in-band SPS
        def is_slice(n):
            return n[0] & 0x1F in (1, 5)
    else:
        assert any((n[0] >> 1) & 0x3F == 33 for n in nals if n)  # SPS
        def is_slice(n):
            return (n[0] >> 1) & 0x3F <= 21                # VCL NAL
    # group NALs into access units: a slice/VCL NAL terminates its AU
    aus, cur = [], []
    for n in nals:
        if not n:
            continue
        cur.append(b"\x00\x00\x00\x01" + n)
        if is_slice(n):
            aus.append(b"".join(cur))
            cur = []
    assert len(aus) == len(sent), len(aus)
    dec = LibavVideoDecoder()
    frames = []
    for k, au in enumerate(aus):
        box = dec(packets[k].with_(buffer=au, side={}))
        assert not box.is_error(), box.err()
        if box.is_just():
            frames.extend(box.value())
    frames.extend(dec.flush())
    dec.close()
    assert len(frames) == len(sent)
    for orig, got in zip(sent, frames):
        assert got.size() == orig.size()
        dy = (np.asarray(got.planes()[0]).astype(np.int16)
              - np.asarray(orig.planes()[0]).astype(np.int16))
        assert float(np.abs(dy).mean()) < 12.0, float(np.abs(dy).mean())


def test_y4m_writer_fps_from_frame_spacing(tmp_path):
    """The Y4M header frame rate comes from pts spacing, not the pts
    timebase (a 30 fps stream with scale-1000 pts must NOT declare
    F1000:1)."""
    from swiftvideo_tpu_torch.cli import _VideoFileWriter
    from swiftvideo_tpu_torch.codec.codecs import pack_uncompressed_picture
    from swiftvideo_tpu_torch.core import TimePoint
    from swiftvideo_tpu_torch.media import (CodedMediaSample, MediaFormat,
                                      MediaType, PixelFormat,
                                      create_picture_sample)

    def sample(ms):
        pict = create_picture_sample((32, 16), PixelFormat.y420p,
                                     asset_id="a", workspace_id="w")
        return CodedMediaSample(
            buffer=pack_uncompressed_picture(pict),
            pts_value=TimePoint(ms, 1000), dts_value=TimePoint(ms, 1000),
            media_type=MediaType.video,
            media_format=MediaFormat.uncompressed,
            id_asset="a", id_workspace="w")

    out = tmp_path / "c.y4m"
    w = _VideoFileWriter(str(out), MediaFormat.uncompressed)
    for i in range(3):
        w.write(sample(i * 33))
    w.close()
    header = out.read_bytes().split(b"\n", 1)[0]
    assert b"F1000:33" in header, header
    reader = containers.Y4MReader()
    frames = reader.feed(out.read_bytes())
    assert abs(reader.fps[0] / reader.fps[1] - 30.3) < 0.1
    assert len(frames) == 3

    # single-frame stream: header still written on close (default rate)
    out1 = tmp_path / "one.y4m"
    w = _VideoFileWriter(str(out1), MediaFormat.uncompressed)
    w.write(sample(0))
    w.close()
    reader = containers.Y4MReader()
    assert len(reader.feed(out1.read_bytes())) == 1


def test_src_stage_flush_drains_tail():
    """AudioSampleRateConversion.flush() emits the filter-history tail
    with continuous pts (the transcode CLI routes decoder-tail PCM
    through the SRC before the encoder)."""
    from swiftvideo_tpu_torch.core import TimePoint
    from swiftvideo_tpu_torch.media.audio import AudioFormat, AudioSample
    from swiftvideo_tpu_torch.mix.src_audio import AudioSampleRateConversion

    src = AudioSampleRateConversion(48000, 2, AudioFormat.s16i)
    t = np.arange(4410, dtype=np.float64)
    mono = (np.sin(2 * np.pi * 440 * t / 44100) * 12000).astype(np.int16)
    inter = np.empty(mono.size * 2, np.int16)
    inter[0::2] = mono
    inter[1::2] = mono
    total = 0
    for k in range(4):
        s = AudioSample(buffers=(inter.copy(),), frequency=44100,
                        channels=2, format=AudioFormat.s16i,
                        sample_count=4410, id_asset="a", id_workspace="w",
                        pts_value=TimePoint(k * 4410, 44100))
        box = src(s)
        if box.is_just():
            total += box.value().number_samples()
    ring = src._resampler.R
    tail = src.flush()
    assert tail, "flush produced no tail samples"
    # 4 x 4410 @44.1k -> exactly 19200 @48k streamed; the flush drains
    # the filter ring-out with continuous pts at the output rate
    assert total == 19200
    assert tail[0].pts().value == total
    assert tail[0].sample_rate() == 48000
    assert sum(s.number_samples() for s in tail) <= ring
    # flush() resets the stage: a second flush is a no-op (no duplicate
    # tail), and a resumed feed starts a fresh re-anchored segment
    assert src.flush() == []
    s = AudioSample(buffers=(inter.copy(),), frequency=44100,
                    channels=2, format=AudioFormat.s16i,
                    sample_count=4410, id_asset="a", id_workspace="w",
                    pts_value=TimePoint(9 * 4410, 44100))
    box = src(s)
    assert box.is_just()
    assert box.value().pts().value == 9 * 4800  # re-anchored, not continued


def test_src_stage_flush_no_tail_without_resampling():
    """A pure channel/format conversion at equal rates has no filter
    history — flush() must not fabricate a silence tail, but it still
    resets the pts anchor for the next segment."""
    from swiftvideo_tpu_torch.core import TimePoint
    from swiftvideo_tpu_torch.media.audio import AudioFormat, AudioSample
    from swiftvideo_tpu_torch.mix.src_audio import AudioSampleRateConversion

    src = AudioSampleRateConversion(48000, 2, AudioFormat.s16i)
    mono = np.arange(480, dtype=np.int16)

    def feed(pts):
        s = AudioSample(buffers=(mono.copy(),), frequency=48000, channels=1,
                        format=AudioFormat.s16i, sample_count=480,
                        id_asset="a", id_workspace="w",
                        pts_value=TimePoint(pts, 48000))
        return src(s)

    out = feed(0)
    assert out.is_just() and out.value().number_channels() == 2
    assert src.flush() == []
    # resumed feed re-anchors to the incoming pts
    r2 = feed(5000)
    assert r2.is_just() and r2.value().pts().value == 5000


def test_mix_frame_budget_exact(tmp_path):
    """`mix --frames N` must produce exactly N frames even when the
    audio-tick / video-frame ratio is fractional (10 ms ticks vs 33.3 ms
    frames): the tick budget uses a rational ceiling, not round()."""
    out = tmp_path / "png"
    rc = cli.main(["mix", "--frames", "60", "--every", "10",
                   "--out", str(out)])
    assert rc == 0
    assert len(list(out.glob("*.png"))) == 6  # 60 frames, every 10th


def test_serve_workers_reuseport_sharding(tmp_path):
    """serve --workers 2: both processes bind the same port via
    SO_REUSEPORT and publishers landing on either worker are recorded —
    the CLI face of the ingest scale-out shape."""
    import asyncio
    import socket
    import subprocess
    import time

    from tests.test_bitstream import make_sps
    from tests.test_ffmpeg_pipe import make_avcdcr

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    rec = tmp_path / "rec"
    env = dict(os.environ, SV_DEVICE="cpu",
               PYTHONPATH=os.path.dirname(os.path.dirname(
                   os.path.abspath(__file__))))
    proc = subprocess.Popen(
        [sys.executable, "-m", "swiftvideo_tpu_torch", "serve",
         "--host", "127.0.0.1", "--port", str(port),
         "--workers", "2", "--record", str(rec), "--max-seconds", "8"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, env=env)
    try:
        # both worker processes announce themselves on the shared stdout
        # generous deadline (1-core box, two interpreter starts), and
        # regex over the accumulated stream rather than per-line parsing:
        # the two workers share the stdout pipe
        import re
        pids = set()
        buf = b""
        deadline = time.time() + 60
        while len(pids) < 2 and time.time() < deadline:
            chunk = proc.stdout.readline()
            if not chunk:
                break
            buf += chunk
            pids = set(re.findall(rb"pid (\d+)", buf))
        assert len(pids) == 2, f"expected 2 workers, saw {pids}"

        from swiftvideo_tpu_torch.core import EventBox, TimePoint, WallClock
        from swiftvideo_tpu_torch.media import (CodedMediaSample, MediaFormat,
                                          MediaType)

        sps = make_sps(2, 1)
        config = make_avcdcr(sps, b"\x68\xce\x3c\x80")

        async def publish():
            from swiftvideo_tpu_torch.net.rtmp import Rtmp
            pubs = []
            for k in range(6):      # several sessions: kernel shards them
                client = Rtmp(WallClock())
                pub, _ = await client.connect(
                    f"rtmp://127.0.0.1:{port}/live/cam{k}",
                    max_attempts=3, retry_delay=0.3)
                pubs.append(pub)
            await asyncio.sleep(0.3)
            for i in range(5):
                for k, pub in enumerate(pubs):
                    nal = bytes([0x65, k]) + bytes([i]) * 20
                    pub.apply(EventBox.just(CodedMediaSample(
                        buffer=len(nal).to_bytes(4, "big") + nal,
                        pts_value=TimePoint(i * 33, 1000),
                        dts_value=TimePoint(i * 33, 1000),
                        media_type=MediaType.video,
                        media_format=MediaFormat.avc, id_asset=f"cam{k}",
                        side={"config": config})))
                await asyncio.sleep(0.01)
            await asyncio.sleep(0.4)
            for pub in pubs:
                pub.close()

        asyncio.run(publish())
        proc.wait(timeout=15)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    recorded = sorted(p.name for p in rec.glob("*.h264"))
    assert recorded == [f"live_cam{k}.h264" for k in range(6)], recorded


# --- the port's outputs against the JAX CLI's ---------------------------------

def test_mix_matches_jax_cli(tmp_path, monkeypatch):
    """One manifest through both CLIs: the port's mixed y420p frames within
    1 LSB of the JAX CLI's, its RGBA conversion (the registry's
    ``img_y420p_rgba``) within 1 LSB of ``golden.composite_stack`` on the
    port's own frame, and its PNGs read back by cv2 as the RGBA written."""
    import cv2

    from swiftvideo_tpu import cli as jax_cli
    from swiftvideo_tpu.compose import composition_to_json
    from swiftvideo_tpu.ops import golden, identity_uniforms
    from swiftvideo_tpu.media import PixelFormat as JaxPixelFormat
    import swiftvideo_tpu_torch.ops as port_ops

    manifest = tmp_path / "comp.json"
    manifest.write_text(composition_to_json(jax_cli._default_composition()))
    seen = {"jax": [], "port": []}
    jax_composite = golden.composite_stack
    port_run = port_ops.run_compute_kernel

    def jax_spy(fmt, size, sources, *a, **kw):
        out = jax_composite(fmt, size, sources, *a, **kw)
        seen["jax"].append([np.asarray(p) for p in sources[0][0]])
        return out

    def port_spy(ctx, images, target, kernel, uniforms=None, **kw):
        out = port_run(ctx, images, target, kernel, uniforms, **kw)
        seen["port"].append(([np.asarray(p) for p in images[0].planes()],
                             np.asarray(out.planes()[0])))
        return out

    monkeypatch.setattr(golden, "composite_stack", jax_spy)
    monkeypatch.setattr(port_ops, "run_compute_kernel", port_spy)
    args = [str(manifest), "--frames", "9", "--every", "4"]
    assert jax_cli.main(["mix", *args, "--out", str(tmp_path / "j")]) == 0
    assert cli.main(["mix", *args, "--out", str(tmp_path / "p")]) == 0
    monkeypatch.setattr(golden, "composite_stack", jax_composite)
    assert len(seen["jax"]) == len(seen["port"]) == 3
    pngs = sorted((tmp_path / "p").glob("*.png"))
    assert [p.name for p in pngs] == \
        sorted(p.name for p in (tmp_path / "j").glob("*.png"))
    for (planes, rgba), jax_planes, png in zip(seen["port"], seen["jax"],
                                               pngs):
        for mine, theirs in zip(planes, jax_planes):
            assert np.abs(mine.astype(int) - theirs).max() <= 1
        h, w = planes[0].shape
        ref = golden.composite_stack(
            JaxPixelFormat.RGBA, (w, h),
            [(planes, JaxPixelFormat.y420p, identity_uniforms((w, h),
                                                              (w, h)))])[0]
        assert np.abs(rgba.astype(int) - ref).max() <= 1
        back = cv2.imread(str(png), cv2.IMREAD_UNCHANGED)
        assert back.dtype == np.uint8 and back.shape == (h, w, 4)
        assert np.array_equal(back, rgba[..., [2, 1, 0, 3]])


@pytest.mark.parametrize("shape", [(1, 1), (3, 5), (37, 64)])
def test_write_png_reads_back_through_cv2(tmp_path, shape):
    """The stdlib PNG writer's file is the BGRA image cv2 wrote before:
    8-bit, 4 channels, ``rgba[..., [2, 1, 0, 3]]``."""
    import cv2

    rgba = np.random.default_rng(sum(shape)).integers(
        0, 256, (*shape, 4), np.int64).astype(np.uint8)
    path = tmp_path / "x.png"
    cli.write_png(str(path), rgba)
    back = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    assert np.array_equal(back, rgba[..., [2, 1, 0, 3]])
    with pytest.raises(ValueError):
        cli.write_png(str(path), rgba[..., :3])


@pytest.mark.parametrize("vout,aout,extra", [
    ("out.h264", "out.adts", ["--rate", "32000"]),
    ("out.ivf", "out.opus", ["--vcodec", "vp9", "--rate", "44100"]),
    ("out.y4m", None, ["--vcodec", "uncompressed"]),
])
def test_transcode_outputs_equal_jax_cli(tmp_path, mock_ffmpeg, vout, aout,
                                         extra):
    """The same input through both CLIs, the audio resampled from 48 kHz
    (the SRC on its host route under SV_DEVICE=cpu in both): byte-equal
    output files."""
    from swiftvideo_tpu import cli as jax_cli

    src = tmp_path / "clip.mockav"
    _write_mockav(src, n_samples=9600)
    outs = {}
    for name, main in (("port", cli.main), ("jax", jax_cli.main)):
        d = tmp_path / name
        d.mkdir()
        argv = ["transcode", str(src), "--video-out", str(d / vout)]
        if aout:
            argv += ["--audio-out", str(d / aout)]
        assert main(argv + extra) == 0
        outs[name] = [(d / f).read_bytes() for f in (vout, aout) if f]
    assert all(outs["port"])
    assert outs["port"] == outs["jax"]


def test_probe_outputs_equal_jax_cli(tmp_path, capsys):
    """probe prints the same JSON in both packages for every container it
    reads, and the same exit code for one it does not."""
    from swiftvideo_tpu import cli as jax_cli
    from swiftvideo_tpu_torch.codec.ffmpeg_subprocess import adts_header
    from tests.test_bitstream import make_sps

    w = containers.OggOpusWriter(2)
    files = {
        "v.ivf": containers.ivf_header("vp9", 64, 48)
        + containers.ivf_frame(b"\x00" * 10, 0),
        "v.y4m": containers.make_y4m_header(32, 16),
        "a.opus": w.header() + w.page(b"\xfc\x01"),
        "a.adts": adts_header(44100, 1, 8) + b"\x00" * 8,
        "v.h264": b"\x00\x00\x00\x01" + make_sps(3, 2)
        + b"\x00\x00\x00\x01\x68\xce\x3c\x80",
        "x.bin": b"\x42" * 16,
    }
    _write_mockav(tmp_path / "c.mockav")
    for name, data in files.items():
        (tmp_path / name).write_bytes(data)
    for name in list(files) + ["c.mockav"]:
        path = str(tmp_path / name)
        rc = cli.main(["probe", path])
        mine = capsys.readouterr().out
        assert jax_cli.main(["probe", path]) == rc
        assert capsys.readouterr().out == mine
