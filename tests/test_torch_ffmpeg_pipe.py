"""The port's ffmpeg subprocess codecs against the JAX package's, on the
CPU, without an ffmpeg binary.

Twins of ``tests/test_ffmpeg_pipe.py``: a scripted stand-in for the pipe
process drives the decoders' drain, pts ring and flush; and
``tests/mock_ffmpeg.py`` (a stored-raw codec and ``.mockav`` demuxer that
speaks ffmpeg's command line) runs as the binary, through
``SWIFTVIDEO_FFMPEG``.  Each case runs the same inputs through both
packages and requires equal outputs: coded bytes, side data, decoded
planes and PCM, pts.  The port's encoders are also fed torch tensors
(its Composer's output) and must write the same bytes.  Tolerance: none.
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import swiftvideo_tpu.codec.codecs as jax_codecs
import swiftvideo_tpu.codec.containers as jax_containers
import swiftvideo_tpu.codec.ffmpeg_subprocess as jax_ff
import swiftvideo_tpu.codec.file_source as jax_file_source
import swiftvideo_tpu.core as jax_core
import swiftvideo_tpu.media as jax_media
import swiftvideo_tpu_torch.codec.codecs as port_codecs
import swiftvideo_tpu_torch.codec.containers as port_containers
import swiftvideo_tpu_torch.codec.ffmpeg_subprocess as port_ff
import swiftvideo_tpu_torch.codec.file_source as port_file_source
import swiftvideo_tpu_torch.core as port_core
import swiftvideo_tpu_torch.media as port_media

JAX = SimpleNamespace(ff=jax_ff, ct=jax_containers, codecs=jax_codecs,
                      fs=jax_file_source, core=jax_core, media=jax_media)
PORT = SimpleNamespace(ff=port_ff, ct=port_containers, codecs=port_codecs,
                       fs=port_file_source, core=port_core, media=port_media)
MOCK_FFMPEG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "mock_ffmpeg.py")
W, H = 16, 8
FRAME_BYTES = W * H * 3 // 2


class FakeProcess:
    """Scripted pipe-process stand-in: take() pops pre-planned chunks."""

    script, flush_script, instances = [], [], []

    def __init__(self, args):
        self.args = args
        self.writes = []
        self._queue = list(type(self).script)
        self.flushed = False
        type(self).instances.append(self)

    def write(self, data):
        self.writes.append(bytes(data))

    def take(self, n=None):
        return self._queue.pop(0) if self._queue else b""

    def flush_input(self):
        self.flushed = True
        self._queue.extend(type(self).flush_script)

    def close(self):
        pass


@pytest.fixture
def fake_pipe(monkeypatch):
    for module in (jax_ff, port_ff):
        monkeypatch.setattr(module, "_PipeProcess", FakeProcess)
        monkeypatch.setattr(module, "ffmpeg_path", lambda: "/fake/ffmpeg")
    return FakeProcess


@pytest.fixture
def mock_ffmpeg(monkeypatch):
    monkeypatch.setenv("SWIFTVIDEO_FFMPEG", MOCK_FFMPEG)
    return MOCK_FFMPEG


def _tp(t):
    return (t.value, t.scale)


def _coded(c):
    return (bytes(c.data()), _tp(c.pts()), c.media_format.value,
            {k: bytes(v) for k, v in c.side_data().items()})


def _pics(pics):
    return [(_tp(p.pts()), p.size(), [np.asarray(x).tolist()
                                      for x in p.planes()]) for p in pics]


def _pcm(samples):
    return [(_tp(a.pts()), a.number_samples(),
             np.asarray(a.data()[0]).tolist()) for a in samples]


def _drive(stage, items):
    out = []
    for item in items:
        box = stage(item)
        if box.is_just():
            v = box.value()
            out.extend(v if isinstance(v, list) else [v])
    out.extend(stage.flush())
    stage.close()
    return out


def _avc_sample(m, i, payload=b"\x65\xAA"):
    sps = bytes([0x67, 0x42, 0xC0, 0x1E, 0x99])
    pps = bytes([0x68, 0xCE, 0x3C, 0x80])
    return m.media.CodedMediaSample(
        buffer=len(payload).to_bytes(4, "big") + payload,
        pts_value=m.core.TimePoint(i, 30), dts_value=m.core.TimePoint(i, 30),
        media_type=m.media.MediaType.video,
        media_format=m.media.MediaFormat.avc, id_asset="cam",
        id_workspace="ws", side={"config": m.ff.make_avcdcr(sps, pps)})


def _frame(i):
    return bytes([i]) * FRAME_BYTES


def _scripted(m, fake, script, flush_script, n):
    fake.instances = []
    fake.script, fake.flush_script = script, flush_script
    dec = m.ff.FFmpegVideoDecoder()
    boxes = [dec(_avc_sample(m, i)) for i in range(n)]
    per_call = [_pics(b.value()) if b.is_just() else None for b in boxes]
    return (per_call, _pics(dec.flush()), fake.instances[0].flushed,
            fake.instances[0].writes)


def test_video_decoder_drain_and_flush_equal(fake_pipe):
    def run(m):
        y4m = m.ct.make_y4m_header(W, H)
        return _scripted(m, fake_pipe, [
            y4m + b"FRAME\n" + _frame(1), b"",
            b"FRAME\n" + _frame(2) + b"FRAME\n" + _frame(3)],
            [b"FRAME\n" + _frame(4)], 3)
    ours = run(PORT)
    assert ours[0][1] is None and len(ours[0][2]) == 2
    assert ours[3][0].startswith(b"\x00\x00\x00\x01\x67")
    assert ours == run(JAX)


def test_video_decoder_pts_queue_depth_equal(fake_pipe):
    def run(m):
        return _scripted(m, fake_pipe, [b"", b"", m.ct.make_y4m_header(W, H)],
                         [b"".join(b"FRAME\n" + _frame(i) for i in range(3))],
                         3)
    ours = run(PORT)
    assert [p[0] for p in ours[1]] == [(i, 30) for i in range(3)]
    assert ours == run(JAX)


def test_audio_decoder_adts_and_pts_equal(fake_pipe):
    def run(m):
        fake_pipe.instances = []
        fake_pipe.script = [np.arange(2048 * 2, dtype=np.int16).tobytes()]
        dec = m.ff.FFmpegAudioDecoder(chunk_samples=1024)
        box = dec(m.media.CodedMediaSample(
            buffer=b"\x21\x00\x03", pts_value=m.core.TimePoint(5, 48000),
            dts_value=m.core.TimePoint(5, 48000),
            media_type=m.media.MediaType.audio,
            media_format=m.media.MediaFormat.aac, id_asset="mic",
            id_workspace="ws", side={"config": m.ff.bitstream.make_asc(
                48000, 2)}))
        return _pcm(box.value()), fake_pipe.instances[0].writes
    ours = run(PORT)
    assert [p[0] for p in ours[0]] == [(5, 48000), (5 + 1024, 48000)]
    assert ours == run(JAX)


def _pict_seq(m, n, size=(32, 16), tensors=False):
    pics = []
    for i in range(n):
        p = m.media.create_picture_sample(size, m.media.PixelFormat.y420p,
                                          asset_id="a", workspace_id="w")
        p.planes()[0][:] = 40 + i
        p.planes()[1][:] = 90 + i
        p.planes()[2][:] = 7 * i
        if tensors:
            p = p.with_(img=p.img.with_buffers(tuple(
                torch.from_numpy(np.array(x)) for x in p.planes())))
        pics.append(p.with_(pts=m.core.TimePoint(i, 30)))
    return pics


def _video_roundtrip(m, fmt, n=6, tensors=False):
    coded = _drive(m.ff.FFmpegVideoEncoder(getattr(m.media.MediaFormat, fmt),
                                           fps=30),
                   _pict_seq(m, n, tensors=tensors))
    return [_coded(c) for c in coded], _pics(_drive(m.ff.FFmpegVideoDecoder(),
                                                    coded))


@pytest.mark.parametrize("fmt", ["avc", "hevc", "vp8", "vp9", "av1"])
def test_mock_video_roundtrip_equal(mock_ffmpeg, fmt):
    """Encode and decode through the mock binary: the same coded bytes and
    side data in both packages, and the same bytes again when the port's
    encoder reads torch planes."""
    ours = _video_roundtrip(PORT, fmt)
    assert len(ours[0]) == len(ours[1]) == 6
    assert ours == _video_roundtrip(JAX, fmt)
    assert _video_roundtrip(PORT, fmt, tensors=True) == ours


def _audio_samples(m, n, spf, tensors=False):
    rng = np.random.default_rng(7)
    out = []
    for i in range(n):
        pcm = rng.integers(-3000, 3000, spf * 2).astype(np.int16)
        out.append(m.media.AudioSample(
            buffers=(torch.from_numpy(pcm) if tensors else pcm,),
            frequency=48000, channels=2, format="s16i", sample_count=spf,
            id_asset="mic", id_workspace="ws",
            pts_value=m.core.TimePoint(i * spf, 48000)))
    return out


@pytest.mark.parametrize("fmt,spf", [("aac", 1024), ("opus", 960)])
def test_mock_audio_roundtrip_equal(mock_ffmpeg, fmt, spf):
    def run(m, tensors=False):
        coded = _drive(m.ff.FFmpegAudioEncoder(getattr(m.media.MediaFormat,
                                                       fmt)),
                       _audio_samples(m, 6, spf, tensors))
        pcm = _drive(m.ff.FFmpegAudioDecoder(chunk_samples=spf), coded)
        return [_coded(c) for c in coded], _pcm(pcm)
    ours = run(PORT)
    assert len(ours[0]) == 6
    assert ours == run(JAX)
    assert run(PORT, tensors=True) == ours


def test_mock_generic_codec_dispatch_equal(mock_ffmpeg):
    def run(m):
        coded = _drive(m.codecs.VideoEncoder(m.media.MediaFormat.avc, fps=30),
                       _pict_seq(m, 4))
        return [_coded(c) for c in coded], _pics(_drive(
            m.codecs.VideoDecoder(), coded))
    ours = run(PORT)
    assert len(ours[1]) == 4
    assert ours == run(JAX)


def test_open_media_file_av_via_mock_equal(tmp_path, mock_ffmpeg):
    """The A/V file source through the mock's ``.mockav`` demuxer: both
    tracks, paced and chunked, give the same samples in both packages."""
    w, h, n_frames, rate, ch, n_samples = 32, 16, 6, 48000, 2, 3072
    video = b"".join(bytes([10 * i + 5]) * (w * h * 3 // 2)
                     for i in range(n_frames))
    pcm = np.arange(n_samples * ch, dtype=np.int16)
    path = tmp_path / "clip.mockav"
    path.write_bytes(f"MOCKAV {w} {h} 25 1 {n_frames} {rate} {ch} "
                     f"{n_samples}\n".encode() + video + pcm.tobytes())

    def run(m):
        clock = m.core.StepClock(m.core.TimePoint(20, 1000))
        vsrc, asrc = m.fs.open_media_file_av(clock, str(path),
                                             asset_id="clip", audio_chunk=1024)
        got = []
        keep = [src >> m.core.Tx(lambda s: (got.append(
            (s.media_type.value, _tp(s.pts()), bytes(s.data()))),
            m.core.EventBox.just(s))[1]) for src in (vsrc, asrc)]
        vsrc.play()
        asrc.play()
        for _ in range(400):
            clock.step()
        vsrc.close()
        asrc.close()
        del keep
        return got
    ours = run(PORT)
    assert sum(1 for k, _p, _d in ours if k == 0) == n_frames
    assert sum(1 for k, _p, _d in ours if k == 1) == 3
    assert ours == run(JAX)
