"""The port's in-process libav codecs and libavformat containers against
the JAX package's, on the CPU.

Twins of ``tests/test_libav.py`` and ``tests/test_avformat.py``.  Encoders
(x264 and the others) need not give the same bytes twice, so each case
compares what decodes from the *same* encoded bytes: one package encodes,
and both packages' decoders (or demuxers) read that output, to equal
planes, PCM, pts and side data.  The port's encoders are also fed torch
tensors (its Composer's output) and must give as many packets with the
same configuration, decoding as the JAX package decodes them.  They skip,
as the JAX tests do, where the repo's ``csrc/libsvav.so`` shim does not
load.  Tolerance: none.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import swiftvideo_tpu.codec.avformat as jax_avformat
import swiftvideo_tpu.codec.codecs as jax_codecs
import swiftvideo_tpu.codec.file_source as jax_file_source
import swiftvideo_tpu.codec.libav as jax_libav
import swiftvideo_tpu.core as jax_core
import swiftvideo_tpu.media as jax_media
import swiftvideo_tpu_torch.codec.avformat as port_avformat
import swiftvideo_tpu_torch.codec.codecs as port_codecs
import swiftvideo_tpu_torch.codec.file_source as port_file_source
import swiftvideo_tpu_torch.codec.libav as port_libav
import swiftvideo_tpu_torch.core as port_core
import swiftvideo_tpu_torch.media as port_media
from swiftvideo_tpu_torch import interop

JAX = SimpleNamespace(av=jax_libav, fmt=jax_avformat, codecs=jax_codecs,
                      fs=jax_file_source, core=jax_core, media=jax_media)
PORT = SimpleNamespace(av=port_libav, fmt=port_avformat, codecs=port_codecs,
                       fs=port_file_source, core=port_core, media=port_media)


@pytest.fixture
def shim():
    if not (jax_libav.libav_available() and port_libav.libav_available()):
        pytest.skip("libav shim not available")


def make_frame(m, w, h, i, tensors=False):
    yy = ((np.arange(h)[:, None] * 2 + np.arange(w)[None, :] + i * 9)
          % 220 + 16).astype(np.uint8)
    u = np.full((h // 2, w // 2), 96 + (i * 5) % 64, np.uint8)
    v = np.full((h // 2, w // 2), 128 - (i * 3) % 64, np.uint8)
    planes = (yy, u, v)
    if tensors:
        planes = tuple(torch.from_numpy(p) for p in planes)
    PF = m.media.PixelFormat
    img = m.media.ImageBuffer(PF.y420p, m.media.BufferType.cpu, (w, h),
                              tuple(m.media.planes_for_format(PF.y420p,
                                                              (w, h))),
                              planes)
    return m.media.PictureSample(img, "cam", "ws",
                                 pts_value=m.core.TimePoint(i * 33, 1000))


def make_audio(m, i, n=1024, tensors=False):
    t = (np.arange(n) + i * n) / 48000
    wave = (np.sin(2 * np.pi * 440.0 * t) * 12000).astype(np.int16)
    pcm = np.stack([wave, wave // 2], axis=1).reshape(-1).copy()
    return m.media.AudioSample(
        buffers=(torch.from_numpy(pcm) if tensors else pcm,),
        frequency=48000, channels=2, format="s16i", sample_count=n,
        id_asset="aud", id_workspace="ws",
        pts_value=m.core.TimePoint(i * n, 48000))


def jax_coded(c):
    """A port CodedMediaSample as the JAX package's (the reverse of
    ``interop.coded_media_sample``)."""
    tp = jax_core.TimePoint
    return jax_media.CodedMediaSample(
        buffer=bytes(c.data()), pts_value=tp(c.pts().value, c.pts().scale),
        dts_value=tp(c.dts().value, c.dts().scale),
        media_type=jax_media.MediaType(int(c.media_type)),
        media_format=jax_media.MediaFormat(int(c.media_format)),
        id_asset=c.asset_id(), id_workspace=c.workspace_id(),
        side=dict(c.side_data()), encoder=c.encoder)


def _collect(stage, items, flush=True):
    out = []
    for item in items:
        box = stage(item)
        assert not box.is_error(), box.err()
        if box.is_just():
            v = box.value()
            out.extend(v if isinstance(v, list) else [v])
    if flush:
        out.extend(stage.flush())
    stage.close()
    return out


def _frames(frames):
    return [((f.pts().value, f.pts().scale), f.size(),
             [np.asarray(p).tolist() for p in f.planes()]) for f in frames]


def _pcm(samples):
    return [((a.pts().value, a.pts().scale), a.number_samples(),
             np.asarray(a.data()[0]).tolist()) for a in samples]


def _decode_both(packets_jax, kind, **dec_kw):
    """Decode the same packets with both packages' decoders."""
    ours = _collect(getattr(port_libav, f"Libav{kind}Decoder")(**dec_kw),
                    [interop.coded_media_sample(p) for p in packets_jax])
    theirs = _collect(getattr(jax_libav, f"Libav{kind}Decoder")(**dec_kw),
                      packets_jax)
    return ours, theirs


FORMATS = ["avc", "hevc", "vp8", "vp9"]


@pytest.mark.parametrize("fmt", FORMATS)
def test_video_decodes_equal_from_the_same_bytes(shim, fmt):
    frames = [make_frame(JAX, 64, 48, i) for i in range(6)]
    packets = _collect(jax_libav.LibavVideoEncoder(
        getattr(jax_media.MediaFormat, fmt), bitrate=400_000, fps=30), frames)
    ours, theirs = _decode_both(packets, "Video")
    assert len(ours) == len(theirs) == 6
    assert _frames(ours) == _frames(theirs)


@pytest.mark.parametrize("fmt", FORMATS)
def test_port_encoder_takes_torch_planes(shim, fmt):
    """The port's encoder on torch planes: as many packets as the JAX
    encoder gives for numpy planes, the same keyframe flags and config
    record, and both decoders read its bytes to the same frames."""
    MF = port_media.MediaFormat
    ours = _collect(port_libav.LibavVideoEncoder(
        getattr(MF, fmt), bitrate=400_000, fps=30),
        [make_frame(PORT, 64, 48, i, tensors=True) for i in range(6)])
    theirs = _collect(jax_libav.LibavVideoEncoder(
        getattr(jax_media.MediaFormat, fmt), bitrate=400_000, fps=30),
        [make_frame(JAX, 64, 48, i) for i in range(6)])
    assert len(ours) == len(theirs) == 6
    assert ([port_media.coded.is_keyframe(p) for p in ours]
            == [jax_media.coded.is_keyframe(p) for p in theirs])
    assert [(p.pts().value, p.pts().scale) for p in ours] == \
        [(p.pts().value, p.pts().scale) for p in theirs]
    if fmt in ("avc", "hevc"):
        assert (port_media.coded.basic_media_description(ours[0])
                .size == (64, 48))
    decoded_ours, decoded_theirs = _decode_both(
        [jax_coded(p) for p in ours], "Video")
    assert _frames(decoded_ours) == _frames(decoded_theirs)


@pytest.mark.parametrize("fmt,priming", [("aac", 1024), ("opus", 0)])
def test_audio_decodes_equal_and_encoder_takes_torch_pcm(shim, fmt, priming):
    MF = jax_media.MediaFormat
    packets = _collect(jax_libav.LibavAudioEncoder(getattr(MF, fmt),
                                                   bitrate=96_000),
                       [make_audio(JAX, i) for i in range(12)])
    ours, theirs = _decode_both(packets, "Audio", priming_samples=priming)
    assert _pcm(ours) == _pcm(theirs) and len(ours) > 5
    port_packets = _collect(port_libav.LibavAudioEncoder(
        getattr(port_media.MediaFormat, fmt), bitrate=96_000),
        [make_audio(PORT, i, tensors=True) for i in range(12)])
    assert len(port_packets) == len(packets)
    assert [p.side_data()["config"] for p in port_packets[:1]] == \
        [p.side_data()["config"] for p in packets[:1]]
    assert [(p.pts().value, p.pts().scale) for p in port_packets] == \
        [(p.pts().value, p.pts().scale) for p in packets]
    ours, theirs = _decode_both([jax_coded(p) for p in port_packets],
                                "Audio", priming_samples=priming)
    assert _pcm(ours) == _pcm(theirs)


def test_dispatch_prefers_libav(shim):
    assert port_codecs.bitstream_backend() == jax_codecs.bitstream_backend() \
        == "libav"
    assert port_libav._candidate_paths()[1] == jax_libav._candidate_paths()[1]


def _media(n_frames=8):
    vpkts = _collect(jax_libav.LibavVideoEncoder(jax_media.MediaFormat.avc,
                                                 bitrate=300_000, fps=30),
                     [make_frame(JAX, 64, 48, i) for i in range(n_frames)])
    apkts = _collect(jax_libav.LibavAudioEncoder(jax_media.MediaFormat.aac,
                                                 bitrate=96_000),
                     [make_audio(JAX, i, n=1600) for i in range(n_frames)])
    return vpkts, apkts


def _write(m, path, vpkts, apkts, container=None):
    MF, TP = m.media.MediaFormat, m.core.TimePoint
    with m.fmt.MediaFileWriter(str(path), format=container) as mux:
        v = mux.add_video_stream(MF.avc, 64, 48, vpkts[0].side_data()["config"])
        a = mux.add_audio_stream(MF.aac, 48000, 2,
                                 apkts[0].side_data()["config"])
        for p in vpkts:
            mux.write(v, p, duration=TP(33, 1000))
        for p in apkts:
            mux.write(a, p, duration=TP(1024, 48000))


def _demux(m, path):
    with m.fmt.MediaFileReader(str(path), asset_id="f") as reader:
        streams = [(s.media_format.value, s.width, s.height, s.sample_rate,
                    s.channels, s.config) for s in reader.streams]
        packets = [(idx, bytes(s.data()), (s.pts().value, s.pts().scale),
                    s.media_type.value, dict(s.side_data()))
                   for idx, s in reader.packets()]
    return streams, packets


@pytest.mark.parametrize("ext,container", [("mp4", None), ("flv", None),
                                           ("mkv", "matroska")])
def test_mux_demux_equal(shim, tmp_path, ext, container):
    """The port's writer and the JAX writer mux the same packets; each
    file demuxes to the same streams and packets in both packages."""
    vpkts, apkts = _media()
    ours_path, theirs_path = tmp_path / f"p.{ext}", tmp_path / f"j.{ext}"
    _write(PORT, ours_path, [interop.coded_media_sample(p) for p in vpkts],
           [interop.coded_media_sample(p) for p in apkts], container)
    _write(JAX, theirs_path, vpkts, apkts, container)
    for path in (ours_path, theirs_path):
        assert _demux(PORT, path) == _demux(JAX, path)
    assert _demux(PORT, ours_path)[1] == _demux(JAX, theirs_path)[1]


def _play_file(m, path, steps=300):
    clock = m.core.StepClock(m.core.TimePoint(20, 1000))
    vsrc, asrc = m.fs.open_media_file_av(clock, str(path), asset_id="clip",
                                         audio_chunk=1024)
    got = []
    keep = [src >> m.core.Tx(lambda s: (got.append(
        (s.media_type.value, (s.pts().value, s.pts().scale),
         bytes(s.data()))), m.core.EventBox.just(s))[1])
        for src in (vsrc, asrc)]
    vsrc.play()
    asrc.play()
    for _ in range(steps):
        clock.step()
    vsrc.close()
    asrc.close()
    del keep
    return got


def test_file_source_real_mp4_equal(shim, tmp_path):
    """``open_media_file_av`` over one real MP4: both tracks, paced and
    decoded, give the same samples in the same order in both packages."""
    vpkts, apkts = _media(n_frames=6)
    path = tmp_path / "clip.mp4"
    _write(JAX, path, vpkts, apkts)
    ours = _play_file(PORT, path)
    assert sum(1 for k, _p, _d in ours if k == 0) == 6
    assert ours == _play_file(JAX, path)
