"""The port's codec layer against the JAX package's, on the CPU.

Twins of ``tests/test_codec.py``: the uncompressed and PNG codecs, the
video and audio transcoders, ``TranscodeContainer``, ``SyntheticSource``
pacing, text rendering, the Annex-B / AVCC / ADTS helpers and the ffmpeg
gating, plus the ``AudioPacketSegmenter``.  Each case builds its samples
from one package's own types, on data from one numpy seed, runs the same
graph in both packages and requires equal outputs: coded bytes, decoded
planes and PCM, pts, provenance, error descriptions.  Then a codec stage
fed ``torch`` tensors (as the Composer's output on the card is) gives the
bytes that numpy input gives.  Tolerance: none.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import swiftvideo_tpu.codec as jax_codec
import swiftvideo_tpu.codec.codecs as jax_codecs
import swiftvideo_tpu.codec.ffmpeg_subprocess as jax_ff
import swiftvideo_tpu.core as jax_core
import swiftvideo_tpu.media as jax_media
import swiftvideo_tpu.mix.segmenter as jax_segmenter
import swiftvideo_tpu_torch.codec as port_codec
import swiftvideo_tpu_torch.codec.codecs as port_codecs
import swiftvideo_tpu_torch.codec.ffmpeg_subprocess as port_ff
import swiftvideo_tpu_torch.core as port_core
import swiftvideo_tpu_torch.media as port_media
import swiftvideo_tpu_torch.mix.segmenter as port_segmenter

JAX = SimpleNamespace(codec=jax_codec, codecs=jax_codecs, ff=jax_ff,
                      core=jax_core, media=jax_media, seg=jax_segmenter)
PORT = SimpleNamespace(codec=port_codec, codecs=port_codecs, ff=port_ff,
                       core=port_core, media=port_media, seg=port_segmenter)


def _u8(rng, *shape):
    return rng.integers(0, 256, shape, np.int64).astype(np.uint8)


def _pict(m, size=(32, 16), seed=0, fmt="y420p"):
    s = m.media.create_picture_sample(size, getattr(m.media.PixelFormat, fmt),
                                      asset_id="a", workspace_id="w")
    rng = np.random.default_rng(seed)
    for p in s.planes():
        p[:] = _u8(rng, *p.shape)
    return s


def _audio(m, n=960, seed=0, pts=0, rate=48000, asset="a"):
    rng = np.random.default_rng(seed)
    pcm = rng.integers(-20000, 20000, n * 2, np.int64).astype(np.int16)
    return m.media.AudioSample(
        buffers=(pcm,), frequency=rate, channels=2,
        format=m.media.AudioFormat.s16i, sample_count=n,
        pts_value=m.core.TimePoint(pts, rate), id_asset=asset,
        id_workspace="w")


def _planes(sample):
    return [np.asarray(p).tolist() for p in sample.planes()]


def _pcm(sample):
    return [np.asarray(b).tolist() for b in sample.data()]


def _tp(t):
    return (t.value, t.scale)


def _coded(c):
    return (bytes(c.data()), _tp(c.pts()), c.media_type.value,
            c.media_format.value, c.asset_id(),
            [(k.id_asset, _tp(k.pts)) for k in c.constituents()])


def case_uncompressed_picture(m):
    data = m.codec.pack_uncompressed_picture(_pict(m))
    out = m.codec.unpack_uncompressed_picture(data, asset_id="a",
                                              workspace_id="w")
    return data, out.size(), out.pixel_format().value, _planes(out)


def case_uncompressed_audio(m):
    data = m.codecs.pack_uncompressed_audio(_audio(m))
    out = m.codecs.unpack_uncompressed_audio(data, asset_id="a",
                                             workspace_id="w")
    return data, out.sample_rate(), out.number_channels(), _pcm(out)


def case_video_codec_via_tx(m):
    coded = m.codec.VideoEncoder(m.media.MediaFormat.uncompressed)(
        _pict(m, seed=3)).value()
    return _coded(coded), _planes(m.codec.VideoDecoder()(coded).value())


def case_png_codec(m):
    rng = np.random.default_rng(0)
    rgba = _u8(rng, 16, 24, 4)
    rgba[..., 3] = 255
    PF = m.media.PixelFormat
    img = m.media.ImageBuffer(PF.RGBA, m.media.BufferType.cpu, (24, 16),
                              tuple(m.media.planes_for_format(PF.RGBA,
                                                              (24, 16))),
                              (rgba,))
    coded = m.codec.VideoEncoder(m.media.MediaFormat.png)(
        m.media.PictureSample(img, "a", "w")).value()
    decoded = m.codec.VideoDecoder()(coded).value()
    assert np.array_equal(np.asarray(decoded.planes()[0]), rgba)
    return _coded(coded), _planes(decoded)


def case_garbage_bitstream(m):
    s = m.media.CodedMediaSample(
        buffer=b"x", pts_value=m.core.TimePoint(0, 1),
        dts_value=m.core.TimePoint(0, 1), media_type=m.media.MediaType.video,
        media_format=m.media.MediaFormat.avc, id_asset="a")
    box = m.codec.VideoDecoder()(s)
    return (m.codecs.bitstream_backend(), box.is_error(), box.is_nothing(),
            box.is_just())


def case_asset_rename(m):
    out = m.codec.asset_rename("new")(_pict(m).with_(
        pts=m.core.TimePoint(5, 30))).value()
    return out.asset_id(), [(c.id_asset, _tp(c.pts))
                            for c in out.constituents()]


def case_video_transcoder(m):
    MF = m.media.MediaFormat
    coded = m.codec.VideoEncoder(MF.uncompressed)(_pict(m, seed=4)).value()
    png = m.codec.make_video_transcoder("out", MF.png)(coded)
    out = m.codec.make_video_transcoder("out", MF.uncompressed)(coded).value()
    return (png.is_error(), png.is_just(), _coded(out),
            _planes(m.codec.VideoDecoder()(out).value()))


def case_audio_encoder_segments(m):
    enc = m.codec.AudioEncoder(m.media.MediaFormat.uncompressed,
                               frame_size=960)
    out = []
    for i in range(4):
        out.extend(enc(_audio(m, 1024, seed=i, pts=1024 * i)).value())
    dec = m.codec.AudioDecoder()
    return ([_coded(c) for c in out],
            [(s.number_samples(), _pcm(s)) for s in (dec(c).value()
                                                     for c in out)])


def case_audio_transcoder(m):
    """rename >> decode >> SRC (44.1 -> 48 kHz, host route) >> segment to
    1024 >> encode, over five 441-sample packets."""
    enc = m.codec.AudioEncoder(m.media.MediaFormat.uncompressed,
                               frame_size=441)
    chain = m.codec.make_audio_transcoder("out", sample_rate=48000,
                                          frame_size=1024)
    outs = []
    for i in range(5):
        for c in enc(_audio(m, 441, seed=i, pts=441 * i, rate=44100)).value():
            box = chain(c)
            if box.is_just():
                outs.extend(box.value())
    dec = m.codec.AudioDecoder()
    return [(_coded(c), _pcm(dec(c).value())) for c in outs]


def case_text_renderer(m):
    out = m.codec.TextRenderer()(m.codec.TextSample(
        text="Hi!", font_size=24, color=(1.0, 0.5, 0.0, 1.0), id_asset="t",
        id_workspace="w")).value()
    rgba = np.asarray(out.planes()[0])
    mask = rgba[..., 3] > 200
    assert mask.any() and rgba[..., 0][mask].min() > 150
    return out.pixel_format().value, rgba.tolist()


def case_synthetic_source_pacing(m):
    TimePoint = m.core.TimePoint
    clock = m.core.StepClock(TimePoint(100, 1000))
    frames = []
    enc = m.codec.VideoEncoder(m.media.MediaFormat.uncompressed)

    def puller(i):
        return None if i >= 10 else enc(_pict(m, seed=i)).value()

    src = m.codec.SyntheticSource(clock, puller,
                                  frame_duration=TimePoint(100, 1000),
                                  asset_id="file")
    keep = src >> m.core.Tx(lambda s: (frames.append(s),
                                       m.core.EventBox.just(s))[1])
    src.play()
    for _ in range(30):
        clock.step()
    del keep
    assert len(frames) == 10
    return [_coded(f) for f in frames]


def case_synthetic_source_resume(m):
    TimePoint = m.core.TimePoint
    clock = m.core.StepClock(TimePoint(100, 1000))
    mk = m.media.CodedMediaSample(
        buffer=b"x", pts_value=TimePoint(0, 1000),
        dts_value=TimePoint(0, 1000), media_type=m.media.MediaType.video,
        media_format=m.media.MediaFormat.uncompressed)
    src = m.codec.SyntheticSource(clock, lambda i: mk,
                                  frame_duration=TimePoint(100, 1000))
    got = []
    keep = src >> m.core.Tx(lambda s: (got.append(_tp(s.pts())),
                                       m.core.EventBox.nothing(None))[1])
    src.play()
    for _ in range(30):
        clock.step()
    src.stop()
    for _ in range(10):
        clock.step()
    src.play()
    for _ in range(10):
        clock.step()
    del keep
    return got


def case_transcode_container(m):
    clock = m.core.StepClock(m.core.TimePoint(1, 30))
    bus = m.core.Bus(clock)
    outputs = []
    m.codec.TranscodeContainer(bus, m.core.Tx(
        lambda s: (outputs.append(s), m.core.EventBox.just(s))[1]))
    coded = m.codec.VideoEncoder(m.media.MediaFormat.uncompressed)(
        _pict(m, seed=5)).value()
    bus.append(m.core.EventBox.just(coded))
    bus.append(m.core.EventBox.just(coded))
    return [_coded(o) for o in outputs]


def case_bitstream_framing(m):
    ff = m.ff
    nals = [b"\x65" + b"idr-data" * 10, b"\x41" + b"p-frame"]
    annexb = b"".join(b"\x00\x00\x00\x01" + n for n in nals)
    sps, pps = bytes([0x67, 66, 0, 31]) + b"sps-body", bytes([0x68]) + b"pps"
    p1, p2 = b"a" * 50, b"b" * 99
    stream = (ff.adts_header(48000, 2, len(p1)) + p1
              + ff.adts_header(48000, 2, len(p2)) + p2)
    frames, rest = ff.parse_adts_frames(stream + b"\xff")
    return (ff.split_annexb(annexb), ff.annexb_to_avcc(annexb),
            ff.sps_pps_from_avcdcr(ff.make_avcdcr(sps, pps)), frames, rest,
            [ff.adts_payload(f) for f in frames])


def case_ffmpeg_gating(m):
    s = m.media.CodedMediaSample(
        buffer=b"\x00\x00\x00\x05\x65abcd",
        pts_value=m.core.TimePoint(0, 1), dts_value=m.core.TimePoint(0, 1),
        media_type=m.media.MediaType.video,
        media_format=m.media.MediaFormat.avc,
        side={"config": b"\x01\x42\x00\x1f\xff\xe1\x00\x04\x67\x42\x00\x1f"
                        b"\x01\x00\x01\x68"})
    if m.ff.ffmpeg_path() is not None:
        return "ffmpeg found"
    box = m.ff.FFmpegVideoDecoder()(s)
    return box.is_error(), box.err().desc


def case_flat_partial(m):
    EventBox, EventError = m.core.EventBox, m.core.EventError
    lifted = m.codec.flat(m.core.Tx(
        lambda v: EventBox.error(EventError("t", -1, "bad")) if v < 0
        else EventBox.just(v * 10)))
    box = lifted.apply(EventBox.just([1, -1, 2]))
    return box.value(), lifted.apply(EventBox.just([-1, -2])).is_error()


def case_segmenter(m):
    """Uneven packets (300, 1000, 17, 2048, 5) into 1024-sample segments,
    then the flushed tail."""
    seg = m.seg.AudioPacketSegmenter(m.core.TimePoint(1024, 48000))
    out, pts = [], 0
    for i, n in enumerate((300, 1000, 17, 2048, 5)):
        out.extend(seg(_audio(m, n, seed=10 + i, pts=pts)).value())
        pts += n
    out.extend(seg.flush())
    return [(s.number_samples(), _tp(s.pts()), _pcm(s)) for s in out]


CASES = [case_uncompressed_picture, case_uncompressed_audio,
         case_video_codec_via_tx, case_png_codec, case_garbage_bitstream,
         case_asset_rename, case_video_transcoder,
         case_audio_encoder_segments, case_audio_transcoder,
         case_text_renderer, case_synthetic_source_pacing,
         case_synthetic_source_resume, case_transcode_container,
         case_bitstream_framing, case_ffmpeg_gating, case_flat_partial,
         case_segmenter]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__[5:])
def test_port_equals_jax(case):
    assert case(PORT) == case(JAX)


def test_codec_exports_the_jax_names():
    assert set(port_codec.__all__) == set(jax_codec.__all__)
    assert all(hasattr(port_codec, n) for n in jax_codec.__all__)


@pytest.mark.parametrize("module", [port_codecs, jax_codecs],
                         ids=["port", "jax"])
def test_unsupported_codec_errors_cleanly(monkeypatch, module):
    """With no real-codec backend, a bitstream format errors cleanly with
    the same description in both packages."""
    m = PORT if module is port_codecs else JAX
    monkeypatch.setattr(module, "bitstream_backend", lambda: None)
    s = m.media.CodedMediaSample(
        buffer=b"x", pts_value=m.core.TimePoint(0, 1),
        dts_value=m.core.TimePoint(0, 1), media_type=m.media.MediaType.video,
        media_format=m.media.MediaFormat.avc, id_asset="a")
    box = m.codec.VideoDecoder()(s)
    assert box.is_error() and "avc" in box.err().desc


def test_codec_stages_take_torch_tensors():
    """Planes and PCM that are torch tensors (the Composer's output) encode
    to the bytes numpy input gives: the uncompressed video and audio
    encoders, the PNG encoder and the segmenter read them through
    ``download``."""
    MF = port_media.MediaFormat
    pic = _pict(PORT, seed=7)
    tpic = pic.with_(img=pic.img.with_buffers(
        tuple(torch.from_numpy(np.array(p)) for p in pic.planes())))
    assert isinstance(tpic.planes()[0], torch.Tensor)
    enc = port_codec.VideoEncoder(MF.uncompressed)
    assert enc(tpic).value().data() == enc(pic).value().data()
    rgba = _pict(PORT, (24, 16), seed=8, fmt="RGBA")
    trgba = rgba.with_(img=rgba.img.with_buffers(
        (torch.from_numpy(np.array(rgba.planes()[0])),)))
    png = port_codec.VideoEncoder(MF.png)
    assert png(trgba).value().data() == png(rgba).value().data()
    audio = [_audio(PORT, 700, seed=i, pts=700 * i) for i in range(3)]
    taudio = [a.with_(buffers=tuple(torch.from_numpy(np.array(b))
                                    for b in a.data())) for a in audio]
    outs = []
    for samples in (audio, taudio):
        aenc = port_codec.AudioEncoder(MF.uncompressed, frame_size=960)
        outs.append([c.data() for s in samples for c in aenc(s).value()])
    assert outs[0] == outs[1] and len(outs[0]) == 2
