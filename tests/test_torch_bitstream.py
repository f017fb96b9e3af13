"""The port's bitstream and container helpers against the JAX package's,
on the CPU.

Each case runs the same inputs (hand-assembled SPS / ASC / VP9 / AV1
headers, Ogg, IVF and Y4M streams) through ``swiftvideo_tpu.codec`` and
through ``swiftvideo_tpu_torch.codec``, checks the JAX test's expected
values on both, and requires the two packages' outputs to be equal: bytes,
parsed fields, raised errors.  Twins of ``tests/test_bitstream.py`` and
``tests/test_containers.py``, plus the ``media/coded.py`` branches that
read them (``basic_media_description`` for every format, ``is_keyframe``
for av1).  The native shim is the repo's ``csrc/libsvbitstream.so`` where
it builds; the pure-Python paths are checked against it too.  Tolerance:
none.
"""

import struct
from types import SimpleNamespace

import numpy as np
import pytest

import swiftvideo_tpu.codec.bitstream as jax_bitstream
import swiftvideo_tpu.codec.containers as jax_containers
import swiftvideo_tpu.codec.ffmpeg_subprocess as jax_ffmpeg
import swiftvideo_tpu.codec.transcode as jax_transcode
import swiftvideo_tpu.core as jax_core
import swiftvideo_tpu.media.coded as jax_coded
import swiftvideo_tpu_torch.codec.bitstream as port_bitstream
import swiftvideo_tpu_torch.codec.containers as port_containers
import swiftvideo_tpu_torch.codec.ffmpeg_subprocess as port_ffmpeg
import swiftvideo_tpu_torch.codec.transcode as port_transcode
import swiftvideo_tpu_torch.core as port_core
import swiftvideo_tpu_torch.media.coded as port_coded

JAX = SimpleNamespace(bs=jax_bitstream, ct=jax_containers, ff=jax_ffmpeg,
                      tc=jax_transcode, core=jax_core, coded=jax_coded)
PORT = SimpleNamespace(bs=port_bitstream, ct=port_containers, ff=port_ffmpeg,
                       tc=port_transcode, core=port_core, coded=port_coded)


class _BitWriter:
    def __init__(self):
        self.bits = []

    def u(self, val: int, n: int):
        for i in range(n - 1, -1, -1):
            self.bits.append((val >> i) & 1)
        return self

    def ue(self, val: int):
        k = val + 1
        n = k.bit_length()
        self.u(0, n - 1)
        self.u(k, n)
        return self

    def bytes(self) -> bytes:
        bits = self.bits + [0] * ((8 - len(self.bits) % 8) % 8)
        return bytes(int("".join(map(str, bits[i:i + 8])), 2)
                     for i in range(0, len(bits), 8))


def make_sps(width_mbs, height_mbs, crop=(0, 0, 0, 0), profile=66):
    w = _BitWriter()
    w.u(0x67, 8).u(profile, 8).u(0, 8).u(31, 8).ue(0)
    if profile == 100:
        w.ue(1).ue(0).ue(0).u(0, 1).u(0, 1)
    w.ue(4).ue(0).ue(4).ue(1).u(0, 1)
    w.ue(width_mbs - 1).ue(height_mbs - 1).u(1, 1).u(1, 1)
    if any(crop):
        w.u(1, 1)
        for c in crop:
            w.ue(c)
    else:
        w.u(0, 1)
    return w.bytes()


def make_asc(aot=2, freq_index=4, chan=2, frame960=False):
    w = _BitWriter()
    w.u(aot, 5).u(freq_index, 4).u(chan, 4).u(1 if frame960 else 0, 1)
    w.u(0, 1).u(0, 1)
    return w.bytes()


def make_h265_sps(width, height, crop=(0, 0, 0, 0), chroma=1, max_sub=0,
                  nal_header=True, vps_id=0, nesting=1):
    w = _BitWriter()
    if nal_header:
        w.u(33 << 1, 8).u(1, 8)
    w.u(vps_id, 4).u(max_sub, 3).u(nesting, 1)
    w.u(0, 2).u(0, 1).u(1, 5).u(0x60000000, 32).u(0b1011, 4)
    w.u(0, 32).u(0, 12).u(120, 8)
    for _ in range(max_sub):
        w.u(0, 1).u(0, 1)
    if max_sub > 0:
        for _ in range(max_sub, 8):
            w.u(0, 2)
    w.ue(0).ue(chroma)
    if chroma == 3:
        w.u(0, 1)
    w.ue(width).ue(height)
    if any(crop):
        w.u(1, 1)
        for c in crop:
            w.ue(c)
    else:
        w.u(0, 1)
    w.u(1, 1)
    return w.bytes()


def make_vp9_keyframe(w, h, color_space=3, full_range=0):
    bw = _BitWriter()
    bw.u(2, 2).u(0, 1).u(0, 1).u(0, 1).u(0, 1).u(1, 1).u(0, 1)
    bw.u(0x498342, 24).u(color_space, 3).u(full_range, 1)
    bw.u(w - 1, 16).u(h - 1, 16)
    return bw.bytes()


def make_av1_seq_obu(w, h, reduced=False, wbits=11, hbits=11):
    bw = _BitWriter()
    bw.u(0, 3).u(0, 1).u(1 if reduced else 0, 1)
    if reduced:
        bw.u(0, 5)
    else:
        bw.u(0, 1).u(1, 1).u(0, 5).u(0, 12).u(8, 5).u(0, 1).u(1, 1).u(3, 4)
    bw.u(wbits - 1, 4).u(hbits - 1, 4).u(w - 1, wbits).u(h - 1, hbits)
    payload = bw.bytes()
    return bytes([0x0A, len(payload)]) + payload


def av1_frame_obu(first_byte, header_only=False):
    payload = bytes([first_byte]) + b"xy"
    return bytes([((3 if header_only else 6) << 3) | 0x02,
                  len(payload)]) + payload


VP8_KEY = bytes([0x10, 0x00, 0x00, 0x9D, 0x01, 0x2A, 640 & 0xFF, 640 >> 8,
                 360 & 0xFF, 360 >> 8]) + b"\x00" * 8


def _outcome(fn, *args):
    """(value,) or the raised error's type name: both packages must agree
    on failures too."""
    try:
        return ("ok", fn(*args))
    except (ValueError, IndexError, struct.error) as e:
        return ("err", type(e).__name__)


# --- cases: each takes one package's namespace and returns its outputs ----

def case_golomb(m):
    assert m.bs.test_golomb_dec() == 254
    br = m.bs.ExpGolomb(b"\x00" * 12)
    zero_run = bytes([0x67, 66, 0x00, 30]) + b"\x00" * 12
    out = (br.ue(), br.overrun,
           _outcome(m.bs._h264_sps_frame_size_py, zero_run),
           _outcome(m.bs.h264_sps_frame_size, zero_run))
    assert out[2] == out[3] == ("err", "ValueError")
    return out


def case_h264_sps(m):
    out = [m.bs.h264_sps_frame_size(make_sps(80, 45)),
           m.bs.h264_sps_frame_size(make_sps(120, 68, crop=(0, 0, 0, 4))),
           m.bs.h264_sps_frame_size(make_sps(80, 45, profile=100)),
           m.bs._h264_sps_frame_size_py(make_sps(120, 68, crop=(0, 0, 0, 4)))]
    assert out == [(1280, 720), (1920, 1080), (1280, 720), (1920, 1080)]
    return out


def case_aac_asc(m):
    w = _BitWriter()
    w.u(2, 5).u(15, 4).u(41000, 24).u(1, 4).u(0, 3)
    blob = make_asc(freq_index=3, frame960=True)
    out = [m.bs.aac_parse_asc(make_asc()), m.bs.aac_parse_asc(blob),
           m.bs.aac_parse_asc(w.bytes()), m.bs._aac_parse_asc_py(blob),
           m.bs.make_asc(48000, 2), m.bs.make_asc(44100, 1),
           m.bs.aac_parse_asc(m.bs.make_asc(44100, 1))]
    assert out[:4] == [(2, 44100, 1024), (2, 48000, 960), (1, 41000, 1024),
                       (2, 48000, 960)]
    return out


def case_h265_sps(m):
    ambiguous = make_h265_sps(1280, 720, vps_id=4, max_sub=1, nesting=0,
                              nal_header=False)
    out = [m.bs.h265_sps_frame_size(ambiguous),
           m.bs.h265_sps_frame_size(make_h265_sps(1280, 720, vps_id=4,
                                                  max_sub=1, nesting=0)),
           m.bs.h265_sps_frame_size(make_h265_sps(1920, 1088,
                                                  crop=(0, 0, 0, 4))),
           m.bs.h265_sps_frame_size(make_h265_sps(1280, 720,
                                                  nal_header=False)),
           m.bs.h265_sps_frame_size(make_h265_sps(640, 480, crop=(2, 2, 0, 0),
                                                  chroma=3, max_sub=2)),
           _outcome(m.bs.h265_sps_frame_size, make_h265_sps(1920, 1088)[:8])]
    assert out == [(1280, 720), (1280, 720), (1920, 1080), (1280, 720),
                   (636, 480), ("err", "ValueError")]
    return out


def case_random_bytes(m):
    a, b = m.bs.generate_random_bytes(64), m.bs.generate_random_bytes(64)
    assert len(a) == len(b) == 64 and a != b
    return len(a)


def case_vp8_vp9(m):
    out = [m.bs.vp8_frame_size(VP8_KEY),
           _outcome(m.bs.vp8_frame_size, bytes([0x11]) + VP8_KEY[1:]),
           m.bs.vp9_frame_size(make_vp9_keyframe(1280, 720)),
           m.bs.vp9_keyframe_info(make_vp9_keyframe(640, 360, color_space=1))]
    assert out[:3] == [(640, 360), ("err", "ValueError"), (1280, 720)]
    return out


def case_vpcc(m):
    rec = m.ct.make_vpcc(make_vp9_keyframe(1920, 1080, color_space=1))
    out = [rec, m.ct.parse_vpcc(rec),
           m.ct.parse_vpcc(m.ct.make_vpcc(make_vp9_keyframe(352, 288,
                                                            color_space=5))),
           m.ct.parse_vpcc(m.ct.make_vpcc(make_vp9_keyframe(640, 360))),
           _outcome(m.ct.parse_vpcc, rec[:4]),
           _outcome(m.ct.make_vpcc, b"\x84" + b"\x00" * 12)]
    assert out[1]["level"] == 40 and out[2]["level"] == 20
    assert out[3]["level"] == 21 and out[4][0] == out[5][0] == "err"
    return out


def case_av1(m):
    frame = bytes([0x32, 0x03]) + b"xyz"
    td = bytes([0x12, 0x00])
    seq = make_av1_seq_obu(64, 64)
    out = [m.bs.av1_frame_size(make_av1_seq_obu(1920, 1080) + frame),
           m.bs.av1_frame_size(make_av1_seq_obu(640, 360, reduced=True,
                                                wbits=16, hbits=16)),
           m.bs.av1_frame_size(td + make_av1_seq_obu(320, 240)),
           _outcome(m.bs.av1_frame_size, frame),
           _outcome(m.bs.av1_frame_size, bytes([0x0A, 0x40])),
           m.bs.leb128(b"\x05", 0), m.bs.leb128(b"\x80\x02", 0),
           _outcome(m.bs.leb128, b"\x80", 0),
           _outcome(m.bs.leb128, b"\xff" * 9, 0),
           [m.bs.av1_is_keyframe(tu) for tu in (
               seq + av1_frame_obu(0x00), td + av1_frame_obu(0x20),
               seq + av1_frame_obu(0x20), seq + av1_frame_obu(0x80),
               td + av1_frame_obu(0x00, header_only=True),
               make_av1_seq_obu(64, 64, reduced=True) + b"\x01",
               b"\x80bogus", seq + b"\x80garbage")]]
    assert out[:3] == [(1920, 1080), (640, 360), (320, 240)]
    assert out[9] == [True, False, False, False, True, True, False, True]
    return out


def case_av1c(m):
    rec = m.ct.make_av1c(make_av1_seq_obu(1920, 1080) + av1_frame_obu(0x00))
    got = m.ct.parse_av1c(rec)
    assert got["config_obus"] == make_av1_seq_obu(1920, 1080)
    return [rec, got, _outcome(m.ct.parse_av1c, b"\x01\x00\x00\x00"),
            _outcome(m.ct.make_av1c, av1_frame_obu(0x20))]


def case_ivf(m):
    payloads = [bytes([i]) * (10 + i) for i in range(5)]
    stream = m.ct.ivf_header("vp9", 640, 360, n_frames=5)
    for i, p in enumerate(payloads):
        stream += m.ct.ivf_frame(p, i)
    got, rem, header = [], b"", None
    for pos in range(0, len(stream), 7):
        rem += stream[pos:pos + 7]
        h, frames, rem = m.ct.parse_ivf(rem)
        header = h or header
        got.extend(frames)
    assert [p for _, p in got] == payloads and rem == b""
    return stream, header, got


def case_ogg(m):
    pkts = [b"a" * 10, b"b" * 600, b"c" * 510]
    pages = b"".join(m.ct.ogg_page([p], serial=7, seq=i, granule=i * 960)
                     for i, p in enumerate(pkts))
    reader = m.ct.OggPacketReader()
    for pos in range(0, len(pages), 13):
        reader.feed(pages[pos:pos + 13])
    long_packets = reader.packets()
    good1 = m.ct.ogg_page([b"one"], serial=1, seq=0, granule=0)
    bad = bytearray(m.ct.ogg_page([b"two"], serial=1, seq=1, granule=1))
    bad[30] ^= 0xFF
    good2 = m.ct.ogg_page([b"three"], serial=1, seq=2, granule=2)
    reader = m.ct.OggPacketReader()
    reader.feed(good1 + bytes(bad) + good2)
    resync = reader.packets()
    multi = m.ct.ogg_page([b"p0", b"p1", b"p2"], serial=3, seq=0,
                          granule=2880)
    reader = m.ct.OggPacketReader()
    reader.feed(multi)
    assert [g for _, g in reader.packets()] == [-1, -1, 2880]
    assert [p for p, _ in resync] == [b"one", b"three"]
    return pages, long_packets, resync, multi


def case_opus(m):
    head = m.ct.make_opus_head(2, pre_skip=312)
    w = m.ct.OggOpusWriter(2)
    stream = w.page(b"\xfc\xff\xfe") + w.page(b"\xfc\x01\x02")
    multi = m.ct.OggOpusWriter(2).page_packets(
        [b"\xfc\x00" * 3, b"\xfc\x01", b"\xfc\x02"])
    out = []
    for s in (stream, multi):
        reader = m.ct.OggPacketReader()
        reader.feed(s)
        out.append(reader.packets())
    info = m.ct.parse_opus_head(head)
    assert (info["channels"], info["pre_skip"]) == (2, 312)
    assert out[0][0][0][:8] == b"OpusHead"
    # the Ogg stream serial is random per writer: compare the packets
    return head, info, out


def case_ogg_dropped_page(m):
    def raw_page(lacing, body, continued=False, seq=0, granule=-1):
        hdr = (b"OggS\x00" + bytes([1 if continued else 0])
               + struct.pack("<q", granule) + struct.pack("<I", 7)
               + struct.pack("<I", seq) + b"\x00\x00\x00\x00"
               + bytes([len(lacing)]) + bytes(lacing))
        page = bytearray(hdr + body)
        page[22:26] = struct.pack("<I", m.ct.ogg_crc(bytes(page)))
        return bytes(page)

    p2 = bytearray(raw_page([255], b"B" * 255, continued=True, seq=1))
    p2[-1] ^= 0xFF
    r = m.ct.OggPacketReader()
    r.feed(raw_page([255, 255], b"A" * 510) + bytes(p2)
           + raw_page([40, 5], b"C" * 40 + b"fine1", continued=True, seq=2,
                      granule=100)
           + raw_page([5], b"fine2", seq=3, granule=200))
    pkts = r.packets()
    assert [p for p, _ in pkts] == [b"fine1", b"fine2"]
    return pkts


def case_y4m(m):
    w, h = 32, 16
    frames = [bytes([i]) * (w * h * 3 // 2) for i in range(3)]
    stream = m.ct.make_y4m_header(w, h)
    for f in frames:
        stream += b"FRAME\n" + f
    reader = m.ct.Y4MReader()
    got = []
    for pos in range(0, len(stream), 11):
        got.extend(reader.feed(stream[pos:pos + 11]))
    assert got == frames
    params = m.ct.Y4MReader()
    small = bytes(8 * 4 * 3 // 2)
    tolerated = params.feed(b"YUV4MPEG2 W8 H4 F30:1 Ip A1:1 C420mpeg2\n"
                            + b"FRAME Xsome=param\n" + small)
    fps = m.ct.Y4MReader()
    fps.feed(b"YUV4MPEG2 W8 H4 F24000:1001 Ip A1:1 C420jpeg\nFRAME\n" + small)
    data = bytes(range(32)) + bytes([7]) * 8 + bytes([9]) * 8
    planes = [p.tolist() for p in m.ct.y4m_frame_to_planes(data, 8, 4)]
    return (stream, reader.width, reader.height, reader.pix_fmt, tolerated,
            params.fps, fps.fps, planes)


def case_hvcc(m):
    vps, sps, pps = (b"\x40\x01" + bytes(range(10)),
                     b"\x42\x01" + bytes(range(20)), b"\x44\x01" + bytes(4))
    rec = m.ct.make_hvcc(vps, sps, pps)
    params = m.ct.params_from_hvcc(rec)
    assert params[33] == [sps] and (rec[21] & 0x3) == 3
    return rec, params


def case_annexb(m):
    nal1, nal2 = b"\x65\x11\x22\x00\x00", b"\x41\x33"
    stream = b"\x00\x00\x01" + nal1 + b"\x00" + b"\x00\x00\x01" + nal2
    avcc = (len(nal1).to_bytes(4, "big") + nal1
            + len(nal2).to_bytes(4, "big") + nal2)
    out = [m.ff.split_annexb(stream), m.ff.avcc_to_annexb(avcc),
           m.ff.annexb_to_avcc(m.ff.avcc_to_annexb(avcc)),
           m.ff.make_avcdcr(make_sps(80, 45), b"\x68\xee\x3c\x80"),
           m.ff.adts_header(48000, 2, 100)]
    assert out[0] == [nal1, nal2] and out[2] == avcc
    return out


def case_flat(m):
    Tx, EventBox = m.core.Tx, m.core.EventBox
    flat = m.tc.flat
    out = [flat(Tx(lambda v: EventBox.just(v * 2)))(3).value(),
           flat(Tx(lambda v: EventBox.just(v * 2)))([1, 2, 3]).value(),
           flat(Tx(lambda v: EventBox.just([v, v + 10])))([1, 2]).value(),
           flat(Tx(lambda v: EventBox.error(None)))([1]).is_error(),
           flat(Tx(lambda v: EventBox.nothing(None)))([1, 2]).is_nothing()]
    assert out == [6, [2, 4, 6], [1, 11, 2, 12], True, True]
    return out


def _described(m, fmt, data=b"", side=None, video=True):
    c = m.coded
    sample = c.CodedMediaSample(
        buffer=data, pts_value=m.core.TimePoint(0, 1000),
        dts_value=m.core.TimePoint(0, 1000),
        media_type=c.MediaType.video if video else c.MediaType.audio,
        media_format=getattr(c.MediaFormat, fmt), side=side or {})
    try:
        d = c.basic_media_description(sample)
    except c.MediaDescriptionError as e:
        return ("err", str(e))
    return ("ok", type(d).__name__, tuple(sorted(vars(d).items())))


def case_coded_descriptions(m):
    """``media/coded.py``: every format's stream description and av1's
    keyframe test, which raised in the port before the bitstream module
    was ported."""
    avcdcr = m.ff.make_avcdcr(make_sps(120, 68, crop=(0, 0, 0, 4)),
                              b"\x68\xee\x3c\x80")
    hvcc = m.ct.make_hvcc(b"\x40\x01" + bytes(10),
                          make_h265_sps(1920, 1088, crop=(0, 0, 0, 4)),
                          b"\x44\x01" + bytes(4))
    out = [_described(m, "avc", side={"config": avcdcr}),
           _described(m, "avc", side={"config": b"\x01\x02"}),
           _described(m, "hevc", side={"config": hvcc}),
           _described(m, "vp8", data=VP8_KEY),
           _described(m, "vp9", data=make_vp9_keyframe(1280, 720)),
           _described(m, "av1", data=make_av1_seq_obu(640, 360)),
           _described(m, "aac", side={"config": make_asc(freq_index=3)},
                      video=False),
           _described(m, "opus", side={"config": m.ct.make_opus_head(2)},
                      video=False),
           _described(m, "opus", video=False)]
    key = m.coded.CodedMediaSample(
        buffer=make_av1_seq_obu(64, 64) + av1_frame_obu(0x00),
        pts_value=m.core.TimePoint(0, 1000),
        dts_value=m.core.TimePoint(0, 1000),
        media_type=m.coded.MediaType.video,
        media_format=m.coded.MediaFormat.av1)
    inter = key.with_(buffer=bytes([0x12, 0x00]) + av1_frame_obu(0x20))
    out.append((m.coded.is_keyframe(key), m.coded.is_keyframe(inter)))
    assert out[0][2] == (("size", (1920, 1080)),)
    assert out[-1] == (True, False)
    return out


CASES = [case_golomb, case_h264_sps, case_aac_asc, case_h265_sps,
         case_random_bytes, case_vp8_vp9, case_vpcc, case_av1, case_av1c,
         case_ivf, case_ogg, case_opus, case_ogg_dropped_page, case_y4m,
         case_hvcc, case_annexb, case_flat, case_coded_descriptions]


def _plain(v):
    """Numpy arrays compare by value."""
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, (list, tuple)):
        return type(v)(_plain(x) for x in v)
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    return v


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__[5:])
def test_port_equals_jax(case):
    assert _plain(case(PORT)) == _plain(case(JAX))


def test_native_and_python_paths_agree():
    """The port loads the repo's shim (or runs the pure-Python path when
    it does not build), and both paths give the JAX package's fields."""
    assert port_bitstream.native_available() == jax_bitstream.native_available()
    sps = make_sps(120, 68, crop=(0, 0, 0, 4))
    blob = make_asc(freq_index=3, frame960=True)
    assert (port_bitstream._h264_sps_frame_size_py(sps)
            == port_bitstream.h264_sps_frame_size(sps)
            == jax_bitstream.h264_sps_frame_size(sps))
    assert (port_bitstream._aac_parse_asc_py(blob)
            == port_bitstream.aac_parse_asc(blob)
            == jax_bitstream.aac_parse_asc(blob))
    assert port_bitstream._CSRC == jax_bitstream._CSRC
