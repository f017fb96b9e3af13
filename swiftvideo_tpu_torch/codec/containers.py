"""Pure container / framing codecs used by the subprocess FFmpeg backend.

The reference links libavformat/libavcodec directly and passes packets via
``SwiftFFmpeg`` (`reference Sources/SwiftVideo_FFmpeg/dec.video.ffmpeg.swift:109-137`,
``enc.audio.ffmpeg.swift:119-160``), so it never needs wire framing.  Our
backend talks to an ffmpeg *process* over pipes, so every packet stream must
be wrapped in a self-delimiting container:

* **IVF** — trivial length-prefixed container for VP8/VP9 packet streams
  (32-byte file header + 12-byte frame headers, little-endian).
* **Ogg** — page framing for Opus packet streams (RFC 3533 pages + RFC 7845
  OpusHead/OpusTags encapsulation).  Opus packets are not self-delimiting,
  so Ogg is the only way to pipe them.
* **Y4M** (yuv4mpegpipe) — self-describing raw-video stream used for
  *decoder output*: dimensions come from the stream header instead of a
  fragile SPS parse, so one reader covers H.264/HEVC/VP8/VP9 uniformly.
* **hvcC** — HEVCDecoderConfigurationRecord parse/build (ISO 14496-15
  §8.3.3.1), the HEVC analogue of the reference's AVCDecoderConfigurationRecord
  handling (enc.video.ffmpeg.swift:267-297).

Everything here is pure bytes-in/bytes-out and unit-tested without ffmpeg.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

# --- IVF (VP8/VP9) ----------------------------------------------------------

_IVF_FOURCC = {"vp8": b"VP80", "vp9": b"VP90", "av1": b"AV01"}


def ivf_header(codec: str, width: int, height: int, *,
               timebase: Tuple[int, int] = (1, 30), n_frames: int = 0) -> bytes:
    """32-byte IVF file header."""
    num, den = timebase
    return (b"DKIF" + struct.pack("<HH", 0, 32) + _IVF_FOURCC[codec]
            + struct.pack("<HHIIII", width, height, den, num, n_frames, 0))


def ivf_frame(payload: bytes, pts: int) -> bytes:
    """12-byte IVF frame header + payload."""
    return struct.pack("<IQ", len(payload), pts) + payload


def parse_ivf(data: bytes) -> Tuple[Optional[dict], List[Tuple[int, bytes]],
                                    bytes]:
    """Parse an IVF byte stream.

    Returns ``(header_or_None, [(pts, payload), ...], remainder)`` where the
    header dict is present once at least 32 bytes arrived and remainder is
    the unconsumed tail (feed it back with more bytes appended).
    """
    pos = 0
    header = None
    if data[:4] == b"DKIF":
        if len(data) < 32:
            return None, [], data
        w, h, den, num, nf, _ = struct.unpack_from("<HHIIII", data, 12)
        header = {"codec": data[8:12], "width": w, "height": h,
                  "timebase": (num, den), "n_frames": nf}
        pos = 32
    frames = []
    while pos + 12 <= len(data):
        size, pts = struct.unpack_from("<IQ", data, pos)
        if pos + 12 + size > len(data):
            break
        frames.append((pts, data[pos + 12:pos + 12 + size]))
        pos += 12 + size
    return header, frames, data[pos:]


# --- Ogg page framing (RFC 3533) ---------------------------------------------

def _ogg_crc_table() -> List[int]:
    table = []
    for i in range(256):
        r = i << 24
        for _ in range(8):
            r = ((r << 1) ^ 0x04C11DB7) if (r & 0x80000000) else (r << 1)
        table.append(r & 0xFFFFFFFF)
    return table


_OGG_CRC = _ogg_crc_table()


def ogg_crc(data: bytes) -> int:
    """Ogg's CRC-32: poly 0x04C11DB7, no reflection, init/xorout 0."""
    crc = 0
    for b in data:
        crc = ((crc << 8) & 0xFFFFFFFF) ^ _OGG_CRC[((crc >> 24) & 0xFF) ^ b]
    return crc


def ogg_page(packets: List[bytes], *, serial: int, seq: int, granule: int,
             bos: bool = False, eos: bool = False,
             continued: bool = False) -> bytes:
    """Build one Ogg page holding ``packets`` (each fully contained)."""
    lacing = bytearray()
    body = bytearray()
    for pkt in packets:
        n = len(pkt)
        while True:
            seg = min(n, 255)
            lacing.append(seg)
            n -= seg
            if seg < 255:
                break
            if n == 0:          # length multiple of 255: 0-lacing terminator
                lacing.append(0)
                break
        body += pkt
    if len(lacing) > 255:
        raise ValueError("packet set too large for one page")
    header_type = (1 if continued else 0) | (2 if bos else 0) | \
        (4 if eos else 0)
    head = (b"OggS\x00" + bytes([header_type])
            + struct.pack("<qII", granule, serial, seq)
            + b"\x00\x00\x00\x00" + bytes([len(lacing)]) + bytes(lacing))
    page = bytearray(head + bytes(body))
    crc = ogg_crc(bytes(page))
    page[22:26] = struct.pack("<I", crc)
    return bytes(page)


class OggPacketReader:
    """Incremental Ogg page parser -> packet stream.

    Feed arbitrary byte chunks; :meth:`packets` yields completed packets
    (handling cross-page continuation).  CRC is verified; corrupt pages are
    skipped by resyncing on the next capture pattern.
    """

    def __init__(self):
        self._buf = bytearray()
        self._partial = bytearray()
        self._broken = False     # a dropped page orphaned _partial
        self._out: List[Tuple[bytes, int]] = []

    def feed(self, data: bytes) -> None:
        self._buf += data
        self._parse()

    def _parse(self) -> None:
        while True:
            idx = self._buf.find(b"OggS")
            if idx < 0:
                del self._buf[:max(0, len(self._buf) - 3)]
                return
            if idx:
                del self._buf[:idx]
            if len(self._buf) < 27:
                return
            nseg = self._buf[26]
            header_len = 27 + nseg
            if len(self._buf) < header_len:
                return
            lacing = self._buf[27:header_len]
            body_len = sum(lacing)
            if len(self._buf) < header_len + body_len:
                return
            page = bytes(self._buf[:header_len + body_len])
            del self._buf[:header_len + body_len]
            check = bytearray(page)
            check[22:26] = b"\x00\x00\x00\x00"
            if ogg_crc(bytes(check)) != struct.unpack_from("<I", page, 22)[0]:
                # dropped page: any packet spanning it is unrecoverable —
                # orphan the partial so a LATER continued page is not
                # spliced onto stale data (missing-middle corruption)
                self._partial.clear()
                self._broken = True
                continue  # resync on next OggS
            granule = struct.unpack_from("<q", page, 6)[0]
            continued = page[5] & 1
            if not continued:
                self._partial.clear()
                self._broken = False
            pos = header_len
            done: List[bytes] = []
            # after a dropped page, discard the continuation tail of the
            # corrupt packet (segments up to the first terminator)
            skipping = self._broken and bool(continued)
            for i, seg in enumerate(lacing):
                chunk = page[pos:pos + seg]
                pos += seg
                if skipping:
                    if seg < 255:
                        skipping = False
                        self._broken = False
                    continue
                self._partial += chunk
                if seg < 255:
                    done.append(bytes(self._partial))
                    self._partial.clear()
            # the page granule position applies to the LAST packet
            # completed on the page (Ogg framing spec); earlier packets
            # get -1 so granule-delta consumers can divide the page
            # duration across them instead of charging it to the first
            for i, pk in enumerate(done):
                self._out.append((pk, granule if i == len(done) - 1
                                  else -1))

    def packets(self) -> List[Tuple[bytes, int]]:
        """Completed ``(packet, page_granule)`` pairs since the last call."""
        out, self._out = self._out, []
        return out


# --- Opus-in-Ogg encapsulation (RFC 7845) ------------------------------------

def make_opus_head(channels: int, *, pre_skip: int = 312,
                   input_rate: int = 48000) -> bytes:
    return (b"OpusHead" + bytes([1, channels])
            + struct.pack("<HIh", pre_skip, input_rate, 0) + bytes([0]))


def parse_opus_head(data: bytes) -> dict:
    if data[:8] != b"OpusHead":
        raise ValueError("not an OpusHead packet")
    if len(data) < 18:
        raise ValueError("truncated OpusHead packet")
    pre_skip, rate, gain = struct.unpack_from("<HIh", data, 10)
    return {"channels": data[9], "pre_skip": pre_skip, "input_rate": rate,
            "gain": gain}


def make_opus_tags(vendor: bytes = b"swiftvideo_tpu") -> bytes:
    return (b"OpusTags" + struct.pack("<I", len(vendor)) + vendor
            + struct.pack("<I", 0))


_OPUS_SILK_SIZES = (480, 960, 1920, 2880)     # 10/20/40/60 ms at 48 kHz
_OPUS_HYBRID_SIZES = (480, 960)               # 10/20 ms
_OPUS_CELT_SIZES = (120, 240, 480, 960)       # 2.5/5/10/20 ms


def opus_packet_samples(packet: bytes) -> int:
    """PCM samples (at 48 kHz) an Opus packet decodes to, from its TOC
    byte (RFC 6716 §3.1-3.2).  Ogg granule positions derive from this —
    assuming the libopus default 960 mis-stamps 10 ms and 60 ms streams."""
    if not packet:
        return 960
    toc = packet[0]
    config, code = toc >> 3, toc & 0x3
    if config < 12:
        frame = _OPUS_SILK_SIZES[config & 0x3]
    elif config < 16:
        frame = _OPUS_HYBRID_SIZES[config & 0x1]
    else:
        frame = _OPUS_CELT_SIZES[config & 0x3]
    if code == 0:
        nframes = 1
    elif code in (1, 2):
        nframes = 2
    else:
        nframes = (packet[1] & 0x3F) if len(packet) > 1 else 1
        nframes = max(nframes, 1)
    # RFC 6716 §3.4 caps a packet at 120 ms
    return min(frame * nframes, 5760)


class OggOpusWriter:
    """Mux raw Opus packets into an Ogg byte stream for piping to ffmpeg."""

    def __init__(self, channels: int, *, serial: int = 0x53565456,
                 samples_per_packet: int = 960, pre_skip: int = 312,
                 head: Optional[bytes] = None):
        """``head``: reuse a source OpusHead packet verbatim (propagates
        the real pre_skip/gain/mapping instead of synthesizing defaults —
        advisor, round 2); else one is built with ``pre_skip``."""
        self._serial = serial
        self._seq = 0
        self._granule = 0
        self._spp = samples_per_packet
        head_pkt = (head if head is not None and head[:8] == b"OpusHead"
                    else make_opus_head(channels, pre_skip=pre_skip))
        self._head = (ogg_page([head_pkt], serial=serial,
                               seq=0, granule=0, bos=True)
                      + ogg_page([make_opus_tags()], serial=serial, seq=1,
                                 granule=0))
        self._seq = 2

    def header(self) -> bytes:
        head, self._head = self._head, b""
        return head

    def page(self, packet: bytes, *, samples: Optional[int] = None,
             eos: bool = False) -> bytes:
        return self.page_packets([packet], samples_each=samples, eos=eos)

    def page_packets(self, packets: List[bytes], *,
                     samples_each: Optional[int] = None,
                     eos: bool = False) -> bytes:
        """One page holding several packets — real muxers batch ~4 KB of
        packets per page, so the page granule covers all of them."""
        self._granule += ((self._spp if samples_each is None
                           else samples_each) * len(packets))
        out = self.header() + ogg_page(list(packets), serial=self._serial,
                                       seq=self._seq, granule=self._granule,
                                       eos=eos)
        self._seq += 1
        return out


# --- Y4M (yuv4mpegpipe) reader ------------------------------------------------

_Y4M_FORMATS = {b"420": "y420p", b"420jpeg": "y420p", b"420mpeg2": "y420p",
                b"420paldv": "y420p", b"422": "y422p", b"444": "y444p"}


class Y4MReader:
    """Incremental yuv4mpegpipe parser.

    ffmpeg's ``-f yuv4mpeg`` output is self-describing (``YUV4MPEG2 W.. H..``
    stream header + ``FRAME`` markers), which lets one reader serve every
    video codec without bitstream-specific size parsing (the round-1 decoder
    assumed SPS dims == output stride; this removes that assumption).
    """

    def __init__(self):
        self._buf = bytearray()
        self.width: Optional[int] = None
        self.height: Optional[int] = None
        self.pix_fmt: str = "y420p"
        self.fps: Optional[Tuple[int, int]] = None   # (num, den)
        self._frame_bytes: Optional[int] = None

    def _frame_size(self) -> int:
        w, h = self.width, self.height
        if self.pix_fmt == "y420p":
            return w * h * 3 // 2
        if self.pix_fmt == "y422p":
            return w * h * 2
        return w * h * 3

    def feed(self, data: bytes) -> List[bytes]:
        """Feed bytes; returns completed raw frame payloads."""
        self._buf += data
        out: List[bytes] = []
        while True:
            if self.width is None:
                nl = self._buf.find(b"\n")
                if nl < 0:
                    return out
                header = bytes(self._buf[:nl])
                del self._buf[:nl + 1]
                if not header.startswith(b"YUV4MPEG2"):
                    raise ValueError("bad y4m signature")
                for tok in header.split(b" ")[1:]:
                    if tok[:1] == b"W":
                        self.width = int(tok[1:])
                    elif tok[:1] == b"H":
                        self.height = int(tok[1:])
                    elif tok[:1] == b"C":
                        self.pix_fmt = _Y4M_FORMATS.get(tok[1:], "y420p")
                    elif tok[:1] == b"F" and b":" in tok:
                        num, den = tok[1:].split(b":")
                        if int(num) > 0 and int(den) > 0:
                            self.fps = (int(num), int(den))
                if self.width is None or self.height is None:
                    raise ValueError("y4m header missing dimensions")
                self._frame_bytes = self._frame_size()
            nl = self._buf.find(b"\n")
            if nl < 0 or not self._buf.startswith(b"FRAME"):
                if nl >= 0 and not self._buf.startswith(b"FRAME"[:nl + 1]):
                    raise ValueError("bad y4m frame marker")
                return out
            if len(self._buf) < nl + 1 + self._frame_bytes:
                return out
            out.append(bytes(self._buf[nl + 1:nl + 1 + self._frame_bytes]))
            del self._buf[:nl + 1 + self._frame_bytes]


def make_y4m_header(width: int, height: int, *, fps: Tuple[int, int] = (30, 1),
                    pix: bytes = b"420") -> bytes:
    return (b"YUV4MPEG2 W%d H%d F%d:%d Ip A1:1 C%s\n"
            % (width, height, fps[0], fps[1], pix))


# --- hvcC (HEVCDecoderConfigurationRecord, ISO 14496-15 §8.3.3.1) -------------

_HEVC_NAL_VPS, _HEVC_NAL_SPS, _HEVC_NAL_PPS = 32, 33, 34


def params_from_hvcc(record: bytes) -> Dict[int, List[bytes]]:
    """Parameter-set NALs keyed by NAL type (32=VPS, 33=SPS, 34=PPS).

    Raises ValueError on truncated/hostile records (never IndexError or
    struct.error — config records arrive from the network)."""
    if len(record) < 23 or record[0] != 1:
        raise ValueError("bad hvcC record")
    pos = 22
    n_arrays = record[pos]
    pos += 1
    out: Dict[int, List[bytes]] = {}
    for _ in range(n_arrays):
        if pos + 3 > len(record):
            raise ValueError("truncated hvcC array header")
        nal_type = record[pos] & 0x3F
        n_nalus = struct.unpack_from(">H", record, pos + 1)[0]
        pos += 3
        for _ in range(n_nalus):
            if pos + 2 > len(record):
                raise ValueError("truncated hvcC nalu length")
            n = struct.unpack_from(">H", record, pos)[0]
            pos += 2
            if pos + n > len(record):
                raise ValueError("truncated hvcC nalu payload")
            out.setdefault(nal_type, []).append(record[pos:pos + n])
            pos += n
    return out


def make_hvcc(vps: bytes, sps: bytes, pps: bytes) -> bytes:
    """Minimal hvcC from raw parameter-set NALs.

    The profile_tier_level block (12 bytes) sits at a fixed offset in the
    SPS RBSP: 2-byte NAL header, then 1 byte of sps_video_parameter_set_id/
    max_sub_layers/nesting, then PTL.  Emulation-prevention bytes cannot
    occur inside PTL's first 12 bytes for conformant streams (values avoid
    0x000000 runs), so raw-offset extraction is safe here.
    """
    ptl = sps[3:15] if len(sps) >= 15 else bytes(12)
    rec = bytearray()
    rec.append(1)                      # configurationVersion
    rec += ptl[0:1]                    # profile_space/tier/profile_idc
    rec += ptl[1:5]                    # profile_compatibility_flags
    rec += ptl[5:11]                   # constraint_indicator_flags
    rec += ptl[11:12]                  # level_idc
    rec += struct.pack(">H", 0xF000)   # min_spatial_segmentation_idc
    rec.append(0xFC)                   # parallelismType
    rec.append(0xFC | 1)               # chromaFormat 4:2:0
    rec.append(0xF8)                   # bitDepthLumaMinus8
    rec.append(0xF8)                   # bitDepthChromaMinus8
    rec += struct.pack(">H", 0)        # avgFrameRate
    rec.append((0 << 6) | (1 << 3) | (1 << 2) | 3)  # numTemporalLayers=1,
    # temporalIdNested=1, lengthSizeMinusOne=3
    rec.append(3)                      # numOfArrays
    for nal_type, nal in ((_HEVC_NAL_VPS, vps), (_HEVC_NAL_SPS, sps),
                          (_HEVC_NAL_PPS, pps)):
        rec.append(0x80 | nal_type)    # array_completeness=1
        rec += struct.pack(">H", 1)
        rec += struct.pack(">H", len(nal)) + nal
    return bytes(rec)


# VP9 level by max luma picture size (VP9 spec Annex A levels table) —
# first level whose picture-size budget fits; good enough for a config
# record (rate-based constraints need stream stats we don't track).
_VP9_LEVELS = [(36864, 10), (73728, 11), (122880, 20), (245760, 21),
               (552960, 30), (983040, 31), (2228224, 40), (8912896, 50),
               (35651584, 60)]

# (colourPrimaries, transferCharacteristics, matrixCoefficients) per
# VP9 color_space value (spec §7.2.2: 1=601, 2=709, 3=SMPTE170,
# 4=SMPTE240, 5=BT2020, 7=sRGB); unlisted map to "unspecified" (2,2,2).
_VP9_CICP = {1: (6, 6, 6),             # CS_BT_601 -> SMPTE 170M
             2: (1, 1, 1),             # CS_BT_709
             3: (6, 6, 6),             # CS_SMPTE_170
             4: (7, 7, 7),             # CS_SMPTE_240
             5: (9, 14, 9),            # CS_BT_2020 (10-bit transfer)
             7: (1, 13, 0)}            # CS_RGB -> sRGB, identity matrix


def make_vpcc(keyframe: bytes) -> bytes:
    """VPCodecConfigurationRecord (VP9 ISO binding §2.2.1; the E-RTMP
    ``vp09`` SequenceStart payload) built from a VP9 keyframe's
    uncompressed header.  codecInitializationData is always empty for
    VP9 per the binding."""
    from . import bitstream
    info = bitstream.vp9_keyframe_info(keyframe)
    level = next((lv for cap, lv in _VP9_LEVELS
                  if info["width"] * info["height"] <= cap), 62)
    sub = {(1, 1): 1, (1, 0): 2, (0, 0): 3}.get(
        (info["subsampling_x"], info["subsampling_y"]), 0)
    prim, xfer, mat = _VP9_CICP.get(info["color_space"], (2, 2, 2))
    return bytes([info["profile"], level,
                  (info["bit_depth"] << 4) | (sub << 1)
                  | info["full_range"],
                  prim, xfer, mat]) + struct.pack(">H", 0)


def parse_vpcc(record: bytes) -> dict:
    """Inverse of :func:`make_vpcc` (fields of §2.2.1)."""
    if len(record) < 8:
        raise ValueError("short vpcC record")
    return {"profile": record[0], "level": record[1],
            "bit_depth": record[2] >> 4,
            "chroma_subsampling": (record[2] >> 1) & 0x7,
            "full_range": record[2] & 1,
            "colour_primaries": record[3],
            "transfer_characteristics": record[4],
            "matrix_coefficients": record[5],
            "codec_initialization_data":
                record[8:8 + struct.unpack_from(">H", record, 6)[0]]}


def make_av1c(temporal_unit: bytes) -> bytes:
    """AV1CodecConfigurationRecord (AV1 ISO binding §2.3.3; the E-RTMP
    ``av01`` SequenceStart payload) from a temporal unit carrying a
    sequence header OBU.  configOBUs carries the sequence header
    verbatim — the authoritative source decoders actually parse; the
    color-config summary bits use the profile-implied chroma layout
    (profile 0 -> 4:2:0, profile 1 -> 4:4:4, profile 2 -> 4:2:2) at
    8 bits (parsing the true bit depth would need the full color_config
    walk past the frame-id/superblock flags)."""
    from . import bitstream
    info = bitstream.av1_seq_header_info(temporal_unit)
    seq_obu = b""
    for obu_type, payload in bitstream.av1_obus(temporal_unit):
        if obu_type == 1:
            size = bytearray()
            n = len(payload)
            while True:
                b = n & 0x7F
                n >>= 7
                size.append(b | (0x80 if n else 0))
                if not n:
                    break
            seq_obu = bytes([0x0A]) + bytes(size) + payload
            break
    csx, csy = {0: (1, 1), 1: (0, 0), 2: (1, 0)}.get(
        info["profile"], (1, 1))
    return bytes([0x81,                           # marker=1, version=1
                  (info["profile"] << 5) | info["level"],
                  (info["tier"] << 7) | (csx << 3) | (csy << 2),
                  0]) + seq_obu                   # 8-bit, no delay


def parse_av1c(record: bytes) -> dict:
    """Inverse of :func:`make_av1c` (fields of §2.3.3)."""
    if len(record) < 4 or record[0] != 0x81:
        raise ValueError("bad av1C marker/version")
    return {"profile": record[1] >> 5, "level": record[1] & 0x1F,
            "tier": record[2] >> 7,
            "high_bitdepth": (record[2] >> 6) & 1,
            "twelve_bit": (record[2] >> 5) & 1,
            "monochrome": (record[2] >> 4) & 1,
            "chroma_subsampling_x": (record[2] >> 3) & 1,
            "chroma_subsampling_y": (record[2] >> 2) & 1,
            "chroma_sample_position": record[2] & 0x3,
            "config_obus": record[4:]}


def y4m_frame_to_planes(data: bytes, w: int, h: int):
    """Raw 4:2:0 y4m frame payload -> (y, u, v) u8 numpy planes (the one
    shared unpack for the decoder drain and the file demux pullers)."""
    import numpy as np
    y = np.frombuffer(data, np.uint8, w * h).reshape(h, w).copy()
    u = np.frombuffer(data, np.uint8, w * h // 4, w * h
                      ).reshape(h // 2, w // 2).copy()
    v = np.frombuffer(data, np.uint8, w * h // 4, w * h * 5 // 4
                      ).reshape(h // 2, w // 2).copy()
    return y, u, v
