"""Bitstream parsing: Exp-Golomb reader, H.264 SPS, AAC AudioSpecificConfig.

Native path: ``csrc/bitstream.cpp`` compiled to ``libsvbitstream.so`` and
loaded via ctypes (built lazily with ``make -C csrc`` on first import when a
compiler is available).  The pure-Python implementations below are the
behavioral spec and the fallback; both parse the same ITU-T H.264 7.3.2.1.1
and ISO/IEC 14496-3 ASC syntax.

Role parity: the reference's native helper surface
(reference Sources/CSwiftVideo/include/CSwiftVideo.h:30-37 —
``h264_sps_frame_size``, ``aac_parse_asc``, ``generateRandomBytes``,
``test_golomb_dec``).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Tuple

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "csrc")
_LIB_PATH = os.path.join(_CSRC, "libsvbitstream.so")

_lib: Optional[ctypes.CDLL] = None


def _load_native() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH) and os.path.exists(
            os.path.join(_CSRC, "Makefile")):
        try:
            subprocess.run(["make", "-C", _CSRC], capture_output=True,
                           timeout=120, check=False)
        except Exception:
            pass
    if os.path.exists(_LIB_PATH):
        try:
            lib = ctypes.CDLL(_LIB_PATH)
            lib.h264_sps_frame_size.restype = ctypes.c_int
            lib.h264_sps_frame_size.argtypes = [
                ctypes.c_char_p, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]
            lib.aac_parse_asc.restype = ctypes.c_int
            lib.aac_parse_asc.argtypes = [
                ctypes.c_char_p, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32)]
            lib.sv_generate_random_bytes.restype = None
            lib.sv_generate_random_bytes.argtypes = [ctypes.c_char_p,
                                                     ctypes.c_int64]
            lib.test_golomb_dec.restype = ctypes.c_int
            _lib = lib
        except OSError:
            _lib = None
    return _lib


def native_available() -> bool:
    return _load_native() is not None


# --- pure-Python reference implementation ---------------------------------

class ExpGolomb:
    """MSB-first bit reader with Exp-Golomb decode, optionally stripping
    H.264 emulation prevention bytes (00 00 03 -> 00 00)."""

    def __init__(self, data: bytes, strip_epb: bool = False):
        if strip_epb:
            out = bytearray()
            zeros = 0
            for b in data:
                if zeros >= 2 and b == 0x03:
                    zeros = 0
                    continue
                zeros = zeros + 1 if b == 0 else 0
                out.append(b)
            data = bytes(out)
        self._data = data
        self._pos = 0
        self.overrun = False

    def bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            if self._pos >= len(self._data) * 8:
                self.overrun = True
                return 0
            byte = self._data[self._pos >> 3]
            v = (v << 1) | ((byte >> (7 - (self._pos & 7))) & 1)
            self._pos += 1
        return v

    def ue(self) -> int:
        zeros = 0
        while self.bits(1) == 0 and not self.overrun and zeros < 32:
            zeros += 1
        if self.overrun:
            return 0
        if zeros == 32:
            # >= 2^32-1: no legal SPS/PPS field — corrupt input (keeps
            # exact behavioral parity with csrc/bitstream.cpp, where the
            # naive 1 << 32 would be undefined behavior)
            self.overrun = True
            return 0
        return (1 << zeros) - 1 + self.bits(zeros)

    def se(self) -> int:
        k = self.ue()
        return (k + 1) // 2 if k & 1 else -(k // 2)


def _skip_scaling_list(br: ExpGolomb, size: int) -> None:
    last, nxt = 8, 8
    for _ in range(size):
        if nxt != 0:
            nxt = (last + br.se() + 256) % 256
        last = last if nxt == 0 else nxt


_HIGH_PROFILES = {100, 110, 122, 244, 44, 83, 86, 118, 128, 138, 139, 134, 135}


def _h264_sps_frame_size_py(data: bytes) -> Tuple[int, int]:
    off = 1 if (data[0] & 0x1F) == 7 else 0
    br = ExpGolomb(data[off:], strip_epb=True)
    profile_idc = br.bits(8)
    br.bits(8)
    br.bits(8)
    br.ue()
    chroma_format_idc = 1
    if profile_idc in _HIGH_PROFILES:
        chroma_format_idc = br.ue()
        if chroma_format_idc == 3:
            br.bits(1)
        br.ue()
        br.ue()
        br.bits(1)
        if br.bits(1):
            for i in range(8 if chroma_format_idc != 3 else 12):
                if br.bits(1):
                    _skip_scaling_list(br, 16 if i < 6 else 64)
    br.ue()
    poc_type = br.ue()
    if poc_type == 0:
        br.ue()
    elif poc_type == 1:
        br.bits(1)
        br.se()
        br.se()
        for _ in range(br.ue()):
            br.se()
    br.ue()
    br.bits(1)
    pw = br.ue()
    ph = br.ue()
    frame_mbs_only = br.bits(1)
    if not frame_mbs_only:
        br.bits(1)
    br.bits(1)
    crop_l = crop_r = crop_t = crop_b = 0
    if br.bits(1):
        crop_l, crop_r, crop_t, crop_b = br.ue(), br.ue(), br.ue(), br.ue()
    if br.overrun:
        raise ValueError("SPS parse overrun")
    sub_w, sub_h = {0: (1, 1), 1: (2, 2), 2: (2, 1), 3: (1, 1)}[chroma_format_idc]
    unit_x = 1 if chroma_format_idc == 0 else sub_w
    unit_y = (1 if chroma_format_idc == 0 else sub_h) * (2 - frame_mbs_only)
    width = (pw + 1) * 16 - (crop_l + crop_r) * unit_x
    height = (2 - frame_mbs_only) * (ph + 1) * 16 - (crop_t + crop_b) * unit_y
    return width, height


# ISO 14496-3 samplingFrequencyIndex table — the single copy; ADTS and
# ASC writers index the first 13 entries, readers the padded 16
AAC_SAMPLE_RATES = [96000, 88200, 64000, 48000, 44100, 32000, 24000, 22050,
                    16000, 12000, 11025, 8000, 7350]
_AAC_RATES = AAC_SAMPLE_RATES + [0, 0, 0]
_GA_AOTS = {1, 2, 3, 4, 6, 7, 17, 19, 20, 21, 22, 23}


def _aac_parse_asc_py(data: bytes) -> Tuple[int, int, int]:
    br = ExpGolomb(data)
    aot = br.bits(5)
    if aot == 31:
        aot = 32 + br.bits(6)
    freq_index = br.bits(4)
    rate = br.bits(24) if freq_index == 15 else _AAC_RATES[freq_index]
    chan_config = br.bits(4)
    if aot in (5, 29):  # explicit SBR/PS
        ext = br.bits(4)
        rate = br.bits(24) if ext == 15 else _AAC_RATES[ext]
        aot = br.bits(5)
        if aot == 31:
            aot = 32 + br.bits(6)
    frame_len = 1024
    if aot in _GA_AOTS and br.bits(1):
        frame_len = 960
    if br.overrun:
        raise ValueError("ASC parse overrun")
    channels = 8 if chan_config == 7 else chan_config
    return channels, rate, frame_len


# --- public API -----------------------------------------------------------

def h264_sps_frame_size(sps: bytes) -> Tuple[int, int]:
    """Coded frame (width, height) from an SPS NAL payload."""
    lib = _load_native()
    if lib is not None:
        w = ctypes.c_int32()
        h = ctypes.c_int32()
        if lib.h264_sps_frame_size(sps, len(sps), ctypes.byref(w),
                                   ctypes.byref(h)) == 0:
            return int(w.value), int(h.value)
        raise ValueError("SPS parse failed")
    return _h264_sps_frame_size_py(sps)


def aac_parse_asc(asc: bytes) -> Tuple[int, int, int]:
    """(channels, sample_rate, samples_per_frame) from an ASC."""
    lib = _load_native()
    if lib is not None:
        c = ctypes.c_int32()
        r = ctypes.c_int32()
        s = ctypes.c_int32()
        if lib.aac_parse_asc(asc, len(asc), ctypes.byref(c), ctypes.byref(r),
                             ctypes.byref(s)) == 0:
            return int(c.value), int(r.value), int(s.value)
        raise ValueError("ASC parse failed")
    return _aac_parse_asc_py(asc)


_ASC_RATES = AAC_SAMPLE_RATES


def make_asc(sample_rate: int, channels: int, *,
             object_type: int = 2) -> bytes:
    """Build a 2-byte AudioSpecificConfig (AAC-LC default) — the inverse of
    :func:`aac_parse_asc`, used for the encoder's ``side["config"]``
    (reference: libfdk_aac supplies extradata, enc.audio.ffmpeg.swift)."""
    idx = _ASC_RATES.index(sample_rate)
    # ISO 14496-3 channel_configuration: 1-6 map directly, 8 channels
    # (7.1) is config 7 — packing a raw 8 would write a reserved value
    # that standard decoders reject (aac_parse_asc decodes 7 -> 8)
    chan_config = 7 if channels == 8 else channels
    if not 1 <= chan_config <= 7:
        raise ValueError(f"unsupported AAC channel count {channels}")
    v = (object_type << 11) | (idx << 7) | (chan_config << 3)
    return v.to_bytes(2, "big")


def h265_sps_frame_size(sps: bytes) -> Tuple[int, int]:
    """(width, height) from an HEVC SPS NAL (H.265 §7.3.2.2.1), cropping
    the conformance window.  Beyond-parity: the reference's shim parses
    only H.264 SPS (shim.cpp:187-271); this extends basicMediaDescription
    to the hevc streams the codec layer already transports.  Accepts the
    NAL with or without its 2-byte header: a header is assumed only when
    the first two bytes match a real SPS NAL header (forbidden bit 0,
    type 33, nuh_layer_id 0, temporal_id_plus1 >= 1), and a raw payload
    that happens to mimic one (first byte 0x42: vps_id=4 + one sub-layer)
    is recovered by re-parsing without the header on failure."""
    looks_hdr = (len(sps) >= 2 and ((sps[0] >> 1) & 0x3F) == 33
                 and not (sps[0] & 0x81) and (sps[1] >> 3) == 0
                 and (sps[1] & 0x7) >= 1)
    if not looks_hdr:
        return _h265_sps_size(sps)
    try:
        return _h265_sps_size(sps[2:])
    except ValueError:
        return _h265_sps_size(sps)


def _h265_sps_size(sps: bytes) -> Tuple[int, int]:
    br = ExpGolomb(sps, strip_epb=True)
    br.bits(4)                              # sps_video_parameter_set_id
    max_sub = br.bits(3)                    # sps_max_sub_layers_minus1
    br.bits(1)                              # temporal_id_nesting
    # profile_tier_level(1, max_sub)
    br.bits(8)                              # space(2) tier(1) profile_idc(5)
    br.bits(32)                             # compatibility flags
    br.bits(32)                             # 4 source flags + 43 reserved
    br.bits(16)                             #   + inbld = 48 bits total
    br.bits(8)                              # general_level_idc
    pres = [(br.bits(1), br.bits(1)) for _ in range(max_sub)]
    if max_sub > 0:
        for _ in range(max_sub, 8):
            br.bits(2)                      # reserved_zero_2bits
    for pp, lp in pres:
        if pp:
            br.bits(88)                     # sub-layer profile block
        if lp:
            br.bits(8)                      # sub_layer_level_idc
    br.ue()                                 # sps_seq_parameter_set_id
    chroma_format_idc = br.ue()
    separate_planes = 0
    if chroma_format_idc == 3:
        separate_planes = br.bits(1)
    w = br.ue()                             # pic_width_in_luma_samples
    h = br.ue()
    crop_l = crop_r = crop_t = crop_b = 0
    if br.bits(1):                          # conformance_window_flag
        crop_l, crop_r, crop_t, crop_b = br.ue(), br.ue(), br.ue(), br.ue()
    if br.overrun:
        raise ValueError("HEVC SPS parse overrun")
    sub_w = 2 if chroma_format_idc in (1, 2) and not separate_planes else 1
    sub_h = 2 if chroma_format_idc == 1 and not separate_planes else 1
    return w - sub_w * (crop_l + crop_r), h - sub_h * (crop_t + crop_b)


def vp8_frame_size(frame: bytes) -> Tuple[int, int]:
    """(width, height) from a VP8 keyframe (RFC 6386 §9.1).

    Layout: 3-byte frame tag (bit 0 = interframe flag), 3-byte start code
    9d 01 2a, then 14-bit little-endian width and height.  Used to fill the
    IVF header when piping raw VP8 packets to ffmpeg (the reference gets
    dimensions from libavcodec instead, dec.video.ffmpeg.swift:144-160).
    """
    if len(frame) < 10:
        raise ValueError("short VP8 frame")
    if frame[0] & 1:
        raise ValueError("not a VP8 keyframe")
    if frame[3:6] != b"\x9d\x01\x2a":
        raise ValueError("bad VP8 start code")
    w = (frame[6] | (frame[7] << 8)) & 0x3FFF
    h = (frame[8] | (frame[9] << 8)) & 0x3FFF
    return w, h


class _BitReader:
    """MSB-first bit reader for the VP9 uncompressed header."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def bit(self) -> int:
        byte = self.data[self.pos >> 3]
        bit = (byte >> (7 - (self.pos & 7))) & 1
        self.pos += 1
        return bit

    def bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v


def vp9_frame_size(frame: bytes) -> Tuple[int, int]:
    """(width, height) from a VP9 keyframe uncompressed header
    (VP9 bitstream spec §6.2)."""
    info = vp9_keyframe_info(frame)
    return info["width"], info["height"]


def vp9_keyframe_info(frame: bytes) -> dict:
    """Full uncompressed-header parse of a VP9 keyframe (spec §6.2):
    profile, bit_depth, subsampling_x/y, full_range, color_space,
    width, height.  Source data for VPCodecConfigurationRecord."""
    br = _BitReader(frame)
    if br.bits(2) != 2:
        raise ValueError("bad VP9 frame marker")
    profile = br.bit() | (br.bit() << 1)
    if profile == 3:
        br.bit()
    if br.bit():                       # show_existing_frame
        raise ValueError("show_existing_frame has no size")
    frame_type = br.bit()
    br.bit()                           # show_frame
    br.bit()                           # error_resilient_mode
    if frame_type != 0:
        raise ValueError("not a VP9 keyframe")
    if br.bits(24) != 0x498342:        # sync code
        raise ValueError("bad VP9 sync code")
    # color config
    bit_depth = 8
    if profile >= 2:
        bit_depth = 12 if br.bit() else 10
    color_space = br.bits(3)
    sub_x = sub_y = 1                  # profiles 0/2 are 4:2:0
    full_range = 1
    if color_space != 7:               # != CS_RGB
        full_range = br.bit()
        if profile in (1, 3):
            sub_x, sub_y = br.bit(), br.bit()
            br.bit()                   # reserved
    else:
        if profile in (1, 3):
            br.bit()                   # reserved
            sub_x = sub_y = 0          # CS_RGB implies 4:4:4
    w = br.bits(16) + 1
    h = br.bits(16) + 1
    return {"profile": profile, "bit_depth": bit_depth,
            "subsampling_x": sub_x, "subsampling_y": sub_y,
            "full_range": full_range, "color_space": color_space,
            "width": w, "height": h}


def leb128(data: bytes, pos: int) -> Tuple[int, int]:
    """AV1 leb128 (spec §4.10.5) -> (value, new_pos)."""
    value = 0
    for i in range(8):
        if pos >= len(data):
            raise ValueError("truncated leb128")
        b = data[pos]
        pos += 1
        value |= (b & 0x7F) << (7 * i)
        if not (b & 0x80):
            return value, pos
    raise ValueError("leb128 too long")


def av1_obus(frame: bytes):
    """Iterate (obu_type, payload) over an AV1 temporal unit (low-overhead
    bitstream format, obu_has_size_field expected)."""
    pos = 0
    while pos < len(frame):
        hdr = frame[pos]
        if hdr & 0x80:
            raise ValueError("forbidden bit set in OBU header")
        obu_type = (hdr >> 3) & 0x0F
        has_ext = hdr & 0x04
        has_size = hdr & 0x02
        pos += 1
        if has_ext:
            pos += 1
        if not has_size:
            yield obu_type, frame[pos:]
            return
        size, pos = leb128(frame, pos)
        if pos + size > len(frame):
            raise ValueError("truncated OBU")
        yield obu_type, frame[pos:pos + size]
        pos += size


def av1_frame_size(frame: bytes) -> Tuple[int, int]:
    """(width, height) from the sequence header OBU of an AV1 temporal
    unit (AV1 spec §5.5.1-5.5.2).  Raises on streams whose sequence
    header carries timing info (uvlc-coded tick counts — not emitted by
    realtime encoders)."""
    info = av1_seq_header_info(frame)
    return info["width"], info["height"]


def av1_seq_header_info(frame: bytes) -> dict:
    """Parse the sequence header OBU of an AV1 temporal unit: profile,
    level (seq_level_idx[0]), tier, width, height.  Source data for
    AV1CodecConfigurationRecord."""
    for obu_type, payload in av1_obus(frame):
        if obu_type != 1:                  # OBU_SEQUENCE_HEADER
            continue
        try:
            return _av1_seq_header_parse(payload)
        except IndexError as e:
            raise ValueError("truncated sequence header") from e
    raise ValueError("no AV1 sequence header OBU")


def _av1_seq_header_parse(payload: bytes) -> dict:
    br = _BitReader(payload)
    profile = br.bits(3)               # seq_profile
    br.bit()                           # still_picture
    reduced = br.bit()                 # reduced_still_picture_header
    level = tier = 0
    if reduced:
        level = br.bits(5)             # seq_level_idx[0]
    else:
        if br.bit():                   # timing_info_present_flag
            raise ValueError("timing info in sequence header "
                             "unsupported")
        decoder_model = 0              # absent without timing info
        initial_delay = br.bit()       # initial_display_delay_present
        n_ops = br.bits(5) + 1         # operating_points_cnt
        for i in range(n_ops):
            br.bits(12)                # operating_point_idc
            lv = br.bits(5)            # seq_level_idx
            ti = br.bit() if lv > 7 else 0   # seq_tier
            if i == 0:
                level, tier = lv, ti
            if decoder_model:
                raise ValueError("decoder model unsupported")
            if initial_delay and br.bit():
                br.bits(4)             # initial_display_delay_minus_1
    wbits = br.bits(4) + 1
    hbits = br.bits(4) + 1
    return {"profile": profile, "level": level, "tier": tier,
            "reduced": reduced,
            "width": br.bits(wbits) + 1, "height": br.bits(hbits) + 1}


def av1_is_keyframe(frame: bytes) -> bool:
    """True when the temporal unit starts at a keyframe.  frame_type
    sits ahead of every sequence-dependent field in the frame header
    (spec §5.9.2: show_existing_frame f(1), frame_type f(2)), so it is
    readable without sequence context; reduced_still_picture_header
    streams omit those bits and are keyframes by definition.  Falls back
    to sequence-header presence when the TU carries no frame OBU.  (A
    bare presence check misflags streams that repeat the sequence header
    on every TU — repeat-headers / error-resilient encoder configs.)"""
    saw_seq = False
    try:
        for obu_type, payload in av1_obus(frame):
            if obu_type == 1 and payload:       # OBU_SEQUENCE_HEADER
                if (payload[0] >> 3) & 1:       # reduced_still_picture
                    return True                 # single-KEY-frame stream
                saw_seq = True
            elif obu_type in (3, 6) and payload:  # FRAME_HEADER / FRAME
                if payload[0] & 0x80:           # show_existing_frame
                    return False
                return ((payload[0] >> 5) & 0x3) == 0   # KEY_FRAME
    except ValueError:
        return saw_seq
    return saw_seq


#: MediaFormat-name -> keyframe size parser for the IVF codec family —
#: the single dispatch map shared by the CLI writer, the video decoder,
#: and basic_media_description.
IVF_FRAME_SIZE = {"vp8": vp8_frame_size, "vp9": vp9_frame_size,
                  "av1": av1_frame_size}


def generate_random_bytes(n: int) -> bytes:
    lib = _load_native()
    if lib is not None:
        buf = ctypes.create_string_buffer(n)
        lib.sv_generate_random_bytes(buf, n)
        return buf.raw
    return os.urandom(n)


def test_golomb_dec() -> int:
    """Self-test: fold a canned Exp-Golomb sequence; expected 254."""
    lib = _load_native()
    if lib is not None:
        return int(lib.test_golomb_dec())
    buf = bytes([0b00011000, 0b00000011, 0b11000101, 0b10100000])
    br = ExpGolomb(buf)
    return br.ue() + br.ue() + br.ue() + br.se()
