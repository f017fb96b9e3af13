"""CodedMediaSample: compressed media over a compact wire format.

Reference semantics: ``/root/reference/Sources/SwiftVideo/sample.coded.swift``
and ``/root/reference/Proto/CodedMediaSample.proto:21-90``.

The wire layer here is a self-describing binary codec (media.wire) rather
than protobuf — same field inventory (pts/dts/event time, asset ids, buffer,
side-data map, media type/format, encoder tag, constituent provenance tree),
chosen to avoid a protoc build dependency.  ``MediaConstituent`` trees track
which source samples (and at which normalized pts) contributed to a derived
sample — the provenance primitive the mixers and transcoders maintain.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from enum import IntEnum
from typing import Dict, Optional, Tuple

from ..core import EventBox, EventInfo, TimePoint, Tx


class MediaType(IntEnum):
    video = 0
    audio = 1
    image = 2
    data = 3
    subtitle = 4


class MediaFormat(IntEnum):
    avc = 0
    hevc = 1
    aac = 2
    opus = 3
    av1 = 4
    vp8 = 5
    vp9 = 6
    uncompressed = 7
    png = 8
    apng = 9
    jpg = 10
    gif = 11
    klv = 12
    srt = 13
    webvtt = 14
    utf8Text = 15


class MediaSourceType(IntEnum):
    rtmp = 0
    webrtc = 1
    httpPut = 2
    protobuf = 3
    httpGet = 4
    transcode = 5
    composition = 6
    web = 7
    output = 8
    flavor = 9
    file = 10
    text = 11


@dataclass(frozen=True)
class MediaConstituent:
    """Provenance record (CodedMediaSample.proto:83-90)."""

    id_asset: str
    pts: TimePoint
    dts: Optional[TimePoint] = None
    duration: Optional[TimePoint] = None
    normalized_pts: Optional[TimePoint] = None
    constituents: Tuple["MediaConstituent", ...] = ()


@dataclass(frozen=True)
class CodedMediaSample:
    """Compressed sample (sample.coded.swift:87-195)."""

    buffer: bytes
    pts_value: TimePoint
    dts_value: TimePoint
    media_type: MediaType
    media_format: MediaFormat
    id_asset: str = ""
    id_workspace: str = ""
    token_workspace: Optional[str] = None
    time_point: TimePoint = field(default_factory=lambda: TimePoint(0, 100000))
    side: Dict[str, bytes] = field(default_factory=dict)
    encoder: str = ""
    constituents_value: Tuple[MediaConstituent, ...] = ()
    event_info: Optional[EventInfo] = None

    # --- Event protocol --------------------------------------------------
    def type(self) -> str:
        return {MediaType.video: "vide", MediaType.audio: "soun"}.get(
            self.media_type, "data")

    def time(self) -> TimePoint:
        return self.time_point

    def asset_id(self) -> str:
        return self.id_asset

    def workspace_id(self) -> str:
        return self.id_workspace

    def info(self) -> Optional[EventInfo]:
        return self.event_info

    # --- accessors -------------------------------------------------------
    def pts(self) -> TimePoint:
        return self.pts_value

    def dts(self) -> TimePoint:
        return self.dts_value

    def data(self) -> bytes:
        return self.buffer

    def workspace_token(self) -> Optional[str]:
        return self.token_workspace

    def side_data(self) -> Dict[str, bytes]:
        return self.side

    def constituents(self) -> Tuple[MediaConstituent, ...]:
        return self.constituents_value

    def with_(self, **kwargs) -> "CodedMediaSample":
        mapping = {"pts": "pts_value", "dts": "dts_value", "time": "time_point",
                   "asset_id": "id_asset", "constituents": "constituents_value"}
        return replace(self, **{mapping.get(k, k): v for k, v in kwargs.items()})


# --- descriptions (sample.coded.swift:202-230) ----------------------------

@dataclass(frozen=True)
class BasicVideoDescription:
    size: Tuple[int, int]


@dataclass(frozen=True)
class BasicAudioDescription:
    sample_rate: float
    channel_count: int
    samples_per_packet: int


class MediaDescriptionError(Exception):
    pass


def sps_from_avcdcr(sample: CodedMediaSample) -> bytes:
    """Extract the first SPS NAL from an AVCDecoderConfigurationRecord
    (sample.coded.swift:254-264)."""
    record = sample.side_data().get("config")
    if record is None or len(record) <= 8:
        raise MediaDescriptionError("invalid metadata")
    size = (record[6] << 8) | record[7]
    if len(record) <= 8 + size:
        raise MediaDescriptionError("invalid metadata")
    return bytes(record[8:8 + size])


def basic_media_description(sample: CodedMediaSample):
    """Parse stream parameters from codec config (sample.coded.swift:202-230).
    Every format this describes (avc, hevc, vp8, vp9, av1, aac, opus) reads
    its parameters with the codec layer's bitstream helpers, which are not
    yet ported: those formats raise "not yet ported"."""
    if sample.media_format in (MediaFormat.avc, MediaFormat.hevc,
                               MediaFormat.vp8, MediaFormat.vp9,
                               MediaFormat.av1, MediaFormat.aac,
                               MediaFormat.opus):
        raise MediaDescriptionError(
            f"{sample.media_format.name}: stream description needs the codec "
            "layer's bitstream module, which is not yet ported")
    raise MediaDescriptionError("unsupported")


def is_keyframe(sample: CodedMediaSample) -> bool:
    """sample.coded.swift:232-252 — AVC NAL-type-5 check in AVCC framing.
    Extended beyond the reference (which returns false for every other
    format) to the formats the codec layer transports: hevc IRAP NALs in
    length-prefixed framing, the vp8 frame-tag interframe bit, and the
    vp9 uncompressed-header frame type."""
    if sample.media_type != MediaType.video:
        return True
    data = sample.data()
    if sample.media_format == MediaFormat.avc:
        # walk 4-byte-length-prefixed NALs to the first VCL one (types
        # 1-5): an IDR access unit may be led by SEI/AUD NALs, which the
        # reference's first-NAL-only check (sample.coded.swift:251)
        # misclassifies as inter — gating out the whole first GOP
        pos = 0
        while pos + 5 <= len(data):
            n = int.from_bytes(data[pos:pos + 4], "big")
            nal_type = data[pos + 4] & 0x1F
            if 1 <= nal_type <= 5:         # VCL
                return nal_type == 5
            pos += 4 + n
        return False
    if sample.media_format == MediaFormat.hevc:
        # walk 4-byte-length-prefixed NALs to the first VCL one; keyframe
        # iff it is an IRAP type (BLA 16-18, IDR 19-20, CRA 21)
        pos = 0
        while pos + 5 <= len(data):
            n = int.from_bytes(data[pos:pos + 4], "big")
            nal_type = (data[pos + 4] >> 1) & 0x3F
            if nal_type < 32:              # VCL
                return 16 <= nal_type <= 21
            pos += 4 + n
        return False
    if sample.media_format == MediaFormat.av1:
        raise MediaDescriptionError(
            "av1: keyframe detection needs the codec layer's bitstream "
            "module, which is not yet ported")
    if sample.media_format == MediaFormat.vp8:
        return len(data) >= 1 and (data[0] & 1) == 0
    if sample.media_format == MediaFormat.vp9:
        if len(data) < 1:
            return False
        b = data[0]
        if (b >> 6) != 2:                  # frame_marker
            return False
        profile = ((b >> 5) & 1) | (((b >> 4) & 1) << 1)
        bits = [(b >> (3 - i)) & 1 for i in range(4)]
        idx = 0
        if profile == 3:
            idx += 1                       # reserved bit
        if bits[idx]:                      # show_existing_frame
            return False
        return bits[idx + 1] == 0          # frame_type == KEY_FRAME
    return False


# --- stock filters (sample.coded.swift:67-85) -----------------------------

def formats_filter(formats) -> Tx:
    formats = set(formats)
    return Tx(lambda s: EventBox.just(s) if isinstance(s, CodedMediaSample)
              and s.media_format in formats else EventBox.nothing(
                  s.info() if hasattr(s, "info") else None))


def media_type_filter(media_type: MediaType) -> Tx:
    return Tx(lambda s: EventBox.just(s) if isinstance(s, CodedMediaSample)
              and s.media_type == media_type else EventBox.nothing(
                  s.info() if hasattr(s, "info") else None))
