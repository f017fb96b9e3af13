"""RTMP media framing: FLV tags + onMetaData.

Reference semantics: ``serializeMedia`` / ``createMetadata``
(serialize.swift:24-90) and the config-resend / first-keyframe gating of
``rtmp.Serialize`` (rtmp.swift:562-609).

Beyond the reference (which frames avc/aac only): non-avc video (hevc,
vp9, av1) and non-aac audio (opus) travel as Enhanced RTMP ex-headers —
the isExHeader bit plus a codec fourCC per the E-RTMP v1/v2 spec
(PacketTypeSequenceStart for config, PacketTypeCodedFrames for media,
24-bit composition time present only for hvc1).  Formats with no RTMP
representation (vp8) serialize to nothing rather than mislabeling the
codec id.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ...core import rescale
from ...media.coded import (BasicAudioDescription, BasicVideoDescription,
                            CodedMediaSample, MediaFormat, MediaType,
                            is_keyframe)
from . import amf
from .chunks import Chunk, ChunkSerializer

VIDEO_FOURCC = {MediaFormat.hevc: b"hvc1", MediaFormat.vp9: b"vp09",
                MediaFormat.av1: b"av01"}
AUDIO_FOURCC = {MediaFormat.opus: b"Opus"}
FOURCC_VIDEO = {v: k for k, v in VIDEO_FOURCC.items()}
FOURCC_AUDIO = {v: k for k, v in AUDIO_FOURCC.items()}


def serialize_media(sample: CodedMediaSample, serializer: ChunkSerializer,
                    msg_stream_id: int, prev_dts: Dict[int, int],
                    send_config: bool = False) -> bytes:
    """One media message as chunk bytes (serialize.swift:24-55)."""
    if sample.media_type not in (MediaType.video, MediaType.audio):
        return b""
    pts = rescale(sample.pts(), 1000).value
    dts = rescale(sample.dts(), 1000).value
    cts = pts - dts
    is_video = sample.media_type == MediaType.video
    csid = 0x6 if is_video else 0x4
    if is_video:
        frame_type = 0x10 if is_keyframe(sample) else 0x20
        if sample.media_format == MediaFormat.avc:
            header = bytes([0x7 | frame_type, 0 if send_config else 1,
                            (cts >> 16) & 0xFF, (cts >> 8) & 0xFF, cts & 0xFF])
        else:
            fourcc = VIDEO_FOURCC.get(sample.media_format)
            if fourcc is None:
                return b""          # no RTMP representation (e.g. vp8)
            ptype = 0 if send_config else 1   # SequenceStart / CodedFrames
            header = bytes([0x80 | frame_type | ptype]) + fourcc
            if not send_config and sample.media_format == MediaFormat.hevc:
                # SI24 composition time is defined only for hvc1
                header += bytes([(cts >> 16) & 0xFF, (cts >> 8) & 0xFF,
                                 cts & 0xFF])
    else:
        if sample.media_format == MediaFormat.aac:
            header = bytes([0xAF, 0 if send_config else 1])
        else:
            fourcc = AUDIO_FOURCC.get(sample.media_format)
            if fourcc is None:
                return b""
            # E-RTMP v2 audio: soundFormat 9 = ExHeader, low nibble packet
            # type (0 SequenceStart / 1 CodedFrames)
            header = bytes([0x90 | (0 if send_config else 1)]) + fourcc
    payload = sample.side_data().get("config", b"") if send_config \
        else sample.data()
    body = header + payload
    last = prev_dts.get(csid)
    delta = dts - last if last is not None else 0
    prev_dts[csid] = dts
    chunk = Chunk(msg_stream_id=msg_stream_id, msg_length=len(body),
                  msg_type=0x9 if is_video else 0x8, chunk_stream_id=csid,
                  timestamp=dts, timestamp_delta=delta, data=body)
    return serializer.serialize(chunk)


_VIDEO_CODEC_ID = {MediaFormat.avc: "avc1", MediaFormat.hevc: "hvc1",
                   MediaFormat.vp9: "vp09", MediaFormat.av1: "av01"}
_AUDIO_CODEC_ID = {MediaFormat.aac: "mp4a", MediaFormat.opus: "Opus"}


def create_metadata(descriptions: List, serializer: ChunkSerializer,
                    msg_stream_id: int,
                    video_format: Optional[MediaFormat] = None,
                    audio_format: Optional[MediaFormat] = None) -> bytes:
    """@setDataFrame onMetaData (serialize.swift:57-90)."""
    props: Dict[str, object] = {"encoder": "swiftvideo-tpu 0.1",
                                "duration": 0.0, "filesize": 0.0}
    for desc in descriptions:
        if isinstance(desc, BasicVideoDescription):
            props.update({"width": float(desc.size[0]),
                          "height": float(desc.size[1]),
                          "videodatarate": 1000.0, "framerate": 30.0,
                          "videocodecid": _VIDEO_CODEC_ID.get(
                              video_format, "avc1")})
        elif isinstance(desc, BasicAudioDescription):
            props.update({"audiodatarate": 96.0,
                          "audiosamplerate": float(desc.sample_rate),
                          "audiosamplesize": 16.0,
                          "audiochannels": float(desc.channel_count),
                          "stereo": 1.0 if desc.channel_count > 1 else 0.0,
                          "audiocodecid": _AUDIO_CODEC_ID.get(
                              audio_format, "mp4a")})
    payload = amf.serialize(["@setDataFrame", "onMetaData",
                             amf.EcmaArray(props)])
    chunk = Chunk(msg_stream_id=msg_stream_id, msg_length=len(payload),
                  msg_type=0x12, chunk_stream_id=0x6, timestamp=0,
                  timestamp_delta=0, data=payload)
    return serializer.serialize(chunk)


class MediaSerializer:
    """Config-resend + first-keyframe gating (rtmp.swift:562-609): media
    before a video keyframe (when a config exists and wasn't sent) is
    dropped; config packets precede the first data packet and are resent on
    config change."""

    def __init__(self, serializer: ChunkSerializer, msg_stream_id: int):
        self.serializer = serializer
        self.msg_stream_id = msg_stream_id
        self._prev_config: Dict[MediaType, bytes] = {}
        self._sent_first_keyframe = False
        self._prev_dts: Dict[int, int] = {}

    def serialize(self, sample: CodedMediaSample) -> Optional[bytes]:
        """Returns chunk bytes, or None when the sample is gated out or
        has no RTMP representation (e.g. vp8)."""
        cur = sample.side_data().get("config")
        prev = self._prev_config.get(sample.media_type)
        if cur is not None and prev == cur:
            return serialize_media(sample, self.serializer,
                                   self.msg_stream_id,
                                   self._prev_dts) or None
        if cur is not None:
            is_video = sample.media_type == MediaType.video
            if not is_video or self._sent_first_keyframe or is_keyframe(sample):
                head = serialize_media(sample, self.serializer,
                                       self.msg_stream_id, self._prev_dts,
                                       send_config=True)
                body = serialize_media(sample, self.serializer,
                                       self.msg_stream_id, self._prev_dts)
                if not head and not body:
                    # unrepresentable format: nothing reached the wire, so
                    # the first-keyframe gate stays shut and the config
                    # stays unsent
                    return None
                if is_video:
                    self._sent_first_keyframe = True
                self._prev_config[sample.media_type] = cur
                return head + body
            return None
        return serialize_media(sample, self.serializer, self.msg_stream_id,
                               self._prev_dts) or None
