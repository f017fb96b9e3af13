"""RTMP protocol: chunking, AMF0, sessions, facade."""

from . import amf
from .chunks import Chunk, ChunkDeserializer, ChunkSerializer
from .media import MediaSerializer, create_metadata, serialize_media
from .rtmp import LiveOnConnection, LiveOnEnded, Rtmp, RtmpPublisher, RtmpSubscriber
from .session import Context, RtmpSessionCore, parse_rtmp_url

__all__ = [
    "amf", "Chunk", "ChunkSerializer", "ChunkDeserializer",
    "MediaSerializer", "serialize_media", "create_metadata",
    "Rtmp", "RtmpPublisher", "RtmpSubscriber",
    "LiveOnConnection", "LiveOnEnded",
    "RtmpSessionCore", "Context", "parse_rtmp_url",
]
