"""Binary wire codec for CodedMediaSample and MediaConstituent.

Same field inventory as the reference's protobuf wire
(``/root/reference/Proto/CodedMediaSample.proto:66-90``) in a simple
length-prefixed little-endian layout (no protoc dependency):

    u32 magic 'SVW1' | field records: u8 tag, u32 len, payload

TimePoints serialize as two i64 (value, scale).
"""

from __future__ import annotations

import struct
from typing import Dict

from ..core import TimePoint
from .coded import CodedMediaSample, MediaConstituent, MediaFormat, MediaType

_MAGIC = b"SVW1"

_T_PTS, _T_DTS, _T_TIME, _T_ASSET, _T_WORKSPACE, _T_TOKEN = 1, 2, 3, 4, 5, 6
_T_BUFFER, _T_SIDE, _T_MEDIATYPE, _T_MEDIAFORMAT, _T_ENCODER, _T_CONSTITUENT = 7, 8, 9, 10, 12, 14


def _pack_tp(tp: TimePoint) -> bytes:
    return struct.pack("<qq", tp.value, tp.scale)


def _unpack_tp(data: bytes) -> TimePoint:
    if len(data) != 16:
        raise ValueError("truncated TimePoint record")
    v, s = struct.unpack("<qq", data)
    return TimePoint(v, s)


def _unpack_i32(data: bytes) -> int:
    if len(data) != 4:
        raise ValueError("truncated int32 record")
    return struct.unpack("<i", data)[0]


def _record(tag: int, payload: bytes) -> bytes:
    return struct.pack("<BI", tag, len(payload)) + payload


def _iter_records(data: bytes, offset: int = 0):
    while offset < len(data):
        if offset + 5 > len(data):
            raise ValueError("truncated record header")
        tag, length = struct.unpack_from("<BI", data, offset)
        offset += 5
        if offset + length > len(data):
            # a short read must surface as a parse error, not a silently
            # short payload (the format is self-describing by contract)
            raise ValueError("truncated record payload")
        yield tag, data[offset:offset + length]
        offset += length


def pack_constituent(c: MediaConstituent) -> bytes:
    out = [_record(1, c.id_asset.encode()), _record(3, _pack_tp(c.pts))]
    if c.dts is not None:
        out.append(_record(4, _pack_tp(c.dts)))
    if c.duration is not None:
        out.append(_record(5, _pack_tp(c.duration)))
    if c.normalized_pts is not None:
        out.append(_record(6, _pack_tp(c.normalized_pts)))
    for sub in c.constituents:
        out.append(_record(7, pack_constituent(sub)))
    return b"".join(out)


def unpack_constituent(data: bytes, _depth: int = 0) -> MediaConstituent:
    if _depth > 32:
        raise ValueError("constituent nesting too deep")
    kwargs = dict(id_asset="", pts=TimePoint(0, 1000))
    subs = []
    for tag, payload in _iter_records(data):
        if tag == 1:
            kwargs["id_asset"] = payload.decode()
        elif tag == 3:
            kwargs["pts"] = _unpack_tp(payload)
        elif tag == 4:
            kwargs["dts"] = _unpack_tp(payload)
        elif tag == 5:
            kwargs["duration"] = _unpack_tp(payload)
        elif tag == 6:
            kwargs["normalized_pts"] = _unpack_tp(payload)
        elif tag == 7:
            subs.append(unpack_constituent(payload, _depth + 1))
    return MediaConstituent(constituents=tuple(subs), **kwargs)


def serialize(sample: CodedMediaSample) -> bytes:
    out = [_MAGIC,
           _record(_T_PTS, _pack_tp(sample.pts())),
           _record(_T_DTS, _pack_tp(sample.dts())),
           _record(_T_TIME, _pack_tp(sample.time())),
           _record(_T_ASSET, sample.asset_id().encode()),
           _record(_T_WORKSPACE, sample.workspace_id().encode()),
           _record(_T_BUFFER, sample.data()),
           _record(_T_MEDIATYPE, struct.pack("<i", int(sample.media_type))),
           _record(_T_MEDIAFORMAT, struct.pack("<i", int(sample.media_format)))]
    if sample.token_workspace:
        out.append(_record(_T_TOKEN, sample.token_workspace.encode()))
    if sample.encoder:
        out.append(_record(_T_ENCODER, sample.encoder.encode()))
    for key, val in sample.side_data().items():
        out.append(_record(_T_SIDE, _record(1, key.encode()) + _record(2, val)))
    for c in sample.constituents():
        out.append(_record(_T_CONSTITUENT, pack_constituent(c)))
    return b"".join(out)


def deserialize(data: bytes) -> CodedMediaSample:
    if data[:4] != _MAGIC:
        raise ValueError("bad magic")
    kwargs = dict(buffer=b"", pts_value=TimePoint(0, 1000),
                  dts_value=TimePoint(0, 1000),
                  media_type=MediaType.video, media_format=MediaFormat.avc)
    side: Dict[str, bytes] = {}
    constituents = []
    extra = {}
    seen = set()
    for tag, payload in _iter_records(data, 4):
        seen.add(tag)
        if tag == _T_PTS:
            kwargs["pts_value"] = _unpack_tp(payload)
        elif tag == _T_DTS:
            kwargs["dts_value"] = _unpack_tp(payload)
        elif tag == _T_TIME:
            extra["time_point"] = _unpack_tp(payload)
        elif tag == _T_ASSET:
            extra["id_asset"] = payload.decode()
        elif tag == _T_WORKSPACE:
            extra["id_workspace"] = payload.decode()
        elif tag == _T_TOKEN:
            extra["token_workspace"] = payload.decode()
        elif tag == _T_BUFFER:
            kwargs["buffer"] = payload
        elif tag == _T_MEDIATYPE:
            kwargs["media_type"] = MediaType(_unpack_i32(payload))
        elif tag == _T_MEDIAFORMAT:
            kwargs["media_format"] = MediaFormat(_unpack_i32(payload))
        elif tag == _T_ENCODER:
            extra["encoder"] = payload.decode()
        elif tag == _T_SIDE:
            recs = dict(_iter_records(payload))
            if 1 not in recs or 2 not in recs:
                raise ValueError("malformed side-data record")
            side[recs[1].decode()] = recs[2]
        elif tag == _T_CONSTITUENT:
            constituents.append(unpack_constituent(payload))
    missing = {_T_PTS, _T_MEDIATYPE, _T_MEDIAFORMAT} - seen
    if missing:
        # required fields must be present, not silently defaulted (a
        # truncated stream otherwise yields a wrong-codec sample)
        raise ValueError(f"missing required records {sorted(missing)}")
    return CodedMediaSample(side=side, constituents_value=tuple(constituents),
                            **kwargs, **extra)
