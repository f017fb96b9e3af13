"""AMF0 codec.

Reference semantics: ``Sources/SwiftVideo/rtmp/amf.swift``
(Atom sum type :105-188 serializers, :190-313 parsers).  Implements the
AMF0 types RTMP command messages use: number, boolean, string / long
string, object, null/undefined, ECMA (assoc) array, strict array, date.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Tuple

# Atom model: Python natives map directly —
#   float -> number, bool -> boolean, str -> string/long string,
#   dict -> object (or ECMA array when serialized with assoc=True),
#   None -> null, list -> strict array
# A tiny wrapper marks ECMA arrays explicitly.


class EcmaArray(dict):
    """dict serialized as an AMF0 ECMA array (marker 0x08)."""


_NUMBER, _BOOL, _STRING, _OBJECT = 0x00, 0x01, 0x02, 0x03
_NULL, _UNDEFINED = 0x05, 0x06
_ECMA, _OBJECT_END, _STRICT, _DATE, _LONG_STRING = 0x08, 0x09, 0x0A, 0x0B, 0x0C


class AmfError(Exception):
    pass


def serialize_one(value: Any) -> bytes:
    if isinstance(value, bool):
        return bytes([_BOOL, 1 if value else 0])
    if isinstance(value, (int, float)):
        return bytes([_NUMBER]) + struct.pack(">d", float(value))
    if isinstance(value, str):
        raw = value.encode("utf-8")
        if len(raw) > 0xFFFF:
            return bytes([_LONG_STRING]) + struct.pack(">I", len(raw)) + raw
        return bytes([_STRING]) + struct.pack(">H", len(raw)) + raw
    if value is None:
        return bytes([_NULL])
    if isinstance(value, EcmaArray):
        out = [bytes([_ECMA]), struct.pack(">I", len(value))]
        for k, v in value.items():
            out.append(struct.pack(">H", len(k.encode())) + k.encode())
            out.append(serialize_one(v))
        out.append(b"\x00\x00" + bytes([_OBJECT_END]))
        return b"".join(out)
    if isinstance(value, dict):
        out = [bytes([_OBJECT])]
        for k, v in value.items():
            out.append(struct.pack(">H", len(k.encode())) + k.encode())
            out.append(serialize_one(v))
        out.append(b"\x00\x00" + bytes([_OBJECT_END]))
        return b"".join(out)
    if isinstance(value, (list, tuple)):
        out = [bytes([_STRICT]), struct.pack(">I", len(value))]
        out.extend(serialize_one(v) for v in value)
        return b"".join(out)
    raise AmfError(f"unserializable {type(value)}")


def serialize(values: List[Any]) -> bytes:
    return b"".join(serialize_one(v) for v in values)


def _unpack(fmt: str, data: bytes, pos: int):
    """Bounds-checked ``struct.unpack_from`` — hostile/truncated input
    must surface as AmfError, never struct.error."""
    try:
        return struct.unpack_from(fmt, data, pos)
    except struct.error as exc:
        raise AmfError(f"truncated value at {pos}") from exc


def _read_string(data: bytes, pos: int) -> Tuple[str, int]:
    if pos + 2 > len(data):
        raise AmfError("truncated string")
    n = struct.unpack_from(">H", data, pos)[0]
    pos += 2
    if pos + n > len(data):
        raise AmfError("truncated string body")
    return data[pos:pos + n].decode("utf-8", "replace"), pos + n


def parse_one(data: bytes, pos: int = 0, *,
              _depth: int = 0) -> Tuple[Any, int]:
    if _depth > 32:
        # hostile nesting must surface as AmfError, not RecursionError
        # (which would escape the session handlers and kill the task)
        raise AmfError("nesting too deep")
    if pos >= len(data):
        raise AmfError("truncated")
    marker = data[pos]
    pos += 1
    if marker == _NUMBER:
        val = _unpack(">d", data, pos)[0]
        return val, pos + 8
    if marker == _BOOL:
        if pos >= len(data):
            raise AmfError("truncated boolean")
        return bool(data[pos]), pos + 1
    if marker == _STRING:
        return _read_string(data, pos)
    if marker == _LONG_STRING:
        n = _unpack(">I", data, pos)[0]
        pos += 4
        if pos + n > len(data):
            raise AmfError("truncated long string body")
        return data[pos:pos + n].decode("utf-8", "replace"), pos + n
    if marker in (_NULL, _UNDEFINED):
        return None, pos
    if marker in (_OBJECT, _ECMA):
        if marker == _ECMA:
            pos += 4  # declared count; terminated by object-end regardless
        out: Dict[str, Any] = EcmaArray() if marker == _ECMA else {}
        while True:
            key, pos = _read_string(data, pos)
            if key == "" and pos < len(data) and data[pos] == _OBJECT_END:
                return out, pos + 1
            val, pos = parse_one(data, pos, _depth=_depth + 1)
            out[key] = val
    if marker == _STRICT:
        n = _unpack(">I", data, pos)[0]
        pos += 4
        items = []
        for _ in range(n):
            val, pos = parse_one(data, pos, _depth=_depth + 1)
            items.append(val)
        return items, pos
    if marker == _DATE:
        if pos + 10 > len(data):
            raise AmfError("truncated date")
        val = _unpack(">d", data, pos)[0]
        return val, pos + 10  # ms since epoch + 2-byte tz
    raise AmfError(f"unknown marker 0x{marker:02x}")


def parse(data: bytes) -> List[Any]:
    out = []
    pos = 0
    while pos < len(data):
        val, pos = parse_one(data, pos)
        out.append(val)
    return out
