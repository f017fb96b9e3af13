"""RTMP chunk-stream (de)serialization.

Reference semantics: ``Sources/SwiftVideo/rtmp/serialize.swift``
and ``deserialize.swift``:

* header type selection — type 3 for same-length/type/delta repeats, type 1
  on length/type change, type 2 on delta change, type 0 otherwise; forced
  type 0 on rollover, backwards time, msgStreamId change, chunk stream 3,
  or 2 s since the last type 0 (serialize.swift:92-129).
* serial-number timestamp arithmetic (RFC1982-style) so uint32 rollover
  reconstructs monotonically increasing absolute timestamps
  (deserialize.swift:92-101).  Documented deviation: the reference wraps
  at ``% 0xffffffff`` (2^32 - 1), skewing 1 ms per rollover against
  spec-conformant peers; this implementation uses the RTMP u32 space
  modulus 2^32.
* second documented deviation: the 3-byte basic-header form carries
  ``csid - 64`` (spec 5.3.1.1); the reference omits the bias in this form
  only (serialize.swift:137, deserialize.swift:63), colliding chunk
  streams >= 320 with low ids against conformant peers.
* third: a standalone type-3 header's extended field repeats the
  preceding header's DELTA (what FFmpeg's presence heuristic expects),
  not the absolute timestamp.
* extended timestamps (>= 0xFFFFFF) in headers and type-3 continuations.
* payload re-chunking every ``out_chunk_size`` bytes with type-3 headers
  (serialize.swift:149-177).
* incremental parsing with per-chunk-stream partial message assembly
  (deserialize.swift:24-49).
"""

from __future__ import annotations

import ctypes
import os
import struct
import subprocess
import threading
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Tuple

DEFAULT_CHUNK_SIZE = 128

# --- native fast path (csrc/rtmp_chunks.cpp) -------------------------------
# Same pattern as codec/bitstream.py: a ctypes-loaded C++ library with the
# pure-Python implementation below as the behavioral spec and fallback.
# One message per poll so control messages (SetChunkSize) apply between
# polls exactly like the Python path.  Disable with SWIFTVIDEO_RTMP_NATIVE=0.

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))), "csrc")
_LIB_PATH = os.path.join(_CSRC, "libsvrtmp.so")
_lib: Optional[ctypes.CDLL] = None
_lib_tried = False


def _load_native() -> Optional[ctypes.CDLL]:
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    if os.environ.get("SWIFTVIDEO_RTMP_NATIVE", "1") == "0":
        return None
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
            lib.sv_rtmp_dechunk_new.restype = ctypes.c_void_p
            lib.sv_rtmp_dechunk_new.argtypes = [ctypes.c_uint32,
                                                ctypes.c_uint64]
            lib.sv_rtmp_dechunk_free.restype = None
            lib.sv_rtmp_dechunk_free.argtypes = [ctypes.c_void_p]
            lib.sv_rtmp_dechunk_set_chunk_size.restype = None
            lib.sv_rtmp_dechunk_set_chunk_size.argtypes = [
                ctypes.c_void_p, ctypes.c_uint32]
            lib.sv_rtmp_dechunk_append.restype = None
            lib.sv_rtmp_dechunk_append.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64]
            lib.sv_rtmp_dechunk_poll.restype = ctypes.c_int
            lib.sv_rtmp_dechunk_poll.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_void_p),
                ctypes.POINTER(ctypes.c_uint64)]
            lib.sv_rtmp_dechunk_error.restype = ctypes.c_char_p
            lib.sv_rtmp_dechunk_error.argtypes = [ctypes.c_void_p]
            lib.sv_rtmp_dechunk_pending.restype = ctypes.c_uint64
            lib.sv_rtmp_dechunk_pending.argtypes = [ctypes.c_void_p]
            _lib = lib
        except OSError:
            _lib = None
    return _lib


def native_available() -> bool:
    return _load_native() is not None


# Load (and, on a fresh checkout, build) the native library at import time:
# ChunkDeserializer is constructed per-connection inside the asyncio event
# loop (session.py), and a first-construction `make` there would block the
# loop for the duration of a compile.
_load_native()


@dataclass(frozen=True)
class Chunk:
    """One RTMP message in flight (rtmp.swift:860-903)."""

    msg_stream_id: int
    msg_length: int
    msg_type: int
    chunk_stream_id: int
    timestamp: int          # absolute, rollover-extended (ms)
    timestamp_delta: int = 0
    extended: bool = False
    data: bytes = b""

    def changing(self, **kw) -> "Chunk":
        return replace(self, **kw)


def _be24(val: int) -> bytes:
    return bytes([(val >> 16) & 0xFF, (val >> 8) & 0xFF, val & 0xFF])


def _basic_header(csid: int, fmt: int) -> bytes:
    if csid < 64:
        return bytes([(csid & 0x3F) | ((fmt & 0x3) << 6)])
    if csid < 256 + 64:
        return bytes([(fmt & 0x3) << 6, csid - 64])
    # 3-byte form carries csid - 64 (spec §5.3.1.1); documented deviation:
    # the reference omits the bias in this form only (serialize.swift:137,
    # deserialize.swift:63), mis-addressing chunk streams >= 320 against
    # conformant peers
    return bytes([((fmt & 0x3) << 6) | 1]) + struct.pack("<H",
                                                         (csid - 64) & 0xFFFF)


class _OutState:
    """Last-sent header per chunk stream (what type selection needs)."""

    __slots__ = ("msg_stream_id", "msg_length", "msg_type", "timestamp",
                 "timestamp_delta", "extended")


class ChunkSerializer:
    """Stateful writer for one connection direction."""

    def __init__(self, out_chunk_size: int = DEFAULT_CHUNK_SIZE):
        self.out_chunk_size = out_chunk_size
        self._prev: Dict[int, _OutState] = {}
        self._last_chunk0: Dict[int, int] = {}
        # one serializer per connection, but TWO writer threads touch it
        # in production: session.feed command replies on the event-loop
        # thread and publisher media on the clock/producer thread — the
        # per-csid _prev/_last_chunk0 state must not race
        self._lock = threading.RLock()

    def set_chunk_size(self, size: int) -> None:
        with self._lock:
            self.out_chunk_size = size

    # --- header type selection (serialize.swift:92-129) -------------------
    def serialize(self, chunk: Chunk) -> bytes:
        with self._lock:
            return self._serialize_locked(chunk)

    def _serialize_locked(self, chunk: Chunk) -> bytes:
        prev = self._prev.get(chunk.chunk_stream_id)
        serial_cur = chunk.timestamp % 0x100000000
        rollover = False
        if prev is not None:
            serial_prev = prev.timestamp % 0x100000000
            rollover = serial_prev > serial_cur and \
                (serial_prev - serial_cur) > 0x7FFFFFFF
        last0 = self._last_chunk0.get(chunk.chunk_stream_id)
        if (prev is not None and last0 is not None and not rollover
                and chunk.timestamp < last0 + 2000
                and chunk.timestamp > prev.timestamp
                and chunk.timestamp - prev.timestamp < 0x7FFFFFFF
                and prev.msg_stream_id == chunk.msg_stream_id
                and chunk.chunk_stream_id != 3):
            if (chunk.msg_length == prev.msg_length
                    and chunk.msg_type == prev.msg_type
                    and chunk.timestamp_delta == prev.timestamp_delta
                    and chunk.timestamp_delta > 0
                    and chunk.msg_length < self.out_chunk_size):
                return self._chunk3(chunk)
            if (chunk.msg_length != prev.msg_length
                    or chunk.msg_type != prev.msg_type
                    or prev.timestamp_delta == 0):
                return self._chunk1(chunk)
            if prev.timestamp_delta != chunk.timestamp_delta:
                return self._chunk2(chunk)
            return self._chunk0(chunk)
        return self._chunk0(chunk)

    # --- payload re-chunking (serialize.swift:149-177) --------------------
    def _chunk_payload(self, chunk: Chunk, header: bytes, ts_field: int,
                       use_extended: bool) -> bytes:
        cont = _basic_header(chunk.chunk_stream_id, 3)
        if use_extended:
            cont += struct.pack(">I", ts_field)
        out = [header]
        data = chunk.data
        pos = 0
        while True:
            size = min(self.out_chunk_size, len(data) - pos)
            out.append(data[pos:pos + size])
            pos += size
            if pos >= len(data):
                break
            out.append(cont)
        return b"".join(out)

    def _store(self, chunk: Chunk, is0: bool, extended: bool,
               timestamp_delta: Optional[int] = None) -> None:
        st = _OutState()
        st.msg_stream_id = chunk.msg_stream_id
        st.msg_length = chunk.msg_length
        st.msg_type = chunk.msg_type
        st.timestamp = chunk.timestamp
        st.timestamp_delta = (chunk.timestamp_delta if timestamp_delta is None
                              else timestamp_delta)
        st.extended = extended
        self._prev[chunk.chunk_stream_id] = st
        if is0:
            self._last_chunk0[chunk.chunk_stream_id] = chunk.timestamp

    def _ts_parts(self, value: int) -> Tuple[bytes, int, bool]:
        serial = value % 0x100000000
        if serial >= 0xFFFFFF:
            return _be24(0xFFFFFF), serial, True
        return _be24(serial), serial, False

    def _chunk0(self, chunk: Chunk) -> bytes:
        ts3, ts_full, ext = self._ts_parts(chunk.timestamp)
        header = (_basic_header(chunk.chunk_stream_id, 0) + ts3
                  + _be24(chunk.msg_length) + bytes([chunk.msg_type])
                  + struct.pack("<I", chunk.msg_stream_id & 0xFFFFFFFF))
        if ext:
            header += struct.pack(">I", ts_full)
        # store the delta as the receiver now knows it: a type-0 header
        # resets it to 0, so the next message must carry an explicit delta
        # (type 1/2) before type-3 continuation becomes legal
        self._store(chunk, True, ext, timestamp_delta=0)
        return self._chunk_payload(chunk, header, ts_full, ext)

    def _chunk1(self, chunk: Chunk) -> bytes:
        ts3, ts_full, ext = self._ts_parts(chunk.timestamp_delta)
        header = (_basic_header(chunk.chunk_stream_id, 1) + ts3
                  + _be24(chunk.msg_length) + bytes([chunk.msg_type]))
        if ext:
            header += struct.pack(">I", ts_full)
        self._store(chunk, False, ext)
        return self._chunk_payload(chunk, header, ts_full, ext)

    def _chunk2(self, chunk: Chunk) -> bytes:
        ts3, ts_full, ext = self._ts_parts(chunk.timestamp_delta)
        header = _basic_header(chunk.chunk_stream_id, 2) + ts3
        if ext:
            header += struct.pack(">I", ts_full)
        self._store(chunk, False, ext)
        return self._chunk_payload(chunk, header, ts_full, ext)

    def _chunk3(self, chunk: Chunk) -> bytes:
        prev = self._prev[chunk.chunk_stream_id]
        ext = prev.extended
        header = _basic_header(chunk.chunk_stream_id, 3)
        # a standalone type-3 repeats the PRECEDING header, whose extended
        # field carried the delta (type-3 selection requires a prior
        # type-1/2 with the same delta) — peers like FFmpeg sniff those 4
        # bytes against the last extended value to decide the field is
        # present, so the absolute timestamp here would desync them
        ts_full = chunk.timestamp_delta % 0x100000000
        if ext:
            header += struct.pack(">I", ts_full)
        self._store(chunk, False, ext)
        return self._chunk_payload(chunk, header, ts_full, ext)


class _Partial:
    """Mutable per-chunk-stream assembly state (hot path: one instance
    lives per chunk stream; payload accumulates in a bytearray so a
    message split over N chunks costs O(len) total, not O(len*N))."""

    __slots__ = ("msg_stream_id", "msg_length", "msg_type", "timestamp",
                 "timestamp_delta", "extended", "data")

    def __init__(self):
        self.msg_stream_id = 0
        self.msg_length = 0
        self.msg_type = 0
        self.timestamp = 0
        self.timestamp_delta = 0
        self.extended = False
        self.data = bytearray()


class ChunkDeserializer:
    """Incremental parser with per-chunk-stream partial assembly.

    The byte buffer is consumed via a read offset (compacted only when
    parsing stalls) and message payloads accumulate in per-stream
    bytearrays — ``Chunk`` objects materialize once per complete
    message, not once per 128-byte wire chunk."""

    #: pending-byte cap: parse stalls (e.g. a type-1/2/3 chunk on a chunk
    #: stream with no prior type-0 — the reference also waits forever,
    #: deserialize.swift getChunk1-3 guard) must not grow the buffer
    #: unboundedly; 32 MB = 2x the largest declarable message (be24)
    MAX_PENDING = 1 << 25

    def __init__(self, in_chunk_size: int = DEFAULT_CHUNK_SIZE,
                 max_pending: int = MAX_PENDING,
                 native: Optional[bool] = None):
        self.in_chunk_size = in_chunk_size
        self.max_pending = max_pending
        self._partial: Dict[int, _Partial] = {}
        self._buffer = bytearray()
        self._pos = 0
        self._h = None
        lib = _load_native() if native in (None, True) else None
        if native is True and lib is None:
            raise RuntimeError("native rtmp dechunker unavailable")
        if lib is not None:
            self._nlib = lib
            self._h = lib.sv_rtmp_dechunk_new(in_chunk_size, max_pending)
            self._hdr = ctypes.create_string_buffer(28)
            self._pp = ctypes.c_void_p()
            self._pl = ctypes.c_uint64()
            import weakref
            self._fin = weakref.finalize(self, lib.sv_rtmp_dechunk_free,
                                         self._h)

    @property
    def native(self) -> bool:
        return self._h is not None

    @property
    def pending(self) -> int:
        """Unconsumed inbound bytes (bounded by ``max_pending``)."""
        if self._h is not None:
            return self._nlib.sv_rtmp_dechunk_pending(self._h)
        return len(self._buffer) - self._pos

    def set_chunk_size(self, size: int) -> None:
        self.in_chunk_size = size
        if self._h is not None:
            self._nlib.sv_rtmp_dechunk_set_chunk_size(self._h, size)

    def feed(self, data: bytes) -> List[Chunk]:
        """Append bytes; return every completed message chunk.

        NOTE: when a consumer reacts to control messages that change parse
        state (set-chunk-size), use ``append`` + ``poll`` instead so the
        state change applies before the next message is parsed
        (rtmp.swift Deserialize interleaves parse and handle, :633-659).
        """
        self.append(data)
        out: List[Chunk] = []
        while True:
            chunk = self.poll()
            if chunk is None:
                break
            out.append(chunk)
        return out

    def append(self, data: bytes) -> None:
        if self._h is not None:
            self._nlib.sv_rtmp_dechunk_append(self._h, bytes(data), len(data))
            return
        self._buffer += data

    def poll(self) -> Optional[Chunk]:
        """Parse and return the next complete message, or None."""
        if self._h is not None:
            r = self._nlib.sv_rtmp_dechunk_poll(
                self._h, self._hdr, ctypes.byref(self._pp),
                ctypes.byref(self._pl))
            if r == 0:
                return None
            if r < 0:
                raise ValueError(
                    self._nlib.sv_rtmp_dechunk_error(self._h).decode())
            csid, msid, length, mtype, ext, _, ts, delta = struct.unpack(
                "<IIIBBHqI", self._hdr.raw)
            data = ctypes.string_at(self._pp, self._pl.value)
            return Chunk(msg_stream_id=msid, msg_length=length,
                         msg_type=mtype, chunk_stream_id=csid,
                         timestamp=ts, timestamp_delta=delta,
                         extended=bool(ext), data=data)
        while True:
            chunk, consumed = self._try_parse()
            if consumed == 0:
                if self._pos:
                    del self._buffer[:self._pos]
                    self._pos = 0
                if len(self._buffer) > self.max_pending:
                    raise ValueError(
                        f"rtmp inbound buffer exceeded {self.max_pending} "
                        "bytes without a parseable chunk (protocol "
                        "violation or desync)")
                return None
            self._pos += consumed
            if chunk is not None:
                return chunk

    def _complete(self, p: _Partial, csid: int) -> Chunk:
        data = bytes(p.data)
        p.data = bytearray()
        return Chunk(msg_stream_id=p.msg_stream_id, msg_length=p.msg_length,
                     msg_type=p.msg_type, chunk_stream_id=csid,
                     timestamp=p.timestamp, timestamp_delta=p.timestamp_delta,
                     extended=p.extended, data=data)

    # returns (complete_chunk_or_None, bytes_consumed); consumed==0 => wait
    def _try_parse(self) -> Tuple[Optional[Chunk], int]:
        buf = self._buffer
        pos0 = self._pos
        avail = len(buf) - pos0
        if avail <= 0:
            return None, 0
        b0 = buf[pos0]
        fmt = (b0 & 0xC0) >> 6
        csid = b0 & 0x3F
        pos = 1
        if csid == 0:
            if avail < 2:
                return None, 0
            csid = buf[pos0 + 1] + 64
            pos = 2
        elif csid == 1:
            if avail < 3:
                return None, 0
            csid = struct.unpack_from("<H", buf, pos0 + 1)[0] + 64
            pos = 3
        prev = self._partial.get(csid)
        parser = (self._chunk0, self._chunk1, self._chunk2, self._chunk3)[fmt]
        result = parser(buf, pos0, pos, avail, csid, prev)
        if result is None:
            return None, 0
        p, consumed = result
        if len(p.data) == p.msg_length:
            return self._complete(p, csid), consumed
        return None, consumed

    @staticmethod
    def _read_ts(buf, pos0: int, pos: int, avail: int, need: int):
        """Read be24 ts field + optional extended; offsets relative to
        ``pos0``. Returns (ts, hdr_len, extended) or None to wait."""
        if avail < pos + need:
            return None
        a = pos0 + pos
        ts = (buf[a] << 16) | (buf[a + 1] << 8) | buf[a + 2]
        if ts == 0xFFFFFF:
            if avail < pos + need + 4:
                return None
            full = struct.unpack_from(">I", buf, a + need)[0]
            return full, need + 4, True
        return ts, need, False

    def _chunk0(self, buf, pos0, pos, avail, csid, prev):
        r = self._read_ts(buf, pos0, pos, avail, 11)
        if r is None:
            return None
        serial_ts, hdr_len, ext = r
        a = pos0 + pos
        length = (buf[a + 3] << 16) | (buf[a + 4] << 8) | buf[a + 5]
        msg_type = buf[a + 6]
        msid = struct.unpack_from("<I", buf, a + 7)[0]
        body_pos = pos + hdr_len
        take = min(length, self.in_chunk_size)
        if avail < body_pos + take:
            return None
        # RFC1982 serial arithmetic (deserialize.swift:92-101)
        if prev is not None:
            prev_serial = prev.timestamp % 0x100000000
            if prev_serial > serial_ts and (prev_serial - serial_ts) > 0x7FFFFFFF:
                timestamp = prev.timestamp + serial_ts \
                    + (0x100000000 - prev_serial)
            else:
                timestamp = prev.timestamp + (serial_ts - prev_serial)
        else:
            timestamp = serial_ts
            self._partial[csid] = prev = _Partial()
        prev.msg_stream_id = msid
        prev.msg_length = length
        prev.msg_type = msg_type
        prev.timestamp = timestamp
        prev.timestamp_delta = 0
        # track what the WIRE said, not a re-derivation from the value:
        # type-3 continuations carry an extended field iff this header did,
        # and a peer may use extended encoding for values < 0xFFFFFF
        prev.extended = ext
        prev.data = bytearray(buf[pos0 + body_pos:pos0 + body_pos + take])
        return prev, body_pos + take

    def _chunk1(self, buf, pos0, pos, avail, csid, prev):
        if prev is None:
            return None
        r = self._read_ts(buf, pos0, pos, avail, 7)
        if r is None:
            return None
        delta, hdr_len, ext = r
        a = pos0 + pos
        length = (buf[a + 3] << 16) | (buf[a + 4] << 8) | buf[a + 5]
        msg_type = buf[a + 6]
        body_pos = pos + hdr_len
        take = min(length, self.in_chunk_size)
        if avail < body_pos + take:
            return None
        prev.msg_length = length
        prev.msg_type = msg_type
        prev.timestamp += delta
        prev.timestamp_delta = delta
        prev.extended = ext           # wire encoding, not value-derived
        prev.data = bytearray(buf[pos0 + body_pos:pos0 + body_pos + take])
        return prev, body_pos + take

    def _chunk2(self, buf, pos0, pos, avail, csid, prev):
        if prev is None:
            return None
        r = self._read_ts(buf, pos0, pos, avail, 3)
        if r is None:
            return None
        delta, hdr_len, ext = r
        body_pos = pos + hdr_len
        take = min(prev.msg_length, self.in_chunk_size)
        if avail < body_pos + take:
            return None
        prev.timestamp += delta
        prev.timestamp_delta = delta
        prev.extended = ext           # wire encoding, not value-derived
        prev.data = bytearray(buf[pos0 + body_pos:pos0 + body_pos + take])
        return prev, body_pos + take

    def _chunk3(self, buf, pos0, pos, avail, csid, prev):
        if prev is None:
            return None
        body_pos = pos + (4 if prev.extended else 0)
        already = len(prev.data)
        take = min(prev.msg_length - already, self.in_chunk_size)
        if avail < body_pos + take:
            return None
        if already == 0:       # new message repeating the previous header
            prev.timestamp += prev.timestamp_delta
        prev.data += buf[pos0 + body_pos:pos0 + body_pos + take]
        return prev, body_pos + take
