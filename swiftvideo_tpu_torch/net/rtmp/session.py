"""RTMP session core: handshake FSM + message dispatch, transport-agnostic.

Reference semantics: ``Sources/SwiftVideo/rtmp/states.swift``
and the session glue of ``rtmp/rtmp.swift``:

* server handshake c0c1 -> s0s1s2 -> c2 -> establish (states.swift:71-131);
  client writeC0C1 -> s0s1 -> c2 -> connect command sequence.
* message dispatch by type: 0x1 set-chunk-size, 0x4 user control, 0x8
  audio, 0x9 video, 0x12 data (onMetaData encoder), 0x14 AMF command
  (states.swift:174-181).
* server command handlers: connect (sets 4096 chunk size + _result),
  releaseStream/FCPublish (generic _result), createStream (allocates
  msgStreamId), publish / play (marks started) (states.swift:256-389).
* client command sequence: connect -> releaseStream+FCPublish+createStream
  -> publish (or play — implemented here; the reference left the play
  client unfinished, states.swift:496-499) with _result responder maps.
* FLV-style media tag parsing into CodedMediaSample with AVC cts from the
  24-bit composition offset (states.swift:198-248); codec config packets
  land in side data.

``RtmpSessionCore.feed(bytes)`` consumes network bytes and returns
``(out_bytes, media_samples)``; ``started``/``publish_to_peer`` expose the
negotiated role.  The asyncio layer (net.rtmp.rtmp) wraps this core.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple
from urllib.parse import urlparse

from ...core import Clock, TimePoint, WallClock
from ...media.coded import CodedMediaSample, MediaFormat, MediaType
from . import amf
from .chunks import Chunk, ChunkDeserializer, ChunkSerializer


@dataclass
class Context:
    """Mutable session state (rtmp.swift:753-858 Context record)."""

    asset_id: str
    app: Optional[str] = None
    tc_url: Optional[str] = None
    url: Optional[str] = None
    play_path: Optional[str] = None
    msg_stream_id: int = 0
    command_number: int = 1
    started: bool = False
    publish_to_peer: bool = False   # server: peer wants to play; client: we publish
    dialed_out: bool = False
    encoder: Optional[str] = None
    side_data: Dict[str, bytes] = field(default_factory=dict)
    workspace_id: Optional[str] = None


def parse_rtmp_url(url: str):
    """rtmp://host[:port]/app/playPath (rtmp.swift:60-92)."""
    parsed = urlparse(url)
    host = parsed.hostname or "localhost"
    port = parsed.port or 1935
    parts = [p for p in parsed.path.split("/") if p]
    app = parts[0] if parts else ""
    play_path = "/".join(parts[1:]) if len(parts) > 1 else ""
    if parsed.query:
        play_path = play_path + "?" + parsed.query
    tc_url = f"rtmp://{host}:{port}/{app}"
    return host, port, app, play_path, tc_url


class RtmpSessionCore:
    """One connection's protocol engine."""

    def __init__(self, *, is_server: bool, asset_id: str,
                 clock: Optional[Clock] = None,
                 app: str = "", tc_url: str = "", play_path: str = "",
                 publish_to_peer: bool = True, url: Optional[str] = None):
        self.is_server = is_server
        self.clock = clock or WallClock()
        self.ctx = Context(asset_id=asset_id, app=app or None,
                           tc_url=tc_url or None, play_path=play_path or None,
                           url=url, dialed_out=not is_server,
                           publish_to_peer=publish_to_peer)
        self.serializer = ChunkSerializer()
        self.deserializer = ChunkDeserializer()
        self._hs_state = "c0c1" if is_server else "s0s1"
        self._hs_buf = b""
        self._responders: Dict[int, Callable] = {}
        self.errors: List[str] = []     # dial-fatal (see rtmp._connect_once)
        self.warnings: List[str] = []   # recoverable parse failures
        self.notices: List[str] = []    # informational onStatus codes
        #: set when the inbound byte stream is unrecoverable (chunk-stream
        #: desync past the deserializer's pending cap); owners should close
        #: the connection
        self.fatal: Optional[str] = None

    # --- public API -------------------------------------------------------
    @property
    def started(self) -> bool:
        return self.ctx.started

    def start_bytes(self) -> bytes:
        """Client hello: c0 + c1 (states.swift writeC0c1)."""
        if self.is_server:
            return b""
        return bytes([3]) + bytes(8) + os.urandom(1528)

    def feed(self, data: bytes) -> Tuple[bytes, List[CodedMediaSample]]:
        out = b""
        samples: List[CodedMediaSample] = []
        if self._hs_state != "established":
            hs_out, remainder = self._handshake(data)
            out += hs_out
            if self._hs_state != "established" or not remainder:
                return out, samples
            data = remainder
        # parse-then-handle one message at a time: control messages
        # (set-chunk-size) must apply before the next parse
        self.deserializer.append(data)
        while True:
            try:
                chunk = self.deserializer.poll()
            except ValueError as exc:     # pending-cap overflow: desync
                self.fatal = str(exc)
                self.errors.append(self.fatal)
                break
            if chunk is None:
                break
            try:
                msg_out, msg_samples = self._handle_chunk(chunk)
            except (ValueError, IndexError, TypeError, struct.error) as exc:
                # TypeError: AMF payloads are attacker-typed (e.g. a null
                # transaction id reaching int()) — contain like the rest.
                # A single malformed message is recoverable (parsing
                # continues at the next chunk), so it is a warning, not a
                # dial-fatal error: one junk data message from a server
                # must not burn the client's 30 reconnect attempts
                self.warnings.append(
                    f"malformed msg 0x{chunk.msg_type:x}: {exc}")
                continue
            out += msg_out
            samples.extend(msg_samples)
        return out, samples

    # --- handshake (states.swift:71-131) ----------------------------------
    def _handshake(self, data: bytes) -> Tuple[bytes, bytes]:
        self._hs_buf += data
        out = b""
        if self.is_server:
            if self._hs_state == "c0c1" and len(self._hs_buf) >= 1537:
                c1 = self._hs_buf[1:1537]
                # s0 s1 s2: echo version, zero the "complex handshake" bytes
                s1 = self._hs_buf[1:5] + bytes(4) + self._hs_buf[9:1537]
                out += self._hs_buf[0:1] + s1[:1536] + c1
                self._hs_buf = self._hs_buf[1537:]
                self._hs_state = "c2"
            if self._hs_state == "c2" and len(self._hs_buf) >= 1536:
                self._hs_buf = self._hs_buf[1536:]
                self._hs_state = "established"
        else:
            if self._hs_state == "s0s1" and len(self._hs_buf) >= 1537:
                s1 = self._hs_buf[1:1537]
                out += s1  # c2 echoes s1
                self._hs_buf = self._hs_buf[1537:]
                self._hs_state = "s2"
            if self._hs_state == "s2" and len(self._hs_buf) >= 1536:
                self._hs_buf = self._hs_buf[1536:]
                self._hs_state = "established"
                out += self._create_connect()
        remainder = b""
        if self._hs_state == "established":
            remainder = self._hs_buf
            self._hs_buf = b""
        return out, remainder

    # --- message dispatch (states.swift:174-181) ---------------------------
    def _handle_chunk(self, chunk: Chunk) -> Tuple[bytes, List[CodedMediaSample]]:
        handler = {
            0x1: self._handle_chunk_size,
            0x4: lambda c: (b"", []),
            0x8: self._handle_audio,
            0x9: self._handle_video,
            0x12: self._handle_data,
            0x14: self._handle_command,
        }.get(chunk.msg_type)
        if handler is None:
            return b"", []
        return handler(chunk)

    def _handle_chunk_size(self, chunk: Chunk):
        if len(chunk.data) >= 4:
            size = struct.unpack(">I", chunk.data[:4])[0]
            # spec 5.4.1: high bit 0, valid range 1..0x7FFFFFFF — a zero
            # (or high-bit) size would desync the parser into per-byte
            # garbage, so reject instead of applying
            if not 1 <= size <= 0x7FFFFFFF:
                raise ValueError(f"invalid SetChunkSize {size}")
            self.deserializer.set_chunk_size(size)
        return b"", []

    # --- media (states.swift:198-248) --------------------------------------
    def _handle_video(self, chunk: Chunk):
        data = chunk.data
        if len(data) < 5:
            return b"", []
        if data[0] & 0x80:
            return self._handle_video_ex(chunk)
        if data[0] & 0x0F != 7:
            # legacy FLV tag for a non-AVC codec (Sorenson/Screen/VP6):
            # parsing its payload as an AVC cts+body would hand decoders
            # garbage labeled avc — ignore the stream instead.  (The
            # reference assumes avc unconditionally, states.swift:198-223.)
            return b"", []
        is_config = data[1] == 0
        if is_config and len(data) > 4:
            self.ctx.side_data["videoConfig"] = data[5:]
            return b"", []
        config = self.ctx.side_data.get("videoConfig")
        if config is None or len(data) <= 5:
            return b"", []
        cts = (data[2] << 16) | (data[3] << 8) | data[4]
        if cts >= 0x800000:            # FLV CompositionTime is SI24
            cts -= 0x1000000
        sample = CodedMediaSample(
            buffer=data[5:],
            pts_value=TimePoint(chunk.timestamp + cts, 1000),
            dts_value=TimePoint(chunk.timestamp, 1000),
            media_type=MediaType.video, media_format=MediaFormat.avc,
            id_asset=self.ctx.asset_id, id_workspace=self.ctx.app or "",
            token_workspace=self.ctx.play_path,
            time_point=self.clock.current(),
            side={"config": config}, encoder=self.ctx.encoder or "")
        return b"", [sample]

    def _handle_video_ex(self, chunk: Chunk):
        """Enhanced RTMP ex-header video (E-RTMP v1): isExHeader bit set,
        packet type in the low nibble, codec fourCC next; 24-bit
        composition time only for hvc1 CodedFrames.  Beyond the
        reference, which parses legacy avc tags only
        (states.swift:198-223)."""
        from .media import FOURCC_VIDEO
        data = chunk.data
        ptype = data[0] & 0x0F
        fmt = FOURCC_VIDEO.get(bytes(data[1:5]))
        if fmt is None:
            return b"", []
        if ptype == 0:                       # PacketTypeSequenceStart
            self.ctx.side_data["videoConfig"] = data[5:]
            self.ctx.side_data["videoFormat"] = fmt
            return b"", []
        if ptype not in (1, 3):              # CodedFrames / CodedFramesX
            return b"", []
        cts, off = 0, 5
        if fmt == MediaFormat.hevc and ptype == 1:
            if len(data) < 8:
                return b"", []
            cts = (data[5] << 16) | (data[6] << 8) | data[7]
            if cts >= 0x800000:        # E-RTMP composition time is SI24
                cts -= 0x1000000
            off = 8
        if len(data) <= off:
            return b"", []
        config = self.ctx.side_data.get("videoConfig")
        side = {"config": config} if config is not None else {}
        sample = CodedMediaSample(
            buffer=data[off:],
            pts_value=TimePoint(chunk.timestamp + cts, 1000),
            dts_value=TimePoint(chunk.timestamp, 1000),
            media_type=MediaType.video, media_format=fmt,
            id_asset=self.ctx.asset_id, id_workspace=self.ctx.app or "",
            token_workspace=self.ctx.play_path,
            time_point=self.clock.current(),
            side=side, encoder=self.ctx.encoder or "")
        return b"", [sample]

    def _handle_audio(self, chunk: Chunk):
        data = chunk.data
        if len(data) < 2:
            return b"", []
        if (data[0] >> 4) == 9:
            return self._handle_audio_ex(chunk)
        if (data[0] >> 4) != 10:
            # legacy FLV sound formats other than AAC (MP3/ADPCM/Speex...)
            # have no AACPacketType byte — ignore rather than mislabel
            return b"", []
        is_config = data[1] == 0
        if is_config:
            self.ctx.side_data["audioConfig"] = data[2:]
            return b"", []
        config = self.ctx.side_data.get("audioConfig")
        if config is None or len(data) <= 2:
            return b"", []
        sample = CodedMediaSample(
            buffer=data[2:],
            pts_value=TimePoint(chunk.timestamp, 1000),
            dts_value=TimePoint(chunk.timestamp, 1000),
            media_type=MediaType.audio, media_format=MediaFormat.aac,
            id_asset=self.ctx.asset_id, id_workspace=self.ctx.app or "",
            token_workspace=self.ctx.play_path,
            time_point=self.clock.current(),
            side={"config": config}, encoder=self.ctx.encoder or "")
        return b"", [sample]

    def _handle_audio_ex(self, chunk: Chunk):
        """E-RTMP v2 audio ex-header: soundFormat 9, packet type in the
        low nibble, fourCC next (Opus)."""
        from .media import FOURCC_AUDIO
        data = chunk.data
        if len(data) < 5:
            return b"", []
        ptype = data[0] & 0x0F
        fmt = FOURCC_AUDIO.get(bytes(data[1:5]))
        if fmt is None:
            return b"", []
        if ptype == 0:                       # AudioPacketTypeSequenceStart
            self.ctx.side_data["audioConfig"] = data[5:]
            self.ctx.side_data["audioFormat"] = fmt
            return b"", []
        if ptype != 1 or len(data) <= 5:     # AudioPacketTypeCodedFrames
            return b"", []
        config = self.ctx.side_data.get("audioConfig")
        side = {"config": config} if config is not None else {}
        sample = CodedMediaSample(
            buffer=data[5:],
            pts_value=TimePoint(chunk.timestamp, 1000),
            dts_value=TimePoint(chunk.timestamp, 1000),
            media_type=MediaType.audio, media_format=fmt,
            id_asset=self.ctx.asset_id, id_workspace=self.ctx.app or "",
            token_workspace=self.ctx.play_path,
            time_point=self.clock.current(),
            side=side, encoder=self.ctx.encoder or "")
        return b"", [sample]

    def _handle_data(self, chunk: Chunk):
        try:
            atoms = amf.parse(chunk.data)
        except amf.AmfError:
            return b"", []
        for atom in atoms:
            if isinstance(atom, dict) and "encoder" in atom:
                enc = atom["encoder"]
                if isinstance(enc, str):
                    self.ctx.encoder = enc
        return b"", []

    # --- commands (states.swift:256-527) ------------------------------------
    def _command_chunk(self, payload: bytes, csid: int = 3,
                       msg_stream_id: Optional[int] = None) -> bytes:
        chunk = Chunk(msg_stream_id=msg_stream_id if msg_stream_id is not None
                      else self.ctx.msg_stream_id,
                      msg_length=len(payload), msg_type=0x14,
                      chunk_stream_id=csid, timestamp=0, timestamp_delta=0,
                      data=payload)
        return self.serializer.serialize(chunk)

    def _handle_command(self, chunk: Chunk):
        try:
            atoms = amf.parse(chunk.data)
        except amf.AmfError:
            return b"", []
        if not atoms or not isinstance(atoms[0], str):
            return b"", []
        command = atoms[0]
        if self.is_server:
            handlers = {
                "connect": self._srv_connect,
                "releaseStream": self._srv_generic_result,
                "FCPublish": self._srv_generic_result,
                "createStream": self._srv_create_stream,
                "publish": self._srv_publish,
                "play": self._srv_play,
            }
        else:
            handlers = {"_result": self._cli_result,
                        "onStatus": self._cli_on_status}
        handler = handlers.get(command)
        if handler is None:
            return b"", []
        return handler(atoms, chunk)

    # server side
    def _srv_connect(self, atoms, chunk):
        # validate the fallible input BEFORE mutating serializer state:
        # if float(ident) raised after _set_chunk_size, feed() would drop
        # these bytes but the serializer would already emit 4096-byte
        # chunks the peer was never told about (permanent desync)
        ident = atoms[1] if len(atoms) > 1 else 1.0
        ident = float(ident)
        if len(atoms) >= 3 and isinstance(atoms[2], dict):
            self.ctx.app = atoms[2].get("app")
            self.ctx.tc_url = atoms[2].get("tcUrl")
        # set outgoing chunk size to 4096 first (states.swift:392-407)
        out = self._set_chunk_size(4096)
        result = amf.serialize([
            "_result", ident,
            {"fmsVer": "FMS/3,0,1,123", "capabilities": 31.0},
            {"level": "status", "code": "NetConnection.Connect.Success",
             "description": "Connection succeeded", "objectEncoding": 0.0}])
        return out + self._command_chunk(result, chunk.chunk_stream_id), []

    def _set_chunk_size(self, size: int) -> bytes:
        # protocol control messages ride msg stream 0 (RTMP spec 5.4) —
        # NOT the createStream-allocated stream id
        chunk = Chunk(msg_stream_id=0, msg_length=4,
                      msg_type=0x1, chunk_stream_id=2, timestamp=0,
                      data=struct.pack(">I", size))
        out = self.serializer.serialize(chunk)
        self.serializer.set_chunk_size(size)
        return out

    def _srv_generic_result(self, atoms, chunk):
        ident = atoms[1] if len(atoms) > 1 else 0.0
        return self._command_chunk(amf.serialize(["_result", float(ident)]),
                                   chunk.chunk_stream_id), []

    def _srv_create_stream(self, atoms, chunk):
        self.ctx.msg_stream_id += 1
        ident = atoms[1] if len(atoms) > 1 else 0.0
        result = amf.serialize(["_result", float(ident), None,
                                float(self.ctx.msg_stream_id)])
        return self._command_chunk(result, chunk.chunk_stream_id), []

    def _srv_publish(self, atoms, chunk):
        if len(atoms) > 3 and isinstance(atoms[3], str):
            self.ctx.play_path = atoms[3]
            self.ctx.started = True
            self.ctx.publish_to_peer = False
        return b"", []

    def _srv_play(self, atoms, chunk):
        if len(atoms) > 3 and isinstance(atoms[3], str):
            self.ctx.play_path = atoms[3]
            self.ctx.started = True
            self.ctx.publish_to_peer = True
        return b"", []

    def publish_start_bytes(self) -> bytes:
        """onStatus NetStream.Publish.Start (sent by the server once the app
        approves the connection; rtmp.swift:260-263)."""
        code = "NetStream.Play.Start" if self.ctx.publish_to_peer \
            else "NetStream.Publish.Start"
        result = amf.serialize([
            "onStatus", 0.0, None,
            {"level": "status", "code": code, "description": code,
             "objectEncoding": 0.0}])
        return self._command_chunk(result, 3)

    # client side
    def _create_connect(self) -> bytes:
        n = self.ctx.command_number
        props = {"app": self.ctx.app or "", "tcUrl": self.ctx.tc_url or ""}
        payload = amf.serialize(["connect", float(n), props])
        self._responders[n] = self._cli_connect_result
        self.ctx.command_number = n + 1
        return self._command_chunk(payload)

    def _cli_result(self, atoms, chunk):
        if len(atoms) < 2:
            return b"", []
        ident = int(atoms[1])
        fn = self._responders.pop(ident, None)
        if fn is None:
            return b"", []
        return fn(atoms, chunk)

    def _cli_connect_result(self, atoms, chunk):
        code = None
        if len(atoms) > 3 and isinstance(atoms[3], dict):
            code = atoms[3].get("code")
        if code != "NetConnection.Connect.Success":
            self.errors.append(f"connect failed: {code}")
            return b"", []
        return self._create_create_stream(), []

    def _create_create_stream(self) -> bytes:
        n = self.ctx.command_number
        out = self._command_chunk(amf.serialize(
            ["releaseStream", float(n), None, self.ctx.play_path or ""]))
        out += self._command_chunk(amf.serialize(
            ["FCPublish", float(n + 1), None, self.ctx.play_path or ""]))
        out += self._command_chunk(amf.serialize(["createStream",
                                                  float(n + 2), None]))
        self._responders[n + 2] = self._cli_create_stream_result
        self.ctx.command_number = n + 3
        return out

    def _cli_create_stream_result(self, atoms, chunk):
        if len(atoms) < 4 or not isinstance(atoms[3], float):
            self.errors.append("invalid createStream result")
            return b"", []
        self.ctx.msg_stream_id = int(atoms[3])
        if self.ctx.publish_to_peer:
            return self._create_publish(), []
        return self._create_play(), []

    def _create_publish(self) -> bytes:
        n = self.ctx.command_number
        self.ctx.command_number = n + 1
        # raise the outgoing chunk size before media starts (the server
        # does the same at connect, states.swift:392-407; 128-byte chunks
        # would cost a header per 128 payload bytes on every frame)
        return self._set_chunk_size(4096) + self._command_chunk(
            amf.serialize(["publish", float(n), None,
                           self.ctx.play_path or ""]))

    def _create_play(self) -> bytes:
        """Client play (completed here; reference TODO at states.swift:496)."""
        n = self.ctx.command_number
        self.ctx.command_number = n + 1
        return self._command_chunk(amf.serialize(
            ["play", float(n), None, self.ctx.play_path or ""]))

    def _cli_on_status(self, atoms, chunk):
        code, level = None, None
        if len(atoms) > 3 and isinstance(atoms[3], dict):
            code = atoms[3].get("code")
            level = atoms[3].get("level")
        if code in ("NetStream.Publish.Start", "NetStream.Play.Start"):
            self.ctx.started = True
        elif code and (level == "error" or ".Failed" in str(code)
                       or ".BadName" in str(code)):
            # only level:"error" statuses are fatal; informational ones
            # (NetStream.Play.Reset before Play.Start, Publish.Notify,
            # Data.Start...) are a normal part of the dialogue — failing
            # the dial on them burned every reconnect attempt against a
            # perfectly working server
            self.errors.append(str(code))
        elif code:
            self.notices.append(str(code))
        return b"", []

    def unpublish_bytes(self) -> bytes:
        """FCUnpublish + deleteStream (states.swift unpublish)."""
        n = self.ctx.command_number
        out = self._command_chunk(amf.serialize(
            ["FCUnpublish", float(n), None, self.ctx.play_path or ""]))
        out += self._command_chunk(amf.serialize(
            ["deleteStream", float(n + 1), None, float(self.ctx.msg_stream_id)]))
        self.ctx.command_number = n + 2
        return out
