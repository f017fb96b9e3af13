"""flavor protocol: isobmff-atom server<->server stream relay.

Implemented from the self-contained spec (``flavor.md``) —
role parity with the reference's ``net.flavor.swift``:

* little-endian ``[u32 size][FourCC]`` atom framing with dynamic types
  (in32/in64/fl32/fl64/bool/data/utf8), dicts, and lists;
* sync / asyn RPC with rply responses (ping handshake, push/pull stream
  negotiation with freeform tokens, caps / mdqr queries, meta, rmtk,
  bye!);
* ``trak`` track registry (codec FourCC, stream id, track id, time base,
  uses_dts, extradata) and ``mdia`` media framing;
* publisher auto-sends track info on the first sample of each format
  (net.flavor.swift:745-885); subscriber rebuilds CodedMediaSample from
  the registry (:887-976).

``FlavorSessionCore`` is transport-agnostic (feed bytes -> bytes out +
samples); the asyncio facade mirrors net.rtmp.
"""

from __future__ import annotations

import asyncio
import struct
import threading
import uuid
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple
from urllib.parse import urlparse

from ..core import (Clock, EventBox, EventError, ResultEvent, Source,
                    Terminal, TimePoint, Tx, WallClock, rescale)
from ..media.coded import CodedMediaSample, MediaFormat, MediaType
from .tcp import Connection, NetworkEvent, tcp_client, tcp_serve

DEFAULT_PORT = 3751  # 0xEA7

# --- atom model ------------------------------------------------------------

Atom = Tuple[str, object]  # (fourcc, payload)


def _fourcc(tag: str) -> bytes:
    return tag.encode("ascii")[:4].ljust(4)


class FlavorError(Exception):
    pass


def serialize_atom(tag: str, body: bytes) -> bytes:
    return struct.pack("<I", len(body) + 8) + _fourcc(tag) + body


def atom_in32(v: int) -> bytes:
    return serialize_atom("in32", struct.pack("<i", v))


def atom_in64(v: int) -> bytes:
    return serialize_atom("in64", struct.pack("<q", v))


def atom_fl64(v: float) -> bytes:
    return serialize_atom("fl64", struct.pack("<d", v))


def atom_fl32(v: float) -> bytes:
    return serialize_atom("fl32", struct.pack("<f", v))


def atom_bool(v: bool) -> bytes:
    return serialize_atom("bool", b"\x01" if v else b"\x00")


def atom_utf8(s: str) -> bytes:
    return serialize_atom("utf8", s.encode("utf-8"))


def atom_data(b: bytes) -> bytes:
    return serialize_atom("data", b)


def atom_list(items: List[bytes]) -> bytes:
    return serialize_atom("list", b"".join(items))


def atom_dict(d: Dict[str, bytes]) -> bytes:
    body = b"".join(atom_utf8(k) + v for k, v in d.items())
    return serialize_atom("dict", body)


def encode_value(v) -> bytes:
    if isinstance(v, bool):
        return atom_bool(v)
    if isinstance(v, int):
        return atom_in64(v) if abs(v) > 0x7FFFFFFF else atom_in32(v)
    if isinstance(v, float):
        return atom_fl64(v)
    if isinstance(v, str):
        return atom_utf8(v)
    if isinstance(v, bytes):
        return atom_data(v)
    if isinstance(v, dict):
        return atom_dict({k: encode_value(x) for k, x in v.items()})
    if isinstance(v, (list, tuple)):
        return atom_list([encode_value(x) for x in v])
    raise FlavorError(f"unencodable {type(v)}")


def parse_atoms(data: bytes, offset: int = 0, end: Optional[int] = None):
    """Yield (tag, body_bytes) for each atom in [offset, end)."""
    end = len(data) if end is None else end
    while offset + 8 <= end:
        size = struct.unpack_from("<I", data, offset)[0]
        if size < 8 or offset + size > end:
            raise FlavorError(f"bad atom size {size}")
        tag = data[offset + 4:offset + 8].decode("ascii", "replace")
        yield tag, data[offset + 8:offset + size]
        offset += size


def _fixed(fmt: str, body: bytes, n: int):
    if len(body) < n:
        raise FlavorError(f"truncated {fmt} body")
    return struct.unpack(fmt, body[:n])[0]


def decode_value(tag: str, body: bytes, _depth: int = 0):
    if _depth > 32:
        raise FlavorError("atom nesting too deep")
    if tag == "in32":
        return _fixed("<i", body, 4)
    if tag == "in64":
        return _fixed("<q", body, 8)
    if tag == "fl32":
        return _fixed("<f", body, 4)
    if tag == "fl64":
        return _fixed("<d", body, 8)
    if tag == "bool":
        return bool(body[0]) if body else False
    if tag == "utf8":
        return body.decode("utf-8", "replace")
    if tag == "data":
        return body
    if tag == "list":
        return [decode_value(t, b, _depth + 1) for t, b in parse_atoms(body)]
    if tag == "dict":
        out = {}
        items = list(parse_atoms(body))
        for i in range(0, len(items) - 1, 2):
            ktag, kbody = items[i]
            vtag, vbody = items[i + 1]
            if ktag != "utf8":
                raise FlavorError("dict keys must be utf8")
            out[kbody.decode("utf-8", "replace")] = decode_value(
                vtag, vbody, _depth + 1)
        return out
    return body  # opaque


# --- codec FourCC mapping (flavor.md Codecs) -------------------------------

# largest atom a peer may declare: media atoms carry one coded sample
# (a 4K intra frame is ~2 MB); anything past this is hostile or corrupt
MAX_ATOM_SIZE = 1 << 26

FOURCC_TO_FORMAT = {
    "AVC1": MediaFormat.avc, "HVC1": MediaFormat.hevc,
    "VP80": MediaFormat.vp8, "VP90": MediaFormat.vp9,
    "AV10": MediaFormat.av1, "MP4A": MediaFormat.aac,
    "OPUS": MediaFormat.opus,
}
FORMAT_TO_FOURCC = {v: k for k, v in FOURCC_TO_FORMAT.items()}
_AUDIO_FORMATS = {MediaFormat.aac, MediaFormat.opus}


@dataclass
class TrackInfo:
    fourcc: str
    stream_id: int
    track_id: int
    time_base: int
    uses_dts: bool
    extradata: Optional[bytes] = None

    def media_type(self) -> MediaType:
        return (MediaType.audio if FOURCC_TO_FORMAT.get(self.fourcc)
                in _AUDIO_FORMATS else MediaType.video)


def serialize_trak(t: TrackInfo) -> bytes:
    body = (_fourcc(t.fourcc) + struct.pack("<ii q", t.stream_id, t.track_id,
                                            t.time_base)
            + (b"\x01" if t.uses_dts else b"\x00"))
    if t.extradata is not None:
        body += atom_data(t.extradata)
    return serialize_atom("trak", body)


def parse_trak(body: bytes) -> TrackInfo:
    if len(body) < 21:
        raise FlavorError("truncated trak body")
    fourcc = body[0:4].decode("ascii", "replace")
    stream_id, track_id, time_base = struct.unpack_from("<iiq", body, 4)
    uses_dts = bool(body[20])
    extradata = None
    for tag, b in parse_atoms(body, 21):
        if tag == "data":
            extradata = b
    return TrackInfo(fourcc, stream_id, track_id, time_base, uses_dts,
                     extradata)


def serialize_mdia(track_id: int, pts: int, dts: Optional[int],
                   payload: bytes) -> bytes:
    body = struct.pack("<i", track_id) + struct.pack("<q", pts)
    if dts is not None:
        body += struct.pack("<q", dts)
    body += atom_data(payload)
    return serialize_atom("mdia", body)


# --- RPC helpers -----------------------------------------------------------

def rpc_sync(call_id: int, call_type: str, payload: bytes = b"") -> bytes:
    return serialize_atom("sync", struct.pack("<i", call_id)
                          + _fourcc(call_type) + payload)


def rpc_asyn(call_id: int, call_type: str, payload: bytes = b"") -> bytes:
    return serialize_atom("asyn", struct.pack("<i", call_id)
                          + _fourcc(call_type) + payload)


def rpc_rply(call_id: int, code: int, payload: bytes = b"") -> bytes:
    return serialize_atom("rply", struct.pack("<ii", call_id, code) + payload)


# --- session core ----------------------------------------------------------

class FlavorSessionCore:
    """One connection's protocol engine (transport-agnostic)."""

    def __init__(self, *, is_server: bool, asset_id: str,
                 clock: Optional[Clock] = None,
                 on_push_request: Optional[Callable[[int, str], bool]] = None,
                 on_pull_request: Optional[Callable[[int, str], bool]] = None):
        self.is_server = is_server
        self.clock = clock or WallClock()
        self.asset_id = asset_id
        self._buffer = b""
        self._call_id = 1
        self._responders: Dict[int, Callable] = {}
        self.tracks: Dict[int, TrackInfo] = {}
        self.established = False
        self.push_granted = False
        self.pull_granted = False
        self.peer_pushing = False
        self.bye = False
        self.errors: List[str] = []
        self.on_push_request = on_push_request
        self.on_pull_request = on_pull_request
        self.stream_tokens: Dict[int, str] = {}
        # tracks/_call_id are mutated from producer threads (a server-side
        # FlavorPublisher emits from the clock thread via send_tracks)
        # while the loop thread iterates them in _handle_rpc — the same
        # two-writer shape the RTMP ChunkSerializer locks against
        self._lock = threading.RLock()

    def next_call_id(self) -> int:
        with self._lock:
            cid = self._call_id
            self._call_id += 1
            return cid

    def start_bytes(self) -> bytes:
        """Server hello: the ping sync (flavor.md Connection process)."""
        if self.is_server:
            return rpc_sync(0, "ping")
        return b""

    # --- client requests --------------------------------------------------
    def request_push(self, stream_id: int, token: str) -> bytes:
        cid = self.next_call_id()
        payload = atom_list([atom_in32(stream_id), atom_utf8(token)])

        def on_reply(code, extra):
            if code == 0:
                self.push_granted = True
            else:
                self.errors.append(f"push denied: {extra}")

        self._responders[cid] = on_reply
        return rpc_sync(cid, "push", payload)

    def request_pull(self, stream_id: int, token: str) -> bytes:
        cid = self.next_call_id()
        payload = atom_list([atom_in32(stream_id), atom_utf8(token)])

        def on_reply(code, extra):
            if code == 0:
                self.pull_granted = True
            else:
                self.errors.append(f"pull denied: {extra}")

        self._responders[cid] = on_reply
        return rpc_sync(cid, "pull", payload)

    def send_tracks(self, tracks: List[TrackInfo]) -> bytes:
        with self._lock:
            for t in tracks:
                self.tracks[t.track_id] = t
        payload = atom_list([serialize_trak(t) for t in tracks])
        return rpc_asyn(self.next_call_id(), "mdia", payload)

    def remove_track(self, track_id: int) -> bytes:
        with self._lock:
            self.tracks.pop(track_id, None)
        return rpc_asyn(self.next_call_id(), "rmtk",
                        atom_list([atom_in32(track_id)]))

    def bye_bytes(self) -> bytes:
        return rpc_asyn(self.next_call_id(), "bye!")

    def media_bytes(self, sample: CodedMediaSample, track: TrackInfo) -> bytes:
        pts = rescale(sample.pts(), track.time_base).value
        dts = rescale(sample.dts(), track.time_base).value \
            if track.uses_dts else None
        return serialize_mdia(track.track_id, pts, dts, sample.data())

    # --- byte pump --------------------------------------------------------
    def feed(self, data: bytes) -> Tuple[bytes, List[CodedMediaSample]]:
        # read-offset walk, one buffer compaction per feed: re-slicing the
        # backlog per atom is quadratic during relay catch-up bursts
        buf = self._buffer + data
        pos = 0
        n = len(buf)
        out = b""
        samples: List[CodedMediaSample] = []
        while n - pos >= 8:
            size = struct.unpack_from("<I", buf, pos)[0]
            if size < 8 or size > MAX_ATOM_SIZE:
                # a hostile/corrupt size up to 4 GiB would otherwise make
                # the session buffer every incoming byte forever waiting
                # for an atom that never completes; treat it like any
                # other malformed atom (record + drop the backlog)
                self.errors.append(f"bad atom size {size}")
                pos = n
                break
            if n - pos < size:
                break
            tag = buf[pos + 4:pos + 8].decode("ascii", "replace")
            body = buf[pos + 8:pos + size]
            pos += size
            try:
                o, s = self._handle_atom(tag, body)
            except (FlavorError, ValueError, IndexError,
                    struct.error) as exc:
                # malformed atom: record and resync at the next atom
                # (net.flavor.swift:673-721 error-coded resync)
                self.errors.append(f"malformed {tag}: {exc}")
                continue
            out += o
            samples.extend(s)
        self._buffer = buf[pos:]
        return out, samples

    def _handle_atom(self, tag: str, body: bytes):
        if tag == "sync":
            return self._handle_rpc(body, is_sync=True)
        if tag == "asyn":
            return self._handle_rpc(body, is_sync=False)
        if tag == "rply":
            return self._handle_reply(body)
        if tag == "mdia":
            return b"", self._handle_media(body)
        return b"", []

    def _handle_rpc(self, body: bytes, is_sync: bool):
        call_id = struct.unpack_from("<i", body, 0)[0]
        call_type = body[4:8].decode("ascii", "replace")
        payload = body[8:]
        if call_type == "ping":
            self.established = True
            return rpc_rply(call_id, 0), []
        if call_type == "push":
            return self._grant(call_id, payload, push=True), []
        if call_type == "pull":
            return self._grant(call_id, payload, push=False), []
        if call_type == "mdia":
            # track info list from the pushing peer
            with self._lock:
                for tag2, b2 in parse_atoms(payload):
                    if tag2 == "list":
                        for t3, b3 in parse_atoms(b2):
                            if t3 == "trak":
                                t = parse_trak(b3)
                                self.tracks[t.track_id] = t
                # an unsupported fourcc OR a nonsense time_base (<= 0
                # would make scale-0 TimePoints that poison mixer math)
                # is reported AND dropped: keeping the track registered
                # would later emit its media mislabeled as avc
                unsupported = [tid for tid, t in self.tracks.items()
                               if t.fourcc not in FOURCC_TO_FORMAT
                               or t.time_base <= 0]
                for tid in unsupported:
                    self.tracks.pop(tid, None)
            if unsupported:
                extra = atom_dict({"reason": atom_utf8("unsupported"),
                                   "tracks": atom_list(
                                       [atom_in32(t) for t in unsupported])})
                return rpc_rply(call_id, 1, extra), []
            return b"", []
        if call_type == "rmtk":
            with self._lock:
                for tag2, b2 in parse_atoms(payload):
                    if tag2 == "list":
                        for t3, b3 in parse_atoms(b2):
                            if t3 == "in32":
                                self.tracks.pop(
                                    struct.unpack("<i", b3[:4])[0], None)
            return b"", []
        if call_type == "caps":
            extra = atom_dict({
                "motd": atom_utf8("Welcome to flavortown"),
                "version": atom_in32(1),
                "codecs": atom_list([atom_utf8(c) for c in FOURCC_TO_FORMAT]),
            })
            return rpc_rply(call_id, 0, extra), []
        if call_type == "mdqr":
            unsupported = []
            for tag2, b2 in parse_atoms(payload):
                if tag2 == "list":
                    for idx, (t3, b3) in enumerate(parse_atoms(b2)):
                        if t3 == "tksp" and \
                                b3[0:4].decode("ascii", "replace") \
                                not in FOURCC_TO_FORMAT:
                            unsupported.append(idx)
            if unsupported:
                extra = atom_dict({"reason": atom_utf8("unsupported"),
                                   "tracks": atom_list(
                                       [atom_in32(i) for i in unsupported])})
                return rpc_rply(call_id, 1, extra), []
            return rpc_rply(call_id, 0), []
        if call_type == "bye!":
            self.bye = True
            return b"", []
        if call_type == "meta":
            return b"", []
        if is_sync:
            return rpc_rply(call_id, 404), []
        return b"", []

    def _grant(self, call_id: int, payload: bytes, push: bool) -> bytes:
        stream_id, token = 0, ""
        for tag, body in parse_atoms(payload):
            if tag == "list":
                vals = [decode_value(t, b) for t, b in parse_atoms(body)]
                if len(vals) >= 2:
                    stream_id, token = int(vals[0]), str(vals[1])
        hook = self.on_push_request if push else self.on_pull_request
        allowed = hook(stream_id, token) if hook is not None else True
        if allowed:
            self.stream_tokens[stream_id] = token
            if push:
                self.peer_pushing = True
            return rpc_rply(call_id, 0)
        return rpc_rply(call_id, 1,
                        atom_dict({"reason": atom_utf8("No Access")}))

    def _handle_reply(self, body: bytes):
        call_id, code = struct.unpack_from("<ii", body, 0)
        extra = {}
        for tag, b in parse_atoms(body, 8):
            if tag == "dict":
                extra = decode_value("dict", b)
        if call_id == 0 and not self.is_server:
            # reply to our ping is handled server-side; client established
            pass
        fn = self._responders.pop(call_id, None)
        if fn is not None:
            fn(code, extra)
        if self.is_server and call_id == 0 and code == 0:
            self.established = True
        return b"", []

    def _handle_media(self, body: bytes) -> List[CodedMediaSample]:
        track_id = struct.unpack_from("<i", body, 0)[0]
        track = self.tracks.get(track_id)
        if track is None:
            return []
        pts = struct.unpack_from("<q", body, 4)[0]
        off = 12
        if track.uses_dts:
            dts = struct.unpack_from("<q", body, off)[0]
            off += 8
        else:
            dts = pts
        payload = b""
        for tag, b in parse_atoms(body, off):
            if tag == "data":
                payload = b
        fmt = FOURCC_TO_FORMAT.get(track.fourcc)
        if fmt is None or track.time_base <= 0:
            # never emit media mislabeled with a fallback format, and
            # never build scale-<=0 TimePoints (registration rejects
            # these; this guards tracks injected by other paths)
            return []
        side = {"config": track.extradata} if track.extradata else {}
        token = self.stream_tokens.get(track.stream_id)
        return [CodedMediaSample(
            buffer=payload,
            pts_value=TimePoint(pts, track.time_base),
            dts_value=TimePoint(dts, track.time_base),
            media_type=track.media_type(), media_format=fmt,
            id_asset=self.asset_id, token_workspace=token,
            time_point=self.clock.current(), side=side)]


# --- asyncio facade --------------------------------------------------------

_TIME_BASES = {MediaType.video: 600600, MediaType.audio: 96000}


class FlavorPublisher(Terminal):
    """Push media to a peer (net.flavor.swift:745-885): tracks auto-register
    on the first sample of each format."""

    def __init__(self, conn: Connection, core: FlavorSessionCore,
                 stream_id: int):
        self.conn = conn
        self.core = core
        self.stream_id = stream_id
        self._format_tracks: Dict[MediaFormat, TrackInfo] = {}
        self._next_track = 1
        super().__init__(self._handle)

    def _handle(self, sample: CodedMediaSample) -> EventBox:
        # backpressure parity with RtmpPublisher: a stalled peer drops
        # media frames instead of buffering the transport without bound
        if not getattr(self.conn, "writable", True):
            info = sample.info()
            if info is not None:
                info.add_sample("net.flavor.dropped", 1)
            return EventBox.nothing(info)
        track = self._format_tracks.get(sample.media_format)
        cfg = sample.side_data().get("config")
        if track is None:
            fourcc = FORMAT_TO_FOURCC.get(sample.media_format)
            if fourcc is None:
                return EventBox.error(EventError("flavor", -2,
                                                 "unsupported format"))
            track = TrackInfo(
                fourcc=fourcc, stream_id=self.stream_id,
                track_id=self._next_track,
                time_base=_TIME_BASES.get(sample.media_type, 90000),
                uses_dts=sample.media_type == MediaType.video,
                extradata=cfg)
            self._next_track += 1
            self._format_tracks[sample.media_format] = track
            self.conn.write(self.core.send_tracks([track]))
        elif cfg and cfg != track.extradata:
            # the first sample of a format may carry no config (it often
            # rides only keyframes/sequence starts), and SPS/PPS can
            # change mid-stream: re-declare the track so subscribers
            # reconstruct samples with the CURRENT extradata instead of
            # a stale/empty one for the life of the session
            from dataclasses import replace as _dc_replace
            track = _dc_replace(track, extradata=cfg)
            self._format_tracks[sample.media_format] = track
            self.conn.write(self.core.send_tracks([track]))
        self.conn.write(self.core.media_bytes(sample, track))
        return EventBox.just(ResultEvent(sample.time(), sample.asset_id(),
                                         sample.workspace_id(), sample.info()))

    def close(self) -> None:
        try:
            self.conn.write(self.core.bye_bytes())
        except Exception:
            pass
        self.conn.close()


class FlavorSubscriber(Source):
    """Receive media pushed by a peer (net.flavor.swift:887-976)."""

    def __init__(self, conn: Connection, core: FlavorSessionCore):
        super().__init__()
        self.conn = conn
        self.core = core

    def asset_id(self) -> str:
        return self.core.asset_id

    def dispatch(self, samples: List[CodedMediaSample]) -> None:
        for s in samples:
            self.emit(s)

    def close(self) -> None:
        self.conn.close()


class Flavor:
    """Protocol facade (net.flavor.swift:23-208)."""

    def __init__(self, clock: Optional[Clock] = None,
                 on_push_request: Optional[Callable[[int, str], bool]] = None,
                 on_pull_request: Optional[Callable[[int, str], bool]] = None,
                 on_subscriber: Optional[Callable[["FlavorSubscriber"], None]]
                 = None,
                 on_publisher: Optional[Callable[["FlavorPublisher"], None]]
                 = None,
                 on_ended: Optional[Callable[[str], None]] = None):
        self.clock = clock or WallClock()
        self.on_push_request = on_push_request
        self.on_pull_request = on_pull_request
        self.on_subscriber = on_subscriber
        self.on_publisher = on_publisher
        self.on_ended = on_ended
        self._sessions: Dict[str, dict] = {}
        self._server: Optional[asyncio.AbstractServer] = None

    async def serve(self, host: str, port: int = DEFAULT_PORT,
                    reuse_port: bool = False) -> None:
        def connected(conn: Connection) -> None:
            core = FlavorSessionCore(is_server=True,
                                     asset_id=str(uuid.uuid4()),
                                     clock=self.clock,
                                     on_push_request=self.on_push_request,
                                     on_pull_request=self.on_pull_request)
            state = {"core": core, "conn": conn, "sub": None}
            self._sessions[conn.ident] = state

            def on_bytes(event: NetworkEvent) -> EventBox:
                out, samples = core.feed(event.data())
                if out:
                    conn.write(out)
                if core.peer_pushing and state["sub"] is None:
                    state["sub"] = FlavorSubscriber(conn, core)
                    if self.on_subscriber is not None:
                        self.on_subscriber(state["sub"])
                # a peer that pulled gets a server-side publisher
                # (net.flavor.swift:400-506 makePush counterpart)
                if (core.stream_tokens and not core.peer_pushing
                        and state.get("pub") is None):
                    stream_id = next(iter(core.stream_tokens))
                    state["pub"] = FlavorPublisher(conn, core, stream_id)
                    if self.on_publisher is not None:
                        self.on_publisher(state["pub"])
                if samples and state["sub"] is not None:
                    state["sub"].dispatch(samples)
                return EventBox.nothing(None)

            state["chain"] = conn >> Tx(on_bytes)
            conn.write(core.start_bytes())

        def ended(conn: Connection) -> None:
            state = self._sessions.pop(conn.ident, None)
            if state is not None and self.on_ended is not None:
                self.on_ended(state["core"].asset_id)

        self._server = await tcp_serve(host, port, connected, ended,
                                       reuse_port=reuse_port)

    async def close(self) -> None:
        if self._server is not None:
            self._server.close()
        for state in list(self._sessions.values()):
            state["conn"].close()

    async def connect(self, url: str, *, push: bool = True,
                      asset_id: Optional[str] = None,
                      timeout: float = 10.0):
        """Dial flavor://host[:port]/{token}; returns FlavorPublisher (push)
        or FlavorSubscriber (pull)."""
        parsed = urlparse(url)
        host = parsed.hostname or "localhost"
        port = parsed.port or DEFAULT_PORT
        token = parsed.path.lstrip("/")
        core = FlavorSessionCore(is_server=False,
                                 asset_id=asset_id or str(uuid.uuid4()),
                                 clock=self.clock)
        loop = asyncio.get_running_loop()
        done: asyncio.Future = loop.create_future()
        endpoint = {}
        stream_id = abs(hash(token)) % 0x7FFFFFFF or 1

        def ended(conn: Connection) -> None:
            if not done.done():
                done.set_exception(ConnectionError("closed"))
            if self.on_ended is not None:
                self.on_ended(core.asset_id)

        conn = await tcp_client(host, port, on_ended=ended)
        sent_request = {"done": False}

        def on_bytes(event: NetworkEvent) -> EventBox:
            out, samples = core.feed(event.data())
            if out:
                conn.write(out)
            if core.established and not sent_request["done"]:
                sent_request["done"] = True
                if push:
                    conn.write(core.request_push(stream_id, token))
                else:
                    conn.write(core.request_pull(stream_id, token))
            if core.errors and not done.done():
                done.set_exception(ConnectionError(core.errors[-1]))
                return EventBox.nothing(None)
            if not done.done():
                if push and core.push_granted:
                    endpoint["pub"] = FlavorPublisher(conn, core, stream_id)
                    done.set_result(True)
                elif not push and core.pull_granted:
                    endpoint["sub"] = FlavorSubscriber(conn, core)
                    done.set_result(True)
            sub = endpoint.get("sub")
            if samples and sub is not None:
                sub.dispatch(samples)
            return EventBox.nothing(None)

        # anchor the receive chain to the connection: emit chains are weak
        # and this helper's locals die on return (see Connection.retain)
        conn.retain(conn >> Tx(on_bytes))
        try:
            await asyncio.wait_for(done, timeout=timeout)
        except BaseException:
            conn.close()        # failed attempt: don't leak the socket
            raise
        return endpoint.get("pub") or endpoint.get("sub")
