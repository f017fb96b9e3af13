"""RTMP facade: serve / connect, publishers and subscribers.

Reference semantics: ``Sources/SwiftVideo/rtmp/rtmp.swift``:

* ``Rtmp.serve`` accepts connections, runs the server handshake + command
  FSM, and on ``started`` builds an ``RtmpPublisher`` (peer plays — we
  send) or ``RtmpSubscriber`` (peer publishes — we receive), asks the
  app's permission hook, and on success sends NetStream.*.Start
  (rtmp.swift:181-307).
* ``Rtmp.connect`` dials with a **reconnect loop** (attempts < 30, ~10 s
  backoff; rtmp.swift:104-153).
* ``RtmpPublisher`` is a ``Terminal[CodedMediaSample]``: collects media
  descriptions, sends onMetaData once both are known or after a 200 ms
  grace timer, then streams config-gated FLV tags (rtmp.swift:322-477).
* ``RtmpSubscriber`` is a ``Source[CodedMediaSample]`` emitting parsed
  samples with per-format byte counters (rtmp.swift:478-533).
"""

from __future__ import annotations

import asyncio
import uuid
from typing import Awaitable, Callable, Dict, List, Optional

from ...core import (Clock, EventBox, EventError, ResultEvent, Source,
                     StatsReport, Terminal, TimePoint, Tx, WallClock)
from ...media.coded import (CodedMediaSample, MediaFormat,
                            MediaSourceType, MediaType,
                            basic_media_description)
from ..tcp import Connection, NetworkEvent, tcp_client, tcp_serve
from .media import MediaSerializer, create_metadata
from .session import RtmpSessionCore, parse_rtmp_url

# permission hook: (publisher?, subscriber?) -> awaitable[bool]
LiveOnConnection = Callable[[Optional["RtmpPublisher"],
                             Optional["RtmpSubscriber"]], Awaitable[bool]]
LiveOnEnded = Callable[[str], None]


class RtmpPublisher(Terminal):
    """Send media to a peer that is playing (rtmp.swift:322-477)."""

    def __init__(self, clock: Clock, conn: Connection,
                 core: RtmpSessionCore, ident: Optional[str] = None):
        self.clock = clock
        self.conn = conn
        self.core = core
        self.ident = ident or str(uuid.uuid4())
        self._props: List = []
        self._prop_formats: Dict[MediaType, MediaFormat] = {}
        self._sent_props = False
        self._media = MediaSerializer(core.serializer,
                                      core.ctx.msg_stream_id)
        super().__init__(self._handle)
        clock.schedule(clock.current() + TimePoint(200, 1000),
                       lambda _evt: self._send_metadata())

    # --- LivePublisher surface (live.swift:20-36) -------------------------
    def asset_id(self) -> str:
        return self.core.ctx.asset_id

    def workspace_id(self) -> str:
        return self.core.ctx.workspace_id or self.core.ctx.app or ""

    def play_path(self) -> Optional[str]:
        return self.core.ctx.play_path

    def uri(self) -> Optional[str]:
        return self.core.ctx.url

    def uuid(self) -> str:
        return self.ident

    def live_type(self) -> MediaSourceType:
        return MediaSourceType.rtmp

    def accepted_formats(self) -> List[MediaFormat]:
        # avc/aac via legacy FLV tags; the rest via E-RTMP ex-headers
        return [MediaFormat.avc, MediaFormat.aac, MediaFormat.hevc,
                MediaFormat.vp9, MediaFormat.av1, MediaFormat.opus]

    def dialed_out(self) -> bool:
        return self.core.ctx.dialed_out

    # --- media path -------------------------------------------------------
    def _handle(self, sample: CodedMediaSample) -> EventBox:
        if not self._sent_props:
            # collect descriptions; send metadata once both known
            # (rtmp.swift:406-433)
            have = any(
                (sample.media_type == MediaType.video and hasattr(p, "size"))
                or (sample.media_type == MediaType.audio and
                    hasattr(p, "sample_rate"))
                for p in self._props)
            if not have:
                try:
                    self._props.append(basic_media_description(sample))
                    self._prop_formats[sample.media_type] = \
                        sample.media_format
                except Exception as err:  # garbage config: skip, let the
                    # 200 ms grace timer send whatever metadata we have
                    return EventBox.error(EventError(
                        "rtmp.mediaDescription", -1, str(err)))
            if len(self._props) > 1:
                self._send_metadata()
            else:
                return EventBox.nothing(sample.info())
        # backpressure: a slow client keeps its codec config flowing but
        # drops media frames rather than buffering unboundedly (live
        # semantics; the reference's bufferSize knob)
        if not getattr(self.conn, "writable", True):
            info = sample.info()
            if info is not None:
                info.add_sample("net.rtmp.dropped", 1)
            return EventBox.nothing(info)
        data = self._media.serialize(sample)
        if data is None:
            return EventBox.nothing(sample.info())
        info = sample.info()
        if info is not None:
            info.add_sample("net.rtmp.write", len(data))
        self.conn.write(data)
        return EventBox.just(ResultEvent(sample.time(), sample.asset_id(),
                                         sample.workspace_id(), info))

    def _send_metadata(self) -> None:
        if self._sent_props:
            return
        self._sent_props = True
        data = create_metadata(
            self._props, self.core.serializer, self.core.ctx.msg_stream_id,
            video_format=self._prop_formats.get(MediaType.video),
            audio_format=self._prop_formats.get(MediaType.audio))
        self.conn.write(data)

    def close(self) -> None:
        try:
            self.conn.write(self.core.unpublish_bytes())
        except Exception:
            pass
        self.conn.close()


class RtmpSubscriber(Source):
    """Receive media from a publishing peer (rtmp.swift:478-533)."""

    def __init__(self, clock: Clock, conn: Connection,
                 core: RtmpSessionCore):
        super().__init__()
        self.clock = clock
        self.conn = conn
        self.core = core
        self.stats = StatsReport(asset_id=core.ctx.asset_id, clock=clock)

    def asset_id(self) -> str:
        return self.core.ctx.asset_id

    def workspace_id(self) -> str:
        return self.core.ctx.workspace_id or self.core.ctx.app or ""

    def play_path(self) -> Optional[str]:
        return self.core.ctx.play_path

    def live_type(self) -> MediaSourceType:
        return MediaSourceType.rtmp

    def dispatch(self, samples: List[CodedMediaSample]) -> None:
        for sample in samples:
            self.stats.add_sample(
                f"rtmp.{sample.media_format.name}.recv", len(sample.data()))
            self.emit(sample.with_(event_info=self.stats))

    def close(self) -> None:
        self.stats.close()
        self.conn.close()


class Rtmp:
    """Protocol facade (rtmp.swift:40-320)."""

    def __init__(self, clock: Optional[Clock] = None,
                 on_ended: Optional[LiveOnEnded] = None,
                 on_connection: Optional[LiveOnConnection] = None):
        self.clock = clock or WallClock()
        self.on_ended = on_ended
        self.on_connection = on_connection
        self._sessions = {}
        self._server: Optional[asyncio.AbstractServer] = None

    # --- server (rtmp.swift:181-307) --------------------------------------
    async def serve(self, host: str, port: int,
                    reuse_port: bool = False) -> None:
        def connected(conn: Connection) -> None:
            core = RtmpSessionCore(is_server=True,
                                   asset_id=str(uuid.uuid4()),
                                   clock=self.clock)
            state = {"core": core, "endpoint": None, "conn": conn}
            self._sessions[conn.ident] = state

            def on_bytes(event: NetworkEvent) -> EventBox:
                out, samples = core.feed(event.data())
                if out:
                    conn.write(out)
                if core.fatal:
                    # unrecoverable byte-stream desync: drop the client
                    conn.close()
                    return EventBox.nothing(None)
                endpoint = state["endpoint"]
                if (endpoint is None and core.started
                        and not state.get("establishing")):
                    # flag SYNCHRONOUSLY: more bytes can arrive before the
                    # task runs, and each would otherwise spawn another
                    # _establish (duplicate endpoints + permission hooks +
                    # NetStream.Start writes, media lost to the last one)
                    state["establishing"] = True
                    asyncio.get_running_loop().create_task(
                        self._establish(conn, core, state))
                if samples and isinstance(state["endpoint"], RtmpSubscriber):
                    state["endpoint"].dispatch(samples)
                elif samples and state["endpoint"] is None:
                    # buffer only while the endpoint is being established
                    # (permission hook awaiting); bounded — a hook that
                    # never resolves must not let a publisher OOM the
                    # server
                    pend = state.setdefault("pending", [])
                    pend.extend(samples)
                    if len(pend) > 4096:
                        conn.close()
                # else: endpoint is a publisher (peer plays) — media from
                # the peer on a play session is a protocol violation; drop
                return EventBox.nothing(None)

            chain = conn >> Tx(on_bytes)
            state["chain"] = chain

        def ended(conn: Connection) -> None:
            state = self._sessions.pop(conn.ident, None)
            if state is not None and self.on_ended is not None:
                self.on_ended(state["core"].ctx.asset_id)

        self._server = await tcp_serve(host, port, connected, ended,
                                       reuse_port=reuse_port)

    async def _establish(self, conn, core, state) -> None:
        try:
            if core.ctx.publish_to_peer:
                endpoint = RtmpPublisher(self.clock, conn, core)
                pub, sub = endpoint, None
            else:
                endpoint = RtmpSubscriber(self.clock, conn, core)
                pub, sub = None, endpoint
            # state["endpoint"] stays None until the permission hook
            # approves: samples arriving while the hook awaits keep
            # buffering into state["pending"], so (a) nothing is
            # dispatched for a connection the hook may reject, and (b)
            # the pending flush below cannot be overtaken by newer
            # samples (config/keyframe after later frames)
            allowed = True
            if self.on_connection is not None:
                allowed = await self.on_connection(pub, sub)
            if not allowed:
                state.pop("pending", None)
                conn.close()
                return
            conn.write(core.publish_start_bytes())
            if sub is not None and state.get("pending"):
                sub.dispatch(state.pop("pending"))
            state["endpoint"] = endpoint
        except Exception:
            # a raising permission hook (or endpoint construction) must
            # not leave the session half-established forever: pending
            # would grow unboundedly and the peer would hang on a
            # NetStream.Start that never comes
            state.pop("pending", None)
            conn.close()
            raise

    async def close(self) -> None:
        if self._server is not None:
            self._server.close()
        for state in list(self._sessions.values()):
            conn = state.get("conn")
            if conn is not None:
                conn.close()
        if self._server is not None:
            try:
                await asyncio.wait_for(self._server.wait_closed(), timeout=2.0)
            except (asyncio.TimeoutError, asyncio.CancelledError):
                pass

    # --- client (rtmp.swift:104-153) --------------------------------------
    async def connect(self, url: str, publish_to_peer: bool = True,
                      asset_id: Optional[str] = None,
                      max_attempts: int = 30,
                      retry_delay: float = 10.0):
        """Dial and complete the handshake; returns (publisher, subscriber)
        — publisher when ``publish_to_peer`` (we send media), subscriber
        otherwise (client play; completed here, reference TODO).
        Reconnects with backoff on failure."""
        host, port, app, play_path, tc_url = parse_rtmp_url(url)
        attempt = 0
        last_error: Optional[Exception] = None
        while attempt < max_attempts:
            attempt += 1
            try:
                return await self._connect_once(
                    host, port, app, play_path, tc_url, url,
                    publish_to_peer, asset_id or str(uuid.uuid4()))
            except Exception as exc:  # noqa: BLE001 - reconnect loop
                last_error = exc
                if attempt < max_attempts:
                    await asyncio.sleep(retry_delay)
        raise ConnectionError(f"rtmp connect failed after {attempt} attempts"
                              ) from last_error

    async def _connect_once(self, host, port, app, play_path, tc_url, url,
                            publish_to_peer, asset_id):
        done: asyncio.Future = asyncio.get_running_loop().create_future()
        core = RtmpSessionCore(is_server=False, asset_id=asset_id,
                               clock=self.clock, app=app, tc_url=tc_url,
                               play_path=play_path, url=url,
                               publish_to_peer=publish_to_peer)
        endpoint_box = {}

        def ended(conn: Connection) -> None:
            if not done.done():
                done.set_exception(ConnectionError("connection closed"))
            if self.on_ended is not None:
                self.on_ended(asset_id)

        conn = await tcp_client(host, port, on_ended=ended)

        def on_bytes(event: NetworkEvent) -> EventBox:
            out, samples = core.feed(event.data())
            if out:
                conn.write(out)
            if core.fatal:
                conn.close()
            if core.errors and not done.done():
                done.set_exception(ConnectionError(core.errors[-1]))
                return EventBox.nothing(None)
            if core.started and not done.done():
                if publish_to_peer:
                    endpoint_box["pub"] = RtmpPublisher(self.clock, conn, core)
                else:
                    endpoint_box["sub"] = RtmpSubscriber(self.clock, conn, core)
                done.set_result(True)
            sub = endpoint_box.get("sub")
            if samples and sub is not None:
                sub.dispatch(samples)
            return EventBox.nothing(None)

        # the receive chain must outlive this helper: emit chains are weak,
        # so anchor it to the connection (see Connection.retain)
        conn.retain(conn >> Tx(on_bytes))
        try:
            conn.write(core.start_bytes())
            await asyncio.wait_for(done, timeout=30.0)
        except BaseException:
            # a failed/timed-out attempt must not leak the socket (the
            # reconnect loop makes up to 30 of them) or its retained chain
            conn.close()
            raise
        return endpoint_box.get("pub"), endpoint_box.get("sub")
