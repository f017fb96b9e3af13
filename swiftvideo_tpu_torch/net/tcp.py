"""TCP transport: connections as graph sources.

Reference semantics: ``Sources/SwiftVideo/net.tcp.swift`` —
``Connection`` is both a ``Source[NetworkEvent]`` (inbound bytes emitted
into the graph) and a writable sink (graph writes routed back to the
socket); ``tcp_serve`` / ``tcp_client`` bootstrap listeners and dials
(swift-nio there, asyncio here).  TLS via ``ssl`` contexts replaces
NIOSSL (tls_client, net.tcp.swift:202-220).
"""

from __future__ import annotations

import asyncio
import ssl as ssl_module
import threading
import uuid
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..core import EventBox, EventInfo, Source, TimePoint


@dataclass
class NetworkEvent:
    """Bytes event (net.tcp.swift:24-51)."""

    bytes_data: bytes
    id_asset: str = ""
    id_workspace: str = ""
    token: Optional[str] = None
    time_point: TimePoint = field(default_factory=lambda: TimePoint(0, 1000))
    event_info: Optional[EventInfo] = None

    def type(self) -> str:
        return "network"

    def time(self) -> TimePoint:
        return self.time_point

    def asset_id(self) -> str:
        return self.id_asset

    def workspace_id(self) -> str:
        return self.id_workspace

    def workspace_token(self) -> Optional[str]:
        return self.token

    def info(self) -> Optional[EventInfo]:
        return self.event_info

    def data(self) -> bytes:
        return self.bytes_data


class Connection(Source, asyncio.Protocol):
    """A socket endpoint in the graph (net.tcp.swift:53-145).

    Inbound: ``data_received`` emits NetworkEvents through the installed
    emit chain.  Outbound: applying a NetworkEvent to the connection (or
    calling ``write``) sends bytes.
    """

    def __init__(self, on_connected: Optional[Callable[["Connection"], None]] = None,
                 on_ended: Optional[Callable[["Connection"], None]] = None):
        super().__init__(self._digest)
        self.ident = str(uuid.uuid4())
        self.transport: Optional[asyncio.Transport] = None
        self._on_connected = on_connected
        self._on_ended = on_ended
        self.closed = False
        self.writable = True  # cleared between pause_writing/resume_writing
        self._retained: list = []
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._loop_tid: Optional[int] = None

    def _digest(self, event: NetworkEvent) -> EventBox:
        self.write(event.data())
        return EventBox.just(event)

    # --- asyncio.Protocol -------------------------------------------------
    def connection_made(self, transport) -> None:
        self.transport = transport
        self._loop = asyncio.get_running_loop()
        self._loop_tid = threading.get_ident()
        if self._on_connected is not None:
            self._on_connected(self)

    def data_received(self, data: bytes) -> None:
        self.emit(NetworkEvent(bytes_data=data, id_asset=self.ident))

    def connection_lost(self, exc) -> None:
        self.closed = True
        if self._on_ended is not None:
            self._on_ended(self)

    def pause_writing(self) -> None:
        # kernel send buffer full: the slow-client signal (the reference's
        # NIO BackPressureHandler role, net.tcp.swift:157)
        self.writable = False

    def resume_writing(self) -> None:
        self.writable = True

    def retain(self, obj) -> None:
        """Anchor ``obj`` (typically the receive chain built with ``>>``)
        to this connection's lifetime.  Bus emit chains are weak by design
        (gone-propagation GC, signal.swift:37-58); a chain whose only strong
        reference is a connect-helper local would be severed at the next
        gc pass, silently stopping delivery."""
        self._retained.append(obj)

    # --- writes -----------------------------------------------------------
    def write(self, data: bytes) -> None:
        """Thread-aware: asyncio transports are not thread-safe, and
        producers write from off-loop threads (WallClock's scheduler
        fires mixer/metadata emits) — those writes marshal onto the loop.
        Per-chunk-stream wire ordering holds because each csid has a
        single writer thread (commands on the loop thread, one producer
        per media csid)."""
        if self.transport is None or self.closed or not data:
            return
        if self._loop is None or threading.get_ident() == self._loop_tid:
            self.transport.write(data)
        else:
            self._loop.call_soon_threadsafe(self._write_on_loop, data)

    def _write_on_loop(self, data: bytes) -> None:
        if self.transport is not None and not self.closed:
            self.transport.write(data)

    def close(self) -> None:
        self.closed = True
        if self.transport is not None:
            if self._loop is None or threading.get_ident() == self._loop_tid:
                self.transport.close()
            else:
                self._loop.call_soon_threadsafe(self.transport.close)


async def tcp_serve(host: str, port: int,
                    on_connection: Callable[[Connection], None],
                    on_ended: Optional[Callable[[Connection], None]] = None,
                    reuse_port: bool = False) -> asyncio.AbstractServer:
    """Listen and hand each accepted Connection to the app
    (net.tcp.swift:147-183).

    ``reuse_port``: SO_REUSEPORT socket sharding — N worker processes
    each serve() the same port and the kernel spreads incoming
    connections across them.  This is the scale-out shape for ingest:
    one asyncio loop runs on one core (GIL), where the reference leans on
    SwiftNIO's multi-threaded EventLoopGroup (net.tcp.swift:147-156)."""
    loop = asyncio.get_running_loop()
    return await loop.create_server(
        lambda: Connection(on_connected=on_connection, on_ended=on_ended),
        host, port, reuse_port=reuse_port or None)


async def tcp_client(host: str, port: int,
                     on_ended: Optional[Callable[[Connection], None]] = None
                     ) -> Connection:
    """Dial out (net.tcp.swift:185-200)."""
    loop = asyncio.get_running_loop()
    _, protocol = await loop.create_connection(
        lambda: Connection(on_ended=on_ended), host, port)
    return protocol


async def tls_client(host: str, port: int,
                     ssl_context: Optional[ssl_module.SSLContext] = None,
                     on_ended: Optional[Callable[[Connection], None]] = None
                     ) -> Connection:
    """TLS dial (net.tcp.swift:202-220)."""
    ctx = ssl_context or ssl_module.create_default_context()
    loop = asyncio.get_running_loop()
    _, protocol = await loop.create_connection(
        lambda: Connection(on_ended=on_ended), host, port, ssl=ctx)
    return protocol
