"""Network protocols: TCP transport, RTMP, flavor, live asset surface."""

from .tcp import Connection, NetworkEvent, tcp_client, tcp_serve, tls_client
from .live import (LiveAsset, LiveOnConnection, LiveOnEnded, LivePublisher,
                   LiveSubscriber, RpcError)
from . import rtmp
from . import flavor

__all__ = ["Connection", "NetworkEvent", "tcp_serve", "tcp_client",
           "tls_client", "rtmp", "flavor",
           "LiveAsset", "LivePublisher", "LiveSubscriber", "RpcError",
           "LiveOnConnection", "LiveOnEnded"]
