"""Live asset protocols.

Reference semantics: ``Sources/SwiftVideo/live.swift:20-39``
and ``rpc/public.rpc.swift:17-42``: the abstract surface apps program
against regardless of wire protocol (RTMP or flavor) — asset identity,
publisher/subscriber roles, the permission hook, and the structured RPC
error type.
"""

from __future__ import annotations

from enum import Enum
from typing import Awaitable, Callable, List, Optional, Protocol, runtime_checkable

from ..media.coded import MediaFormat, MediaSourceType


class RpcError(Enum):
    """rpc/public.rpc.swift:17-42"""

    permission_denied = "permissionDenied"
    invalid_configuration = "invalidConfiguration"
    malformed = "malformed"
    gone = "gone"
    timed_out = "timedOut"
    unknown = "unknown"


@runtime_checkable
class LiveAsset(Protocol):
    """live.swift:20-27"""

    def asset_id(self) -> str: ...
    def workspace_id(self) -> str: ...
    def live_type(self) -> MediaSourceType: ...


@runtime_checkable
class LivePublisher(LiveAsset, Protocol):
    """live.swift:29-32 — an endpoint we send media to."""

    def accepted_formats(self) -> List[MediaFormat]: ...


@runtime_checkable
class LiveSubscriber(LiveAsset, Protocol):
    """live.swift:34-36 — an endpoint we receive media from."""


# Permission hook: (publisher?, subscriber?) -> awaitable[bool]
# (live.swift:38 LiveOnConnection); LiveOnEnded notifies asset teardown.
LiveOnConnection = Callable[[Optional[LivePublisher], Optional[LiveSubscriber]],
                            Awaitable[bool]]
LiveOnEnded = Callable[[str], None]
