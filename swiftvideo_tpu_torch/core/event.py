"""Events and the four-state result monad.

Reference semantics: ``/root/reference/Sources/SwiftVideo/event.swift``.

* ``Event`` — anything flowing through a graph: has a type tag, a TimePoint,
  an asset id, a workspace id, and optional ``EventInfo`` (a StatsReport that
  rides along with the event and accumulates metrics across stages;
  event.swift:33).
* ``EventBox`` — result of a transform application (event.swift:63-123):
  ``just(value)`` | ``error(err)`` | ``nothing(info)`` | ``gone``.
  ``nothing`` means "consumed, no output right now" (e.g. an encoder that
  buffers); ``gone`` means "this graph segment is dead, disconnect me".
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Generic, Optional, Protocol, TypeVar, runtime_checkable

from .time import TimePoint

T = TypeVar("T")
U = TypeVar("U")

# EventInfo is a StatsReport; typed as Any here to avoid an import cycle
# (stats.py imports event.py). See stats.py.
EventInfo = Any


@dataclass
class EventError(Exception):
    """Structured error carried by EventBox.error (event.swift:137-157 proto)."""

    source: str
    code: int
    desc: Optional[str] = None
    time: Optional[TimePoint] = None
    asset_id: Optional[str] = None

    def __str__(self) -> str:  # pragma: no cover - debug aid
        return f"EventError({self.source}, {self.code}, {self.desc})"


@runtime_checkable
class Event(Protocol):
    """Typed event protocol (event.swift:35-42)."""

    def type(self) -> str: ...
    def time(self) -> TimePoint: ...
    def asset_id(self) -> str: ...
    def workspace_id(self) -> str: ...
    def workspace_token(self) -> Optional[str]: ...
    def info(self) -> Optional[EventInfo]: ...


class EventBox(Generic[T]):
    """Four-state result monad (event.swift:63-123).

    States: JUST (payload), ERROR (EventError), NOTHING (optional EventInfo),
    GONE (disconnect marker).
    """

    __slots__ = ("_state", "_payload")

    JUST = 0
    ERROR = 1
    NOTHING = 2
    GONE = 3

    def __init__(self, state: int, payload: Any = None):
        self._state = state
        self._payload = payload

    # --- constructors ----------------------------------------------------
    @staticmethod
    def just(value: T) -> "EventBox[T]":
        return EventBox(EventBox.JUST, value)

    @staticmethod
    def error(err: EventError) -> "EventBox[T]":
        return EventBox(EventBox.ERROR, err)

    @staticmethod
    def nothing(info: Optional[EventInfo] = None) -> "EventBox[T]":
        return EventBox(EventBox.NOTHING, info)

    @staticmethod
    def gone() -> "EventBox[T]":
        return EventBox(EventBox.GONE)

    # --- accessors -------------------------------------------------------
    @property
    def state(self) -> int:
        return self._state

    def is_just(self) -> bool:
        return self._state == EventBox.JUST

    def is_error(self) -> bool:
        return self._state == EventBox.ERROR

    def is_nothing(self) -> bool:
        return self._state == EventBox.NOTHING

    def is_gone(self) -> bool:
        return self._state == EventBox.GONE

    def value(self) -> Optional[T]:
        return self._payload if self._state == EventBox.JUST else None

    def err(self) -> Optional[EventError]:
        return self._payload if self._state == EventBox.ERROR else None

    def info(self) -> Optional[EventInfo]:
        """EventInfo from a just-event (its info()) or a nothing marker."""
        if self._state == EventBox.JUST:
            getter = getattr(self._payload, "info", None)
            return getter() if callable(getter) else None
        if self._state == EventBox.NOTHING:
            return self._payload
        return None

    # --- monad ops (event.swift:87-123) ----------------------------------
    def map(self, fn: Callable[[T], U]) -> "EventBox[U]":
        if self._state == EventBox.JUST:
            return EventBox.just(fn(self._payload))
        return self  # type: ignore[return-value]

    def flat_map(self, fn: Callable[[T], "EventBox[U]"]) -> "EventBox[U]":
        if self._state == EventBox.JUST:
            return fn(self._payload)
        return self  # type: ignore[return-value]

    # bind operator spelling used by graph code
    __rshift__ = flat_map

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        names = {0: "just", 1: "error", 2: "nothing", 3: "gone"}
        return f"EventBox.{names[self._state]}({self._payload!r})"


@dataclass
class ResultEvent:
    """Terminal result of a pipeline (event.swift:137-157)."""

    time_point: TimePoint
    id_asset: str
    id_workspace: str = ""
    event_info: Optional[EventInfo] = None

    def type(self) -> str:
        return "result"

    def time(self) -> TimePoint:
        return self.time_point

    def asset_id(self) -> str:
        return self.id_asset

    def workspace_id(self) -> str:
        return self.id_workspace

    def workspace_token(self) -> Optional[str]:
        return None

    def info(self) -> Optional[EventInfo]:
        return self.event_info
