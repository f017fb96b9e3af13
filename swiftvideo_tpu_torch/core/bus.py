"""Graph algebra: transforms, async sources, and event buses.

Reference semantics: ``/root/reference/Sources/SwiftVideo/bus.swift``.

Every processing element is a ``Tx`` — a function ``(T) -> EventBox[U]``.
Graphs are built by composition:

=============== ======================= =====================================
reference       here                    meaning
=============== ======================= =====================================
``a >>> b``     ``a >> b``              sequential compose (bus.swift:304-359)
``a |>> b``     ``a.each(b)``           map b over a's list output (:326-340)
``bus <<| tx``  ``bus.subscribe(tx)``   register tx as observer (:365-373)
``box >>- tx``  ``tx.apply(box)``       bind an EventBox into a tx (:296-302)
``tx <<| v``    ``tx(v)``               feed a raw value
=============== ======================= =====================================

``AsyncTx`` elements additionally *push*: composing ``async_tx >> next``
installs ``next`` as the async element's emit chain (bus.swift:239-259), so a
clock-driven mixer or a socket can inject events downstream.  Emit chains hold
weak references; when a downstream segment is garbage collected or returns
``gone``, the chain yields ``gone`` and the producer can disconnect
(self-healing graphs, bus.swift:146-147).

``Bus`` is a multi-producer multi-consumer dispatcher.  The reference fans
out over a pool of serial DispatchQueues; here dispatch is synchronous by
default (deterministic — the right choice under the GIL) with optional
granularity-based batching against the bus clock.
"""

from __future__ import annotations

import threading
import uuid
import weakref
from typing import Any, Callable, Generic, List, Optional, Tuple, TypeVar

from .clock import Clock, WallClock
from .event import Event, EventBox, EventInfo, ResultEvent
from .time import TimePoint, rescale

T = TypeVar("T")
U = TypeVar("U")
V = TypeVar("V")

K_FLICK = 100000  # bus.swift:23 — granularity tick scale


class Tx(Generic[T, U]):
    """A transform ``(T) -> EventBox[U]`` (bus.swift:215-221)."""

    def __init__(self, fn: Optional[Callable[[T], EventBox[U]]] = None):
        self._fn = fn

    def set(self, fn: Callable[[T], EventBox[U]]) -> None:
        self._fn = fn

    # --- application -----------------------------------------------------
    def apply(self, box: EventBox[T]) -> EventBox[U]:
        """``box >>- self`` (bus.swift:223-236)."""
        if box.is_just():
            if self._fn is None:
                return EventBox.nothing(box.info())
            return self._fn(box.value())
        return box  # error / nothing / gone pass through

    def __call__(self, value: T) -> EventBox[U]:
        return self.apply(EventBox.just(value))

    # --- composition -----------------------------------------------------
    def __rshift__(self, right: Any) -> "Tx":
        """``self >> right`` — sequential composition (bus.swift:304-359)."""
        if isinstance(right, Bus):
            return _compose_into_bus(self, right)
        return _compose(self, right)

    def each(self, right: Any) -> "Tx":
        """``self.each(right)`` — ``|>>``: map over list output (bus.swift:326-340)."""
        if isinstance(right, Bus):
            bus = right

            def run_bus(value: T) -> EventBox[ResultEvent]:
                res = self(value)
                if not res.is_just():
                    return res
                out = [bus.append(EventBox.just(v)) for v in res.value()]
                out = [b for b in out if b.is_just()]
                return out[-1] if out else EventBox.nothing(None)

            return Tx(run_bus)

        right_tx = right

        def run(value: T) -> EventBox[List[V]]:
            res = self(value)
            if not res.is_just():
                return res
            produced = [right_tx(v) for v in res.value()]
            if produced and all(b.is_gone() for b in produced):
                # beyond reference: |>> compactMaps non-just results away
                # (bus.swift:326-333), so a producer mapping into a dead
                # segment never learns it died and pushes forever.  A
                # fully-gone map propagates gone so the producer
                # disconnects; mixed results keep the reference's
                # drop-the-failures semantics.
                return EventBox.gone()
            return EventBox.just([b.value() for b in produced if b.is_just()])

        return Tx(run)


class AsyncTx(Tx[T, U]):
    """A transform that can also *push* via an installed emit chain
    (bus.swift:239-259).  Default digest fn: pass-through type check."""

    def __init__(self, fn: Optional[Callable[[T], EventBox[U]]] = None):
        super().__init__(fn if fn is not None else lambda v: EventBox.just(v))
        self._fn_emit: Optional[Callable[[U], EventBox[Event]]] = None
        self._fn_digest: Optional[Callable[[List[EventBox[Event]]], None]] = None

    def set_emit_fn(self, fn: Callable[[U], EventBox[Event]]) -> None:
        self._fn_emit = fn

    def emit(self, value: U) -> EventBox[Event]:
        if self._fn_emit is None:
            return EventBox.gone()
        result = self._fn_emit(value)
        if self._fn_digest is not None:
            self._fn_digest([result])
        return result

    def set_digest_receiver(self, fn: Callable[[List[EventBox[Event]]], None]) -> None:
        self._fn_digest = fn


class Source(AsyncTx[U, U]):
    """An event producer: ``Source[U] = AsyncTx[U, U]`` (bus.swift:261)."""


Terminal = Tx  # Terminal[T] = Tx[T, ResultEvent] (bus.swift:263)


# --- stock filters (bus.swift:265-293) -----------------------------------

def type_filter(cls: type) -> Tx:
    """``filter<U>()`` — pass only events of a given type, downcasting."""
    return Tx(lambda v: EventBox.just(v) if isinstance(v, cls)
              else EventBox.nothing(v.info() if isinstance(v, Event) else None))


def asset_filter(asset_id: str) -> Tx:
    return Tx(lambda v: EventBox.just(v) if v.asset_id() == asset_id
              else EventBox.nothing(v.info()))


def mix() -> Tx:
    """Upcast to Event (bus.swift:289-293) — identity in Python."""
    return Tx(lambda v: EventBox.just(v))


# --- composition internals ------------------------------------------------

def _async_pairs(tx: Tx) -> List[Tuple["AsyncTx", Optional[Tx]]]:
    """Every async element inside ``tx`` paired with its downstream tail
    (None when nothing follows it within ``tx``).

    The reference's ``>>>`` is right-associative, so
    ``src >>> a >>> repeater >>> b >>> bus`` naturally installs the full
    downstream chain as every async element's emit fn (bus.swift:289-324).
    Python's ``>>`` is left-associative, so composed transforms track all
    their async roots and re-install longer emit chains on every further
    composition — including async elements appearing mid-chain (Repeater).
    """
    if isinstance(tx, AsyncTx):
        return [(tx, None)]
    pairs = []
    for root_ref, tail in getattr(tx, "_async_pairs", ()):
        root = root_ref()
        if root is not None:
            pairs.append((root, tail))
    return pairs


def _install_emits(composed: Tx,
                   pairs: List[Tuple["AsyncTx", Optional[Tx]]]) -> None:
    stored = []
    txn_ref = weakref.ref(composed)
    for root, tail in pairs:
        stored.append((weakref.ref(root), tail))
        if tail is None:
            continue
        tail_ref = weakref.ref(tail)

        def emit_chain(value: Any, _tail_ref=tail_ref) -> EventBox[Event]:
            t = _tail_ref()
            if t is None or txn_ref() is None:
                return EventBox.gone()
            return t(value)

        root.set_emit_fn(emit_chain)
    composed._async_pairs = stored  # type: ignore[attr-defined]


def _extend(tail: Optional[Tx], nxt: Tx) -> Tx:
    if tail is None:
        return nxt
    prev = tail
    return Tx(lambda v: nxt.apply(prev(v)))


def _compose(left: Tx, right: Tx) -> Tx:
    composed = Tx(lambda v: right.apply(left(v)))
    pairs = [(root, _extend(tail, right)) for root, tail in _async_pairs(left)]
    pairs += _async_pairs(right)
    if pairs:
        _install_emits(composed, pairs)
    return composed


def _compose_into_bus(left: Tx, bus: "Bus") -> Tx:
    composed = Tx(lambda v: bus.append(left(v)))
    bus_ref = weakref.ref(bus)

    def into_bus_tx(tail: Optional[Tx]) -> Tx:
        def run(value: Any) -> EventBox[Event]:
            b = bus_ref()
            if b is None:
                return EventBox.gone()
            box = tail(value) if tail is not None else EventBox.just(value)
            return b.append(box)
        return Tx(run)

    pairs = [(root, into_bus_tx(tail)) for root, tail in _async_pairs(left)]
    if pairs:
        _install_emits(composed, pairs)
    return composed


# --- Digest event (bus.swift:166-211) ------------------------------------

class Digest:
    """Bundle of events produced by one bus dispatch round."""

    def __init__(self, events: List[Optional[Event]], time: TimePoint):
        self.events = events
        self.time_point = time

    def type(self) -> str:
        return "digest"

    def asset_id(self) -> str:
        return "bus"

    def workspace_id(self) -> str:
        return "bus"

    def workspace_token(self) -> Optional[str]:
        return None

    def time(self) -> TimePoint:
        return self.time_point

    def info(self) -> Optional[EventInfo]:
        acc = None
        for e in self.events:
            i = e.info() if e is not None else None
            if i is None:
                continue
            acc = i if acc is None else acc.merging(i)
        return acc


# --- Bus ------------------------------------------------------------------

class Bus(Generic[T]):
    """Multi-producer multi-consumer event dispatcher (bus.swift:25-163).

    Observers are ``(T) -> EventBox[Event]`` callables.  ``append`` enqueues
    an event and fires observers (immediately, or batched when a granularity
    is set).  Observers returning ``gone`` are removed — this is how dead
    graph segments garbage-collect themselves.
    """

    def __init__(self, clock: Optional[Clock] = None, ident: Optional[str] = None):
        self._clock: Clock = clock if clock is not None else WallClock()
        self._ident = ident or str(uuid.uuid4())
        self._observers: List[Tuple[Callable[[T], EventBox[Event]], str]] = []
        self._events: List[EventBox[T]] = []
        self._granularity = TimePoint(0, K_FLICK)
        self._lastapply = TimePoint(0, K_FLICK)
        self._fn_digest: Optional[Callable[[List[EventBox[Event]]], None]] = None
        self._lock = threading.RLock()
        self._flush_scheduled = False
        self.events_in = 0
        self.events_out = 0

    def get_clock(self) -> Clock:
        return self._clock

    def add_observer(self, obs: Callable[[T], EventBox[Event]]) -> str:
        ident = str(uuid.uuid4())
        with self._lock:
            self._observers.append((obs, ident))
        return ident

    def remove_observer(self, ident: str) -> None:
        with self._lock:
            self._observers = [o for o in self._observers if o[1] != ident]

    def subscribe(self, tx: Tx[T, V]) -> Tx[T, V]:
        """``bus <<| tx`` (bus.swift:365-373): register tx as observer,
        holding it weakly so a dropped tx auto-unsubscribes via ``gone``."""
        tx_ref = weakref.ref(tx)

        def observer(value: T) -> EventBox[Event]:
            strong = tx_ref()
            if strong is None:
                return EventBox.gone()
            return strong(value)

        self.add_observer(observer)
        return tx

    def append(self, box: EventBox[T]) -> EventBox[ResultEvent]:
        """Enqueue an event box; dispatch if granularity window has elapsed
        (bus.swift:81-109)."""
        fire = False
        flush_at = None
        with self._lock:
            self._events.append(box)
            self.events_in += 1
            now = self._clock.current()
            if (now - self._lastapply) >= self._granularity:
                self._lastapply = now
                fire = True
            elif not self._flush_scheduled:
                # beyond reference: bus.swift:81-109 only flushes on a
                # LATER append, so a burst's tail stalls in the queue
                # forever if the producer goes quiet (end of file, scene
                # hold).  Schedule a clock flush at the window boundary.
                self._flush_scheduled = True
                flush_at = self._lastapply + self._granularity
        if fire:
            self.fire_bus_events()
        elif flush_at is not None:
            self._clock.schedule(flush_at, self._flush_window)

        def digest(sample: T) -> EventBox[ResultEvent]:
            info = sample.info() if isinstance(sample, Event) else None
            return EventBox.nothing(info)

        return box.flat_map(digest)

    def _flush_window(self, _evt) -> None:
        """Clock-scheduled tail flush for granularity batching (see
        append); re-arms itself if an intervening append reset the
        window."""
        flush_at = None
        with self._lock:
            self._flush_scheduled = False
            if not self._events:
                return
            now = self._clock.current()
            if (now - self._lastapply) >= self._granularity:
                self._lastapply = now
            else:
                self._flush_scheduled = True
                flush_at = self._lastapply + self._granularity
        if flush_at is not None:
            self._clock.schedule(flush_at, self._flush_window)
            return
        self.fire_bus_events()

    def fire_bus_events(self) -> None:
        """Dispatch all queued events to all observers (bus.swift:111-154)."""
        with self._lock:
            evts = self._events
            self._events = []
            observers = list(self._observers)
            # counted under the lock (the reference counts the dequeued
            # batch, bus.swift:120); a per-event unlocked increment lost
            # counts under multi-producer appends
            self.events_out += len(evts)
        if not evts or not observers:
            return
        results: List[Tuple[EventBox[Event], str]] = []
        for box in evts:
            for fn, ident in observers:
                results.append((box.flat_map(fn) if box.is_just() else box, ident))
        gone = {ident for res, ident in results if res.is_gone()}
        if gone:
            with self._lock:
                self._observers = [o for o in self._observers if o[1] not in gone]
        if self._fn_digest is not None:
            self._fn_digest([res for res, _ in results])

    def set_digest_receiver(self, fn: Callable[[List[EventBox[Event]]], None]) -> None:
        self._fn_digest = fn

    def set_granularity(self, val: TimePoint) -> None:
        self._granularity = rescale(val, K_FLICK)


HeterogeneousBus = Bus  # Bus[Event] (bus.swift:165)
