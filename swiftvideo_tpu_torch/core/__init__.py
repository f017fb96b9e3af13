"""Core runtime: rational time, clocks, events, graph algebra, stats."""

from .time import (TimePoint, clamp_time, from_seconds, fseconds, maximum,
                   minimum, rescale, seconds, simplify)
from .event import Event, EventBox, EventError, EventInfo, ResultEvent
from .clock import Clock, ClockTickEvent, StepClock, WallClock
from .bus import (AsyncTx, Bus, Digest, HeterogeneousBus, Source, Terminal,
                  Tx, asset_filter, mix, type_filter, K_FLICK)
from .stats import StatsReport, StatsResult

__all__ = [
    "TimePoint", "rescale", "simplify", "seconds", "fseconds", "from_seconds",
    "minimum", "maximum", "clamp_time",
    "Event", "EventBox", "EventError", "EventInfo", "ResultEvent",
    "Clock", "ClockTickEvent", "StepClock", "WallClock",
    "Tx", "AsyncTx", "Source", "Terminal", "Bus", "HeterogeneousBus",
    "Digest", "asset_filter", "mix", "type_filter", "K_FLICK",
    "StatsReport", "StatsResult",
]
