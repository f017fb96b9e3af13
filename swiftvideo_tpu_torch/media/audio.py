"""AudioSample: immutable audio buffer value.

Reference semantics: ``/root/reference/Sources/SwiftVideo/sample.audio.swift``
(AudioFormat :24-35, AudioSample :105-214).

Buffers are numpy arrays of raw sample dtype: interleaved formats use one
buffer shaped ``[samples * channels]``; planar formats use one buffer per
channel shaped ``[samples]``.  A 3x3 transform encodes (position, gain) for
spatial mixing (sample.audio.swift:167-169; decoded by
utils.matrix.audio_position_gain).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Optional, Sequence, Tuple

import numpy as np

from ..core import EventInfo, TimePoint
from ..utils import matrix as m4


class AudioFormat:
    invalid = "invalid"
    s16i = "s16i"
    s16p = "s16p"
    f32i = "f32i"
    f32p = "f32p"
    f64i = "f64i"
    f64p = "f64p"
    # 64-bit accumulator formats (sample.audio.swift:33-34)
    s64i = "s64i"
    s64p = "s64p"


_DTYPES = {
    AudioFormat.s16i: np.int16, AudioFormat.s16p: np.int16,
    AudioFormat.f32i: np.float32, AudioFormat.f32p: np.float32,
    AudioFormat.f64i: np.float64, AudioFormat.f64p: np.float64,
    AudioFormat.s64i: np.int64, AudioFormat.s64p: np.int64,
}


def is_planar(fmt: str) -> bool:
    return fmt.endswith("p")


def dtype_for_format(fmt: str) -> np.dtype:
    return np.dtype(_DTYPES[fmt])


def number_of_buffers(fmt: str, channels: int) -> int:
    """sample.audio.swift:183-190"""
    return channels if is_planar(fmt) else 1


def bytes_per_sample(fmt: str, channels: int) -> int:
    """Bytes per sample *period* in one buffer (sample.audio.swift:192-205):
    interleaved counts all channels, planar counts one."""
    unit = dtype_for_format(fmt).itemsize
    return unit * (1 if is_planar(fmt) else channels)


@dataclass(frozen=True)
class AudioSample:
    """Immutable audio event (sample.audio.swift:105-214)."""

    buffers: Tuple[Any, ...]
    frequency: int
    channels: int
    format: str
    sample_count: int
    time_point: TimePoint = field(default_factory=lambda: TimePoint(0, 100000))
    pts_value: TimePoint = field(default_factory=lambda: TimePoint(0, 100000))
    id_asset: str = ""
    id_workspace: str = ""
    token_workspace: Optional[str] = None
    transform: np.ndarray = field(default_factory=m4.identity3)
    event_info: Optional[EventInfo] = None
    constituents_value: Tuple = ()
    # device-resident mirror (jax arrays), populated by GPU barriers
    compute_buffers: Optional[Tuple[Any, ...]] = None

    # --- Event protocol --------------------------------------------------
    def type(self) -> str:
        return "soun"

    def time(self) -> TimePoint:
        return self.time_point

    def asset_id(self) -> str:
        return self.id_asset

    def workspace_id(self) -> str:
        return self.id_workspace

    def workspace_token(self) -> Optional[str]:
        return self.token_workspace

    def info(self) -> Optional[EventInfo]:
        return self.event_info

    # --- accessors -------------------------------------------------------
    def pts(self) -> TimePoint:
        return self.pts_value

    def data(self) -> Tuple[Any, ...]:
        return self.buffers

    def number_samples(self) -> int:
        return self.sample_count

    def sample_rate(self) -> int:
        return self.frequency

    def number_channels(self) -> int:
        return self.channels

    def duration(self) -> TimePoint:
        """sample.audio.swift:131-133"""
        return TimePoint(self.sample_count, self.frequency)

    def constituents(self):
        return self.constituents_value

    def with_(self, **kwargs) -> "AudioSample":
        mapping = {
            "pts": "pts_value", "time": "time_point", "asset_id": "id_asset",
            "constituents": "constituents_value",
        }
        return replace(self, **{mapping.get(k, k): v for k, v in kwargs.items()})


def make_audio_sample(data: Sequence[np.ndarray], *, frequency: int,
                      channels: int, fmt: str, sample_count: int,
                      asset_id: str = "", workspace_id: str = "",
                      pts: Optional[TimePoint] = None,
                      time: Optional[TimePoint] = None,
                      transform: Optional[np.ndarray] = None) -> AudioSample:
    return AudioSample(
        buffers=tuple(np.asarray(d) for d in data),
        frequency=frequency, channels=channels, format=fmt,
        sample_count=sample_count, id_asset=asset_id, id_workspace=workspace_id,
        pts_value=pts if pts is not None else TimePoint(0, frequency),
        time_point=time if time is not None else TimePoint(0, frequency),
        transform=transform if transform is not None else m4.identity3())
