"""AudioPacketSegmenter: re-chunk audio samples to an exact duration.

Reference semantics: ``reference Sources/SwiftVideo/segmenter.audio.swift``
— accumulate incoming samples and split whenever the buffered duration
(measured from the running output pts) reaches the segment duration,
memcpy-assembling each output from the overlapping inputs (the classic
1024 -> 960 AAC/Opus re-chunking).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..core import EventBox, TimePoint, Tx, rescale
from ..media.audio import (AudioSample, bytes_per_sample, dtype_for_format,
                           number_of_buffers)
from ..ops.barriers import download


def _split(duration: TimePoint, pts: TimePoint,
           in_samples: List[AudioSample],
           out_samples: List[AudioSample]) -> Tuple[TimePoint,
                                                    List[AudioSample],
                                                    List[AudioSample]]:
    """audioSampleSplit (segmenter.audio.swift:29-86), iterative."""
    while True:
        if not in_samples:
            return pts, [], out_samples
        total = TimePoint(0, duration.scale)
        for s in in_samples:
            total = total + s.duration()
        total = total - (pts - in_samples[0].pts())
        if not (total >= duration):
            return pts, in_samples, out_samples
        first = in_samples[0]
        sample_count = rescale(duration, first.sample_rate()).value
        sample_bytes = bytes_per_sample(first.format, first.number_channels())
        # array units per sample period = buffer bytes / element width
        # (1 for planar, channel count for interleaved — including the
        # 8-byte f64/s64 formats)
        units_per_sample = sample_bytes // dtype_for_format(
            first.format).itemsize
        buf_units = int(sample_count) * units_per_sample
        nbuf = number_of_buffers(first.format, first.number_channels())
        dtype = download(first.data()[0]).dtype
        buffers = [np.zeros(buf_units, dtype) for _ in range(nbuf)]
        next_pts = pts + duration
        remaining = [s for s in in_samples if (s.pts() + s.duration()) > next_pts]
        to_copy = [s for s in in_samples if s.pts() <= next_pts]
        for s in to_copy:
            in_off = pts - s.pts()
            in_start = max(int(rescale(in_off, s.sample_rate()).value)
                           * units_per_sample, 0)
            out_off = s.pts() - pts
            out_start = max(int(rescale(out_off, s.sample_rate()).value)
                            * units_per_sample, 0)
            src0 = download(s.data()[0])
            n = min(buf_units - out_start, src0.size - in_start)
            if n > 0:
                for idx, buf in enumerate(s.data()):
                    arr = download(buf)
                    buffers[idx][out_start:out_start + n] = \
                        arr[in_start:in_start + n]
        out_samples = out_samples + [s.__class__(
            buffers=tuple(buffers), frequency=first.frequency,
            channels=first.channels, format=first.format,
            sample_count=int(sample_count), time_point=first.time(),
            pts_value=pts, id_asset=first.asset_id(),
            id_workspace=first.workspace_id(), transform=first.transform,
            event_info=first.info())]
        pts = next_pts
        in_samples = remaining


class AudioPacketSegmenter(Tx):
    """Tx[AudioSample, List[AudioSample]] (segmenter.audio.swift:3-27)."""

    def __init__(self, duration: TimePoint):
        self._incoming: List[AudioSample] = []
        self._pts: Optional[TimePoint] = None
        self._duration = duration
        super().__init__(self._impl)

    def _impl(self, sample: AudioSample) -> EventBox:
        self._incoming.append(sample)
        pts = self._pts if self._pts is not None else sample.pts()
        new_pts, remaining, produced = _split(self._duration, pts,
                                              self._incoming, [])
        self._pts = new_pts
        self._incoming = remaining
        return EventBox.just(produced)

    def flush(self) -> List[AudioSample]:
        """End of stream: emit the buffered tail (shorter than one
        segment) as one final sample instead of silently dropping up to
        duration-1 samples."""
        if not self._incoming:
            return []
        pts = self._pts if self._pts is not None else self._incoming[0].pts()
        total = TimePoint(0, self._duration.scale)
        for s in self._incoming:
            total = total + s.duration()
        tail = total - (pts - self._incoming[0].pts())
        pending, self._incoming, self._pts = self._incoming, [], None
        if not (tail.value > 0):
            return []
        _pts2, _rem, produced = _split(tail, pts, pending, [])
        return produced
