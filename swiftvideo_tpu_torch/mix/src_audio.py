"""AudioSampleRateConversion: streaming resampler + format converter stage.

Reference semantics: ``FFmpegAudioSRC``
(SwiftVideo's Sources/SwiftVideo_FFmpeg/src.audio.ffmpeg.swift):
passthrough when rate/channels/format already match (:29-33); the first
sample anchors ``pts = rescale(sample.pts, outFrequency)``; every emitted
sample carries the accumulated pts and advances it by its own sample count
(:103) — the exact-bookkeeping contract of sampleRateConversionTests.

The DSP is the polyphase matmul resampler (ops.resample) replacing soxr:
its host (numpy) route, or with ``use_device=True`` its device route on
``device`` (the current CUDA card unless the caller names one; the stage
raises at construction without one).  The pts and sample-count
bookkeeping is the same in both.
"""

from __future__ import annotations

from typing import Optional

from ..core import EventBox, TimePoint, Tx, rescale
from ..media.audio import AudioSample
from ..ops.registry import make_compute_context
from ..ops.resample import (PolyphaseResampler, from_planar_f32, map_channels,
                            to_planar_f32)


class AudioSampleRateConversion(Tx):
    def __init__(self, out_frequency: int, out_channels: int,
                 out_format: str, use_device: bool = False, device=None):
        self.out_frequency = out_frequency
        self.out_channels = out_channels
        self.out_format = out_format
        self.use_device = use_device
        self.device = make_compute_context(device).device if use_device \
            else None
        self._resampler: Optional[PolyphaseResampler] = None
        self._pts: Optional[TimePoint] = None
        self._last: Optional[AudioSample] = None
        super().__init__(self._impl)

    def flush(self):
        """Drain the filter-history tail (group delay) as a final sample
        list; call after the upstream decoder has flushed.  Resets the
        stage: a second flush() returns [] rather than a duplicate tail,
        and samples fed afterwards start a fresh stream segment
        (re-anchored pts, clean filter history — the zeros pushed here
        must not linger as mid-stream silence)."""
        r, last = self._resampler, self._last
        self._resampler = None
        self._last = None
        if r is None or last is None:
            # pure format/channel conversion has no filter history — reset
            # the pts anchor but fabricate no tail
            self._pts = None
            return []
        import numpy as np
        y = r.process(np.zeros((r.channels, r.R), np.float32))
        count = y.shape[1]
        if count == 0:
            return []
        buffers = from_planar_f32(y, self.out_format)
        pts = self._pts
        self._pts = None
        return [AudioSample(
            buffers=tuple(buffers), frequency=self.out_frequency,
            channels=self.out_channels, format=self.out_format,
            sample_count=count, time_point=last.time(), pts_value=pts,
            id_asset=last.asset_id(), id_workspace=last.workspace_id(),
            token_workspace=last.token_workspace,
            transform=last.transform, event_info=last.info())]

    def _impl(self, sample: AudioSample) -> EventBox:
        if (self.out_frequency == sample.sample_rate()
                and self.out_channels == sample.number_channels()
                and self.out_format == sample.format):
            # full passthrough is a segment boundary: the sample's own pts
            # rule the timeline now — drop the resample anchor and filter
            # history so a later mid-stream rate change re-anchors from
            # the stream instead of resuming a stale timeline (and never
            # leaks pre-passthrough filter state into the new segment)
            self._resampler = None
            self._last = None
            self._pts = None
            return EventBox.just(sample)
        self._last = sample
        if self._pts is None:
            self._pts = rescale(sample.pts(), self.out_frequency)
        x = to_planar_f32(sample.data(), sample.format,
                          sample.number_channels())
        x = map_channels(x, self.out_channels)
        if sample.sample_rate() != self.out_frequency:
            # the resampler (and its flush()-drained filter history) exists
            # only when an actual rate conversion ran; a MID-STREAM input
            # rate change (codec reconfiguration) rebuilds it — reusing
            # the old L/M ratio would resample at the wrong speed.  The
            # stale filter history belongs to the old rate's timeline, so
            # it is dropped rather than flushed into the new one.
            if (self._resampler is not None
                    and self._resampler.in_rate != sample.sample_rate()):
                self._resampler = None
            if self._resampler is None:
                self._resampler = PolyphaseResampler(
                    sample.sample_rate(), self.out_frequency,
                    self.out_channels, use_device=self.use_device,
                    device=self.device)
            y = self._resampler.process(x)
        else:
            y = x
        count = y.shape[1]
        if count == 0:
            return EventBox.nothing(sample.info())
        buffers = from_planar_f32(y, self.out_format)
        pts = self._pts
        self._pts = pts + TimePoint(count, self.out_frequency)
        return EventBox.just(AudioSample(
            buffers=tuple(buffers), frequency=self.out_frequency,
            channels=self.out_channels, format=self.out_format,
            sample_count=count, time_point=sample.time(), pts_value=pts,
            id_asset=sample.asset_id(), id_workspace=sample.workspace_id(),
            token_workspace=sample.token_workspace,
            transform=sample.transform, event_info=sample.info()))
