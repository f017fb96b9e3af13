"""AudioMixer: clock-driven sample-accurate audio mix source.

Reference semantics: SwiftVideo's ``Sources/SwiftVideo/mix.audio.swift``
(as ported by ``swiftvideo_tpu/mix/audio_mixer.py``) — ported exactly,
including the subtle parts:

* **pts-offset normalization**: the first sample of an asset anchors
  ``offset = mixerPts + 2*frameDuration - samplePts`` (:60-64); subsequent
  samples are placed by ``normalizedPts = pts + offset + delay``.
* **window overlap test** (:142-153): a sample mixes into the window
  ``[mixTs, mixTs + frameDuration)`` when ``normalizedEnd >= mixTs`` and
  ``normalizedPts < mixEnd``; future samples are kept, past ones dropped.
* **sample-accurate offsets** (:154-172): output offset from the rescaled
  pts delta; input offset from a negative delta (reference reinterprets the
  delta value in the source rate — valid because an SRC in front
  guarantees matching rates; mirrored as-is).
* **underrun -> discontinuity** (:201-208): incomplete coverage with
  discarded samples re-anchors the asset's offset and reports
  ``mix.audio.underrun``.
* **constituent provenance** (:189-199) for every asset that contributed.

The int16 hot loop is ops.audio.apply_mix_s16 (vectorized numpy with exact
truncation/saturation semantics); torch folds on the context's device
cover both the aligned tick (ops.audio.mix_s16_device) and
offset/partial-window ticks (ops.audio.mix_s16_device_windowed).  Both
are integer-equal to the host loop.
"""

from __future__ import annotations

import threading
import uuid
from typing import Dict, List, Optional

import numpy as np

import torch

from ..core import (Clock, ClockTickEvent, EventBox, Source,
                    StatsReport, TimePoint, clamp_time, maximum,
                    rescale, spans)
from ..core.time import _wrap64
from ..media.audio import (AudioFormat, AudioSample,
                           bytes_per_sample, number_of_buffers)
from ..media.coded import MediaConstituent
from ..utils.matrix import audio_position_gain

from ..ops.audio import (apply_mix_s16, channel_gains, mix_s16_device,
                         mix_s16_device_windowed)

# channel gains a mixer keeps, by source transform: a still source's gains
# are computed once; a fading or panning one, whose transform changes every
# tick, fills the table and it starts again
GAIN_CACHE = 64


class AudioMixer(Source):
    def __init__(self, clock: Clock, *, workspace_id: str,
                 frame_duration: TimePoint, sample_rate: int,
                 channel_count: int, delay: Optional[TimePoint] = None,
                 output_format: str = AudioFormat.s16i,
                 asset_id: Optional[str] = None,
                 stats_report: Optional[StatsReport] = None,
                 epoch: Optional[int] = None,
                 compute_context=None,
                 device_min_elems: int = 1 << 16,
                 dedup_overlap: bool = True):
        super().__init__()
        self.clock = clock
        # device mixing (resurrected snd_s16i_s16i, kernels.cl.swift:534-562)
        # engages when a compute context is wired (its torch device runs
        # the fold): full-window
        # aligned ticks (the Composer steady-state with an SRC in front)
        # take the plain fold, offset/partial contributions the windowed
        # fold — both integer-equal to the host loop's algebra.
        # device_min_elems gates on total mixed elements: a typical
        # Composer tick (a few sources x ~2k int16) is microseconds of
        # numpy but a full device dispatch + two host<->device copies —
        # the device fold only pays off at wall-scale batch sizes
        self.compute_context = compute_context
        self.device_min_elems = device_min_elems
        self.frame_duration = frame_duration
        self.delay = delay if delay is not None else TimePoint(0, frame_duration.scale)
        self.sample_rate = sample_rate
        self.channel_count = channel_count
        self.output_format = output_format
        self.id_workspace = workspace_id
        self.id_asset = asset_id or str(uuid.uuid4())
        self.stats = stats_report or StatsReport(asset_id=self.id_asset,
                                                 clock=clock)
        now = clock.current()
        epoch_tp = clock.from_unix_time(epoch) if epoch is not None else now
        self.epoch = rescale(epoch_tp, sample_rate)
        self.pts = now - self.epoch
        self._samples: Dict[str, List[AudioSample]] = {}
        self._source_offset: Dict[str, TimePoint] = {}
        # per-asset high-water mark of output frames ALREADY WRITTEN, in
        # absolute output-timeline frame units.  The reference's
        # window-overlap test (mix.audio.swift:142-153) re-mixes any span
        # two packets share — under RTMP ms-quantization a 1024-sample
        # packet re-times to 21 ms, its WRITE span (1024 frames) outruns
        # its declared duration (21 ms = 1008 frames), and ~16 samples at
        # each seam get mixed twice (audible doubling).  The overlap is
        # invisible at TimePoint granularity (durations truncate to the
        # pts scale), so the mark tracks frames actually contributed.
        # dedup_overlap=True (default) clips every contribution to the
        # region past the mark; False reproduces the reference artifact
        # bit-for-bit.
        self.dedup_overlap = dedup_overlap
        self._mixed_until: Dict[str, int] = {}
        self._gains: Dict[tuple, np.ndarray] = {}
        # each queued sample's placement on the mixer's timeline at the last
        # tick, by id (``_place``).  A sample stays queued for several ticks
        # and its placement changes only with its asset's offset (a new
        # object on re-anchor), the delay, or the scales of the tick's window
        self._placed: Dict[int, tuple] = {}
        # in int16 units a frame, by (sample format, channels)
        self._in_ipf: Dict[tuple, int] = {}
        self._consts: Optional[tuple] = None
        self._lock = threading.RLock()
        self._closed = False

        def digest(sample: AudioSample) -> EventBox:
            if self._closed:
                # the tick drain stopped with close(); accepting more
                # samples would accumulate without bound while upstream
                # chains stay subscribed
                return EventBox.gone()
            if sample.asset_id() != self.id_asset:
                with self._lock:
                    self._samples.setdefault(sample.asset_id(), []).append(sample)
                    if sample.asset_id() not in self._source_offset:
                        # anchor (mix.audio.swift:60-64)
                        self._source_offset[sample.asset_id()] = \
                            self.pts + (self.frame_duration * 2) - sample.pts()
                return EventBox.nothing(sample.info())
            return EventBox.just(sample)

        self.set(digest)
        clock.schedule(now + frame_duration, self._mix)

    # --- accessors --------------------------------------------------------
    def asset_id(self) -> str:
        return self.id_asset

    def workspace_id(self) -> str:
        return self.id_workspace

    def get_sample_rate(self) -> int:
        return self.sample_rate

    def get_channels(self) -> int:
        return self.channel_count

    def get_audio_format(self) -> str:
        return self.output_format

    def remove_asset(self, asset_id: str) -> None:
        with self._lock:
            self._samples.pop(asset_id, None)
            self._source_offset.pop(asset_id, None)
            self._mixed_until.pop(asset_id, None)

    def discontinuity(self, asset_id: str) -> None:
        self._source_offset.pop(asset_id, None)
        self._mixed_until.pop(asset_id, None)

    def close(self) -> None:
        self._closed = True
        self.stats.close()

    def gains(self, transform: np.ndarray) -> np.ndarray:
        """The per-channel gains (read-only) of a source with this 3x3
        audio transform (mix.audio.swift:228-258), kept by value."""
        t = np.asarray(transform)
        key = (t.dtype.str, t.shape, t.tobytes())
        g = self._gains.get(key)
        if g is None:
            g = channel_gains(*audio_position_gain(t),
                              channel_count=self.channel_count)
            g.flags.writeable = False
            if len(self._gains) >= GAIN_CACHE:
                self._gains.clear()
            self._gains[key] = g
        return g

    def _tick_constants(self) -> tuple:
        """(frame duration, sample rate, output format, channels, samples a
        tick, buffers, int16 units a buffer, int16 units a frame) of the
        output, worked out again only when one of the four settings
        changes."""
        k = self._consts
        if k is None or k[0] is not self.frame_duration \
                or k[1] != self.sample_rate or k[2] != self.output_format \
                or k[3] != self.channel_count:
            number_samples = rescale(self.frame_duration,
                                     self.sample_rate).value
            out_bytes = bytes_per_sample(self.output_format,
                                         self.channel_count)
            k = self._consts = (
                self.frame_duration, self.sample_rate, self.output_format,
                self.channel_count, number_samples,
                number_of_buffers(self.output_format, self.channel_count),
                number_samples * out_bytes // 2, out_bytes // 2)
        return k

    def _place(self, work: AudioSample, offset: TimePoint, ts_scale: int,
               end_scale: int) -> tuple:
        """A queued sample's placement: (sample, offset, delay,
        ``ts_scale``, ``end_scale``, normalized pts, normalized end, and
        three values: the end and the pts rescaled to ``ts_scale``, the pts
        rescaled to ``end_scale``).  The three are what the TimePoint
        comparisons and differences against the tick's start (at
        ``ts_scale``) and the window's end (at ``end_scale``) compute
        first, by the same ``rescale``."""
        work_duration = rescale(
            TimePoint(work.number_samples(), work.sample_rate()),
            work.pts().scale)
        normalized_pts = work.pts() + offset + self.delay
        normalized_end = normalized_pts + rescale(work_duration,
                                                  normalized_pts.scale)
        return (work, offset, self.delay, ts_scale, end_scale,
                normalized_pts, normalized_end,
                rescale(normalized_end, ts_scale).value,
                rescale(normalized_pts, ts_scale).value,
                rescale(normalized_pts, end_scale).value)

    # --- mix execution ----------------------------------------------------
    def _run_mix(self, contribs, backing: np.ndarray) -> None:
        """Fold ``contribs`` into ``backing`` in order.  Device path, on
        the context's torch device: one ``mix_s16_device`` call (exact
        snd_s16i_s16i fold algebra — integer equality with apply_mix_s16)
        when every contribution is full-window aligned, or one
        ``mix_s16_device_windowed`` call for offset/partial-window ticks;
        the host loop serves ticks below ``device_min_elems``."""
        # drop no-op contributions (bad offsets; apply_mix_s16 returns -1
        # without mixing) so edge ticks don't knock out the device gate
        contribs = [c for c in contribs
                    if c[3] < c[0].size and c[2] < backing.size]
        if not contribs:
            return
        ctx = self.compute_context
        device_ok = (ctx is not None
                     and ctx.kind in ("cpu", "cuda")
                     and len(contribs) * backing.size >= self.device_min_elems)
        if device_ok:
            dev = ctx.device
            gains = torch.from_numpy(np.stack(
                [np.asarray(g, np.float32) for _d, g, _b, _i in contribs]))
            base = torch.from_numpy(backing).to(dev)
            if all(b_off == 0 and i_off == 0
                   and data.size == backing.size
                   for data, _g, b_off, i_off in contribs):
                inputs = torch.from_numpy(
                    np.stack([data for data, _g, _b, _i in contribs])).to(dev)
                backing[:] = mix_s16_device(inputs, gains, base=base).cpu().numpy()
                return
            s, size = len(contribs), backing.size
            inputs = np.zeros((s, size), np.int16)
            starts = np.zeros(s, np.int32)
            ends = np.zeros(s, np.int32)
            for k, (data, _g, b_off, i_off) in enumerate(contribs):
                n = min(size - b_off, data.size - i_off)
                inputs[k, b_off:b_off + n] = data[i_off:i_off + n]
                starts[k], ends[k] = b_off, b_off + n
            backing[:] = mix_s16_device_windowed(
                torch.from_numpy(inputs).to(dev), gains, starts, ends,
                base=base).cpu().numpy()
            return
        for data, gains, b_off, i_off in contribs:
            apply_mix_s16(data, gains, backing,
                          backing_start=b_off, input_start=i_off)

    # --- tick (mix.audio.swift:112-225) -----------------------------------
    def _mix(self, at: ClockTickEvent) -> None:
        if self._closed:
            return
        span = spans.ON and spans.begin("audio_mixer.tick")
        mix_ts = at.time() - self.epoch
        self.pts = mix_ts
        self.clock.schedule(at.time() + self.frame_duration, self._mix)
        self.stats.end_timer("mix.audio.delta")
        self.stats.start_timer("mix.audio.delta")
        self.stats.start_timer("mix.audio.mix")

        mix_end = mix_ts + self.frame_duration
        (_d, sample_rate, _f, _c, number_samples, num_buffers,
         samples_per_buffer, out_ipf) = self._tick_constants()
        buffers = [np.zeros(samples_per_buffer, np.int16)
                   for _ in range(num_buffers)]
        constituents: List[MediaConstituent] = []
        # the window test in integers: each queued sample's end and pts
        # rescaled to the scales of mix_ts and mix_end (``_place``)
        ts_scale, ts_value = mix_ts.scale, mix_ts.value
        end_scale, end_value = mix_end.scale, mix_end.value
        mix_frames = rescale(mix_ts, sample_rate).value

        with self._lock:
            assets = {k: list(v) for k, v in self._samples.items() if v}
            offsets = dict(self._source_offset)
        result: Dict[str, List[AudioSample]] = {}
        # dedup high-water marks to publish in the locked write-back (a
        # bare write here would race remove_asset and resurrect its entry)
        new_marks: Dict[str, int] = {}
        # ordered (input_view, gains, back_off, in_off) per target buffer
        contributions: List[List] = [[] for _ in range(num_buffers)]
        placed: Dict[int, tuple] = {}
        for asset_id, queued in assets.items():
            offset = offsets.get(asset_id)
            if offset is None:
                # un-anchored leftovers (a discontinuity popped the
                # offset and the source never re-appeared): drop them —
                # the reference rebuilds self.samples wholesale each
                # tick, which discards offset-less assets
                # (mix.audio.swift:135-210); a fresh sample re-anchors
                # in the digest before it is ever queued
                result[asset_id] = []
                continue
            if not queued:
                continue
            covered = (mix_end, mix_ts)
            unused: List[AudioSample] = []
            hw = (self._mixed_until.get(asset_id)
                  if self.dedup_overlap else None)
            for work in queued:
                place = self._placed.get(id(work))
                if place is None or place[0] is not work \
                        or place[1] is not offset \
                        or place[2] is not self.delay \
                        or place[3] != ts_scale or place[4] != end_scale:
                    place = self._place(work, offset, ts_scale, end_scale)
                placed[id(work)] = place
                # normalized_end >= mix_ts and normalized_pts < mix_end
                if place[7] >= ts_value and place[9] < end_value:
                    # pts_delta = normalized_pts - mix_ts, at ts_scale
                    delta = _wrap64(place[8] - ts_value)
                    offset_samples = (
                        delta if ts_scale == sample_rate else
                        rescale(TimePoint(delta, ts_scale), sample_rate).value)
                    fmt = (work.format, work.number_channels())
                    in_ipf = self._in_ipf.get(fmt)
                    if in_ipf is None:
                        in_ipf = self._in_ipf[fmt] = \
                            bytes_per_sample(*fmt) // 2
                    # reference reinterprets a negative delta in source-rate
                    # units (mix.audio.swift:157-160)
                    in_off_units = abs(delta) * in_ipf if delta < 0 else 0
                    back_off_units = max(offset_samples * out_ipf, 0)
                    if self.dedup_overlap:
                        # span dedup (beyond the reference): clip to the
                        # frames past this asset's already-written mark
                        start_f = mix_frames + back_off_units // out_ipf
                        if hw is not None and hw > start_f:
                            skip = hw - start_f
                            in_off_units += skip * in_ipf
                            back_off_units += skip * out_ipf
                            start_f = hw
                        # frames this contribution will actually write
                        n_f = min(int(number_samples)
                                  - back_off_units // out_ipf,
                                  work.number_samples()
                                  - in_off_units // in_ipf)
                        if n_f <= 0:
                            # nothing to write THIS tick: keep the sample
                            # when input frames remain (the dedup skip
                            # pushed its start past this window — the
                            # tail belongs to the next tick); drop it
                            # when every input frame is already mixed
                            if work.number_samples() \
                                    - in_off_units // in_ipf > 0:
                                unused.append(work)
                            continue
                        hw = max(hw or 0, start_f + n_f)
                    gains = self.gains(work.transform)
                    for idx, data in enumerate(work.data()):
                        if idx >= len(buffers):
                            break
                        contributions[idx].append(
                            (np.asarray(data).view(np.int16), gains,
                             int(back_off_units), int(in_off_units)))
                    covered = (clamp_time(place[5], mix_ts, covered[0]),
                               clamp_time(covered[1], place[6], mix_end))
                    unused.append(work)
                elif place[7] > ts_value:   # normalized_end > mix_ts
                    unused.append(work)
                # else: discard past sample
            if covered[1] > covered[0]:
                constituents.append(MediaConstituent(
                    id_asset=asset_id,
                    pts=covered[0] - offset - self.delay,
                    duration=covered[1] - covered[0],
                    normalized_pts=covered[0]))
            if ((covered[0] > covered[1]) or (covered[1] != mix_end)) and \
                    len(unused) != len(queued):
                underrun = maximum(TimePoint(0, 1000), covered[0] - mix_ts) + \
                    maximum(TimePoint(0, 1000), mix_end - covered[1])
                self.stats.add_sample("mix.audio.underrun", underrun)
                self.discontinuity(asset_id)     # also resets _mixed_until
            elif self.dedup_overlap and hw is not None:
                new_marks[asset_id] = hw
            result[asset_id] = unused
        self._placed = placed
        part = span and spans.begin("audio_mixer.fold")
        for idx, contribs in enumerate(contributions):
            self._run_mix(contribs, buffers[idx])
        if span:
            spans.end(part)
        with self._lock:
            for asset_id, unused in result.items():
                if asset_id not in self._samples:
                    # remove_asset() raced this tick: stay removed
                    # (including its _mixed_until mark — don't resurrect)
                    continue
                if asset_id in new_marks:
                    self._mixed_until[asset_id] = new_marks[asset_id]
                # keep samples that arrived during the mix
                arrived = self._samples.get(asset_id, [])
                new_tail = arrived[len(assets.get(asset_id, [])):]
                self._samples[asset_id] = unused + new_tail
        self.stats.end_timer("mix.audio.mix")

        out = AudioSample(
            buffers=tuple(buffers), frequency=self.sample_rate,
            channels=self.channel_count, format=self.output_format,
            sample_count=int(number_samples), time_point=at.time(),
            pts_value=mix_ts - self.delay, id_asset=self.id_asset,
            id_workspace=self.id_workspace,
            constituents_value=tuple(constituents), event_info=self.stats)
        part = span and spans.begin("audio_mixer.emit")
        self.emit(out)
        if span:
            spans.end(part)
            spans.end(span)
