"""audioStats: per-channel peak + RMS metrics stage.

Reference semantics: SwiftVideo's ``Sources/SwiftVideo/stats.audio.swift``
— computes ``audio.peak.N`` / ``audio.rms.N`` into the sample's EventInfo
for s16/f32, planar or interleaved.  Vectorized via ops.audio.
"""

from __future__ import annotations

from ..core import EventBox, Tx
from ..media.audio import AudioSample
from ..ops.audio import audio_peak_rms


def audio_stats() -> Tx:
    def impl(sample: AudioSample) -> EventBox:
        info = sample.info()
        if info is not None and sample.format.startswith(("s16", "f32")):
            peaks, rms = audio_peak_rms(sample.data(), sample.format,
                                        sample.number_channels())
            for idx in range(sample.number_channels()):
                info.add_sample(f"audio.peak.{idx}", float(peaks[idx]))
                info.add_sample(f"audio.rms.{idx}", float(rms[idx]))
        return EventBox.just(sample)

    return Tx(impl)
