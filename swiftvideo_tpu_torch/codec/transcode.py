"""Transcode helpers: rename, decoder->encoder chains, containers.

Reference semantics: ``reference Sources/SwiftVideo/transcode.swift``:
``assetRename`` (constituent-tracking rename, :21-93),
``makeVideoTranscoder`` = rename >> decode >> encode (:95-113),
``makeAudioTranscoder`` = rename >> decode >> SRC >> encode (:115-128),
``TranscodeContainer`` binding many transcoders to one bus (:130-158).
"""

from __future__ import annotations

from typing import List, Optional

from ..core import Bus, EventBox, Tx
from ..media.audio import AudioFormat
from ..media.coded import (CodedMediaSample, MediaConstituent, MediaFormat,
                           MediaType)
from ..mix.src_audio import AudioSampleRateConversion
from .codecs import AudioDecoder, AudioEncoder, VideoDecoder, VideoEncoder


def flat(tx: Tx) -> Tx:
    """Lift ``tx`` to accept a single value OR a list, flattening list
    outputs — the glue that lets 1:1 stages (SRC, animators, publishers)
    follow 0..N-output codec stages (the reference wires the same shape
    with ``|>>``, bus.swift:326-340)."""
    def impl(value) -> EventBox:
        if not isinstance(value, list):
            return tx(value)
        outs = []
        info = None
        err = None
        for item in value:
            box = tx(item)
            if box.is_gone():
                return box
            if box.is_error():
                # keep processing: one bad frame must not drop the
                # already-produced outputs of this batch (live-media
                # continuity); the error surfaces when nothing succeeds
                err = box
                continue
            if box.is_just():
                v = box.value()
                outs.extend(v if isinstance(v, list) else [v])
            else:
                info = box.info()
        if outs:
            return EventBox.just(outs)
        if err is not None:
            return err
        return EventBox.nothing(info)
    return Tx(impl)


def asset_rename(new_asset_id: str) -> Tx:
    """Rename a sample, recording provenance (transcode.swift:21-93)."""
    def impl(sample) -> EventBox:
        constituent = MediaConstituent(id_asset=sample.asset_id(),
                                       pts=sample.pts(),
                                       constituents=sample.constituents())
        return EventBox.just(sample.with_(asset_id=new_asset_id,
                                          constituents=(constituent,)))
    return Tx(impl)


def make_video_transcoder(new_asset_id: str,
                          out_format: MediaFormat = MediaFormat.uncompressed
                          ) -> Tx:
    """rename >> decode >> encode (transcode.swift:95-113).  The encode
    stage is list-lifted because bitstream decoders emit 0..N frames."""
    return (asset_rename(new_asset_id) >> VideoDecoder()
            >> flat(VideoEncoder(out_format)))


def make_audio_transcoder(new_asset_id: str, *, sample_rate: int = 48000,
                          channels: int = 2,
                          out_format: MediaFormat = MediaFormat.uncompressed,
                          frame_size: int = 1024) -> Tx:
    """rename >> decode >> SRC >> encode (transcode.swift:115-128)."""
    return (asset_rename(new_asset_id) >> AudioDecoder()
            >> flat(AudioSampleRateConversion(sample_rate, channels,
                                              AudioFormat.s16i))
            >> flat(AudioEncoder(out_format, frame_size)))


class TranscodeContainer:
    """Bind transcoders for the assets seen on a bus (transcode.swift:130-158)."""

    def __init__(self, coded_bus: Bus, publish: Tx, *,
                 video_format: MediaFormat = MediaFormat.uncompressed,
                 audio_format: MediaFormat = MediaFormat.uncompressed,
                 suffix: str = ".transcode"):
        self.bus = coded_bus
        self.publish = publish
        self.video_format = video_format
        self.audio_format = audio_format
        self.suffix = suffix
        self._chains = {}
        self._sub = coded_bus.subscribe(Tx(self._dispatch))

    def _dispatch(self, sample: CodedMediaSample) -> EventBox:
        if not isinstance(sample, CodedMediaSample):
            return EventBox.nothing(None)
        key = (sample.asset_id(), sample.media_type)
        chain = self._chains.get(key)
        if chain is None:
            new_id = sample.asset_id() + self.suffix
            if sample.media_type == MediaType.video:
                chain = make_video_transcoder(new_id, self.video_format) \
                    >> flat(self.publish)
            elif sample.media_type == MediaType.audio:
                chain = (make_audio_transcoder(new_id,
                                               out_format=self.audio_format)
                         .each(self.publish))
            else:
                return EventBox.nothing(sample.info())
            self._chains[key] = chain
        return chain(sample)
