"""Codec graph stages: decoders / encoders as Tx elements.

Role parity with the reference's FFmpeg codec modules
(``reference Sources/SwiftVideo_FFmpeg/dec.video.ffmpeg.swift`` etc.):
``VideoDecoder`` is a ``Tx[CodedMediaSample, PictureSample]``, encoders the
reverse, dispatching per MediaFormat to a registry of codec backends.

Backends in this environment:

* **uncompressed** — a self-describing raw-plane packing (header + dense
  planes); the deterministic codec used by transcode tests and cv2-based
  file sources (reference MediaFormat.uncompressed).
* **png / jpg** — OpenCV imdecode/imencode (reference PNG/APNG decode via
  FFmpeg, dec.video.ffmpeg.swift:109-137).
* **avc / hevc / vp8 / vp9 / aac / opus** — subprocess FFmpeg when an
  ``ffmpeg`` binary exists (absent in this image; the stage emits a clean
  error box instead of crashing).
"""

from __future__ import annotations

import shutil
import struct
from typing import Optional

import numpy as np

from ..core import EventBox, EventError, TimePoint, Tx
from ..media.audio import AudioSample, dtype_for_format
from ..media.coded import CodedMediaSample, MediaFormat, MediaType
from ..media.picture import ImageBuffer, PictureSample
from ..media.pixel import (BufferType, PixelFormat, plane_array_shape,
                           planes_for_format)
from ..ops.barriers import download

_FMT_CODE = {PixelFormat.y420p: b"I420", PixelFormat.nv12: b"NV12",
             PixelFormat.RGBA: b"RGBA", PixelFormat.BGRA: b"BGRA"}
_CODE_FMT = {v: k for k, v in _FMT_CODE.items()}


def ffmpeg_available() -> bool:
    from .ffmpeg_subprocess import ffmpeg_path
    return ffmpeg_path() is not None


def libav_available() -> bool:
    from .libav import libav_available as _avail
    return _avail()


def bitstream_backend() -> Optional[str]:
    """Which real-codec backend handles avc/hevc/vp8/vp9/av1/aac/opus:
    ``"libav"`` (in-process libavcodec via csrc/libav_shim.cpp — the same
    linkage model as the reference's SwiftFFmpeg) or ``"subprocess"`` (a
    piped ffmpeg binary).  ``SV_CODEC_BACKEND`` forces one; in auto mode an
    explicit ``SWIFTVIDEO_FFMPEG`` override wins (tests point it at mock
    binaries), then in-process libav, then a PATH ffmpeg binary."""
    import os
    mode = os.environ.get("SV_CODEC_BACKEND", "auto")
    if mode == "subprocess":
        return "subprocess" if ffmpeg_available() else None
    if mode == "libav":
        return "libav" if libav_available() else None
    if os.environ.get("SWIFTVIDEO_FFMPEG") and ffmpeg_available():
        return "subprocess"
    if libav_available():
        return "libav"
    return "subprocess" if ffmpeg_available() else None


# --- uncompressed picture packing -----------------------------------------

def pack_uncompressed_picture(sample: PictureSample) -> bytes:
    """[4cc pixfmt][u32 w][u32 h][planes...]"""
    w, h = sample.size()
    head = _FMT_CODE[sample.pixel_format()] + struct.pack("<II", w, h)
    return head + b"".join(np.ascontiguousarray(download(p)).tobytes()
                           for p in sample.planes())


def unpack_uncompressed_picture(data: bytes, *, asset_id: str,
                                workspace_id: str) -> PictureSample:
    fmt = _CODE_FMT[data[0:4]]
    w, h = struct.unpack_from("<II", data, 4)
    offset = 12
    buffers = []
    for i, _plane in enumerate(planes_for_format(fmt, (w, h))):
        shape = plane_array_shape(fmt, (w, h), i)
        n = int(np.prod(shape))
        buffers.append(np.frombuffer(data, np.uint8, n, offset
                                     ).reshape(shape).copy())
        offset += n
    img = ImageBuffer(pixel_format=fmt, buffer_type=BufferType.cpu,
                      size=(w, h), planes=tuple(planes_for_format(fmt, (w, h))),
                      buffers=tuple(buffers))
    return PictureSample(img, asset_id, workspace_id)


def pack_uncompressed_audio(sample: AudioSample) -> bytes:
    head = (sample.format.encode().ljust(4) +
            struct.pack("<IIH", sample.sample_rate(), sample.number_samples(),
                        sample.number_channels()))
    return head + b"".join(np.ascontiguousarray(download(b)).tobytes()
                           for b in sample.data())


def unpack_uncompressed_audio(data: bytes, *, asset_id: str,
                              workspace_id: str) -> AudioSample:
    fmt = data[0:4].decode().strip()
    rate, count, channels = struct.unpack_from("<IIH", data, 4)
    dtype = dtype_for_format(fmt)
    offset = 14
    from ..media.audio import is_planar, number_of_buffers
    nbuf = number_of_buffers(fmt, channels)
    per = count * (1 if is_planar(fmt) else channels)
    buffers = []
    for _ in range(nbuf):
        buffers.append(np.frombuffer(data, dtype, per, offset).copy())
        offset += per * dtype.itemsize
    return AudioSample(buffers=tuple(buffers), frequency=rate,
                       channels=channels, format=fmt, sample_count=count,
                       id_asset=asset_id, id_workspace=workspace_id)


# --- video decode ----------------------------------------------------------

def _decode_image_cv2(sample: CodedMediaSample) -> PictureSample:
    import cv2
    arr = np.frombuffer(sample.data(), np.uint8)
    bgr = cv2.imdecode(arr, cv2.IMREAD_UNCHANGED)
    if bgr is None:
        raise ValueError("imdecode failed")
    if bgr.ndim == 2:
        bgr = cv2.cvtColor(bgr, cv2.COLOR_GRAY2BGRA)
    elif bgr.shape[2] == 3:
        bgr = cv2.cvtColor(bgr, cv2.COLOR_BGR2BGRA)
    rgba = bgr[..., [2, 1, 0, 3]].copy()
    h, w = rgba.shape[:2]
    img = ImageBuffer(pixel_format=PixelFormat.RGBA,
                      buffer_type=BufferType.cpu, size=(w, h),
                      planes=tuple(planes_for_format(PixelFormat.RGBA,
                                                     (w, h))),
                      buffers=(rgba,))
    return PictureSample(img, sample.asset_id(), sample.workspace_id())


_BITSTREAM_VIDEO = (MediaFormat.avc, MediaFormat.hevc, MediaFormat.vp8,
                    MediaFormat.vp9, MediaFormat.av1)
_BITSTREAM_AUDIO = (MediaFormat.aac, MediaFormat.opus)


class VideoDecoder(Tx):
    """Tx[CodedMediaSample, PictureSample | List[PictureSample]] — one
    decode entry point dispatching per MediaFormat like the reference
    (dec.video.ffmpeg.swift:109-137): uncompressed/png/jpg inline,
    avc/hevc/vp8/vp9 via the subprocess FFmpeg backend when a binary
    exists (bitstream formats emit *lists*, 0..N frames per packet)."""

    def __init__(self):
        self._ffmpeg = None
        super().__init__(self._impl)

    def _impl(self, sample: CodedMediaSample) -> EventBox:
        if sample.media_type != MediaType.video and \
                sample.media_type != MediaType.image:
            return EventBox.nothing(sample.info())
        try:
            if sample.media_format == MediaFormat.uncompressed:
                pict = unpack_uncompressed_picture(
                    sample.data(), asset_id=sample.asset_id(),
                    workspace_id=sample.workspace_id())
            elif sample.media_format in (MediaFormat.png, MediaFormat.jpg,
                                         MediaFormat.apng):
                pict = _decode_image_cv2(sample)
            elif sample.media_format in _BITSTREAM_VIDEO and \
                    (backend := bitstream_backend()) is not None:
                if self._ffmpeg is None:
                    if backend == "libav":
                        from .libav import LibavVideoDecoder
                        self._ffmpeg = LibavVideoDecoder()
                    else:
                        from .ffmpeg_subprocess import FFmpegVideoDecoder
                        self._ffmpeg = FFmpegVideoDecoder()
                return self._ffmpeg(sample)
            else:
                return EventBox.error(EventError(
                    "dec.video", -10,
                    f"no backend for {sample.media_format.name}"
                    + ("" if bitstream_backend()
                       else " (no libav shim or ffmpeg binary)")))
            return EventBox.just(pict.with_(
                pts=sample.pts(), time=sample.time(),
                constituents=sample.constituents(),
                event_info=sample.info()))
        except Exception as exc:  # noqa: BLE001
            return EventBox.error(EventError("dec.video", -1, str(exc)))

    def flush(self):
        """End of stream: frames still buffered in the bitstream backend."""
        return self._ffmpeg.flush() if self._ffmpeg is not None else []

    def close(self) -> None:
        if self._ffmpeg is not None:
            self._ffmpeg.close()


class VideoEncoder(Tx):
    """Tx[PictureSample, CodedMediaSample | List[CodedMediaSample]]
    (enc.video.ffmpeg.swift:21-297).  Bitstream formats (avc/hevc/vp8/vp9)
    route to the subprocess FFmpeg backend and emit lists; the inline
    backends produce intra-only single samples."""

    def __init__(self, fmt: MediaFormat = MediaFormat.uncompressed,
                 quality: int = 90, **ffmpeg_kwargs):
        self.fmt = fmt
        self.quality = quality
        self._ffmpeg = None
        self._ffmpeg_kwargs = ffmpeg_kwargs
        super().__init__(self._impl)

    def _impl(self, sample: PictureSample) -> EventBox:
        if self.fmt in _BITSTREAM_VIDEO and \
                (backend := bitstream_backend()) is not None:
            if self._ffmpeg is None:
                if backend == "libav":
                    from .libav import LibavVideoEncoder
                    self._ffmpeg = LibavVideoEncoder(self.fmt,
                                                     **self._ffmpeg_kwargs)
                else:
                    from .ffmpeg_subprocess import FFmpegVideoEncoder
                    self._ffmpeg = FFmpegVideoEncoder(self.fmt,
                                                      **self._ffmpeg_kwargs)
            return self._ffmpeg(sample)
        try:
            if self.fmt == MediaFormat.uncompressed:
                data = pack_uncompressed_picture(sample)
            elif self.fmt in (MediaFormat.png, MediaFormat.jpg):
                import cv2
                planes = sample.planes()
                if sample.pixel_format() not in (PixelFormat.RGBA,
                                                 PixelFormat.BGRA):
                    return EventBox.error(EventError(
                        "enc.video", -2, "image encode wants rgba input"))
                rgba = download(planes[0])
                if sample.pixel_format() == PixelFormat.RGBA:
                    rgba = rgba[..., [2, 1, 0, 3]]
                ext = ".png" if self.fmt == MediaFormat.png else ".jpg"
                params = [] if self.fmt == MediaFormat.png else \
                    [cv2.IMWRITE_JPEG_QUALITY, self.quality]
                ok, buf = cv2.imencode(ext, rgba, params)
                if not ok:
                    raise ValueError("imencode failed")
                data = buf.tobytes()
            else:
                return EventBox.error(EventError(
                    "enc.video", -10,
                    f"no backend for {self.fmt.name}"
                    + ("" if bitstream_backend()
                       else " (no libav shim or ffmpeg binary)")))
            return EventBox.just(CodedMediaSample(
                buffer=data, pts_value=sample.pts(), dts_value=sample.pts(),
                media_type=MediaType.video, media_format=self.fmt,
                id_asset=sample.asset_id(), id_workspace=sample.workspace_id(),
                time_point=sample.time(),
                constituents_value=tuple(sample.constituents()),
                event_info=sample.info()))
        except Exception as exc:  # noqa: BLE001
            return EventBox.error(EventError("enc.video", -1, str(exc)))

    def flush(self):
        """End of stream: samples still buffered in the bitstream backend."""
        return self._ffmpeg.flush() if self._ffmpeg is not None else []

    def close(self) -> None:
        if self._ffmpeg is not None:
            self._ffmpeg.close()


class AudioDecoder(Tx):
    """Tx[CodedMediaSample, AudioSample | List[AudioSample]]
    (dec.audio.ffmpeg.swift:24-211): uncompressed inline, AAC/Opus via the
    subprocess FFmpeg backend (list output) when a binary exists."""

    def __init__(self):
        self._ffmpeg = None
        super().__init__(self._impl)

    def _impl(self, sample: CodedMediaSample) -> EventBox:
        if sample.media_type != MediaType.audio:
            return EventBox.nothing(sample.info())
        if sample.media_format == MediaFormat.uncompressed:
            try:
                audio = unpack_uncompressed_audio(
                    sample.data(), asset_id=sample.asset_id(),
                    workspace_id=sample.workspace_id())
            except Exception as exc:  # noqa: BLE001
                return EventBox.error(EventError("dec.audio", -1, str(exc)))
            return EventBox.just(audio.with_(pts=sample.pts(),
                                             time=sample.time(),
                                             event_info=sample.info()))
        if sample.media_format in _BITSTREAM_AUDIO and \
                (backend := bitstream_backend()) is not None:
            if self._ffmpeg is None:
                if backend == "libav":
                    from .libav import LibavAudioDecoder
                    self._ffmpeg = LibavAudioDecoder()
                else:
                    from .ffmpeg_subprocess import FFmpegAudioDecoder
                    self._ffmpeg = FFmpegAudioDecoder()
            return self._ffmpeg(sample)
        return EventBox.error(EventError(
            "dec.audio", -10, f"no backend for {sample.media_format.name}"
            + ("" if bitstream_backend()
               else " (no libav shim or ffmpeg binary)")))

    def flush(self):
        return self._ffmpeg.flush() if self._ffmpeg is not None else []

    def close(self) -> None:
        if self._ffmpeg is not None:
            self._ffmpeg.close()


class AudioEncoder(Tx):
    """Tx[AudioSample, List[CodedMediaSample]]: accumulates to exact frame
    sizes like the reference (enc.audio.ffmpeg.swift:119-160) via the
    segmenter, then packs."""

    def __init__(self, fmt: MediaFormat = MediaFormat.uncompressed,
                 frame_size: int = 1024, **ffmpeg_kwargs):
        self.fmt = fmt
        self._segmenter: Optional[object] = None
        self.frame_size = frame_size
        self._ffmpeg = None
        self._ffmpeg_kwargs = ffmpeg_kwargs
        super().__init__(self._impl)

    def _impl(self, sample: AudioSample) -> EventBox:
        from ..mix.segmenter import AudioPacketSegmenter
        if self.fmt in _BITSTREAM_AUDIO and \
                (backend := bitstream_backend()) is not None:
            if self._ffmpeg is None:
                if backend == "libav":
                    from .libav import LibavAudioEncoder
                    self._ffmpeg = LibavAudioEncoder(self.fmt,
                                                     **self._ffmpeg_kwargs)
                else:
                    from .ffmpeg_subprocess import FFmpegAudioEncoder
                    self._ffmpeg = FFmpegAudioEncoder(self.fmt,
                                                      **self._ffmpeg_kwargs)
            return self._ffmpeg(sample)
        if self.fmt != MediaFormat.uncompressed:
            return EventBox.error(EventError(
                "enc.audio", -10, f"no backend for {self.fmt.name}"
                + ("" if bitstream_backend()
                   else " (no libav shim or ffmpeg binary)")))
        if self._segmenter is None:
            self._segmenter = AudioPacketSegmenter(
                TimePoint(self.frame_size, sample.sample_rate()))
        box = self._segmenter(sample)
        if not box.is_just():
            return box
        return EventBox.just([self._pack(seg) for seg in box.value()])

    def _pack(self, seg) -> CodedMediaSample:
        return CodedMediaSample(
            buffer=pack_uncompressed_audio(seg), pts_value=seg.pts(),
            dts_value=seg.pts(), media_type=MediaType.audio,
            media_format=self.fmt, id_asset=seg.asset_id(),
            id_workspace=seg.workspace_id(), time_point=seg.time(),
            event_info=seg.info())

    def flush(self):
        if self._ffmpeg is not None:
            return self._ffmpeg.flush()
        if self._segmenter is not None:
            # uncompressed path: drain the segmenter's sub-frame tail
            # (up to frame_size-1 samples) instead of truncating it
            return [self._pack(seg) for seg in self._segmenter.flush()]
        return []

    def close(self) -> None:
        if self._ffmpeg is not None:
            self._ffmpeg.close()
