"""Container demux/mux over libavformat (ctypes via ``csrc/libav_shim.cpp``).

Role parity with the reference's FileSource stream mapping
(``reference Sources/SwiftVideo_FFmpeg/file.ffmpeg.swift:44-72`` maps
every container stream to a LiveAsset track) plus a muxer the reference
lacks: MP4/FLV/Matroska packets map 1:1 onto this repo's wire conventions —
MP4's avcC/hvcC/ASC extradata IS the ``side["config"]`` record, and MP4
video packets are already AVCC length-prefixed.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

from ..core import TimePoint
from ..media.coded import CodedMediaSample, MediaFormat, MediaType
from .libav import AVERROR_EOF, _load

AV_NOPTS_VALUE = -(2 ** 63)

# libavcodec descriptor name <-> repo MediaFormat
_CODEC_TO_FMT = {"h264": MediaFormat.avc, "hevc": MediaFormat.hevc,
                 "vp8": MediaFormat.vp8, "vp9": MediaFormat.vp9,
                 "av1": MediaFormat.av1, "aac": MediaFormat.aac,
                 "opus": MediaFormat.opus, "png": MediaFormat.png,
                 "apng": MediaFormat.apng, "mjpeg": MediaFormat.jpg,
                 "gif": MediaFormat.gif}
_FMT_TO_CODEC = {v: k for k, v in _CODEC_TO_FMT.items()}


def _prototype_format(lib) -> None:
    c = ctypes
    if getattr(lib, "_sv_format_prototyped", False):
        return
    lib.sv_demux_open.restype = c.c_void_p
    lib.sv_demux_open.argtypes = [c.c_char_p]
    lib.sv_demux_free.argtypes = [c.c_void_p]
    lib.sv_demux_last_error.restype = c.c_char_p
    lib.sv_demux_last_error.argtypes = [c.c_void_p]
    lib.sv_demux_nb_streams.argtypes = [c.c_void_p]
    lib.sv_demux_stream_info.argtypes = [
        c.c_void_p, c.c_int, c.POINTER(c.c_char_p), c.POINTER(c.c_int),
        c.POINTER(c.c_int), c.POINTER(c.c_int), c.POINTER(c.c_int),
        c.POINTER(c.c_int), c.POINTER(c.c_void_p), c.POINTER(c.c_int),
        c.POINTER(c.c_int), c.POINTER(c.c_int), c.POINTER(c.c_int),
        c.POINTER(c.c_int), c.POINTER(c.c_int64)]
    lib.sv_demux_read.argtypes = [
        c.c_void_p, c.POINTER(c.c_int), c.POINTER(c.c_void_p),
        c.POINTER(c.c_int), c.POINTER(c.c_int64), c.POINTER(c.c_int64),
        c.POINTER(c.c_int64), c.POINTER(c.c_int)]
    lib.sv_demux_seek_start.argtypes = [c.c_void_p]
    lib.sv_mux_open.restype = c.c_void_p
    lib.sv_mux_open.argtypes = [c.c_char_p, c.c_char_p]
    lib.sv_mux_free.argtypes = [c.c_void_p]
    lib.sv_mux_last_error.restype = c.c_char_p
    lib.sv_mux_last_error.argtypes = [c.c_void_p]
    lib.sv_mux_add_stream.argtypes = [
        c.c_void_p, c.c_char_p, c.c_int, c.c_int, c.c_int, c.c_int, c.c_int,
        c.c_char_p, c.c_int, c.c_int]
    lib.sv_mux_write_header.argtypes = [c.c_void_p]
    lib.sv_mux_write.argtypes = [c.c_void_p, c.c_int, c.c_char_p, c.c_int,
                                 c.c_int64, c.c_int64, c.c_int64, c.c_int,
                                 c.c_int]
    lib.sv_mux_write_trailer.argtypes = [c.c_void_p]
    lib._sv_format_prototyped = True


def _lib():
    lib = _load()
    if lib is None:
        raise RuntimeError("libav shim not available")
    _prototype_format(lib)
    return lib


def avformat_available() -> bool:
    try:
        _lib()
        return True
    except RuntimeError:
        return False


@dataclass(frozen=True)
class StreamInfo:
    index: int
    codec: str                       # libavcodec descriptor name
    media_format: Optional[MediaFormat]  # None for unsupported codecs
    media_type: MediaType
    width: int
    height: int
    sample_rate: int
    channels: int
    config: bytes                    # avcC/hvcC/ASC/OpusHead/... extradata
    time_base: Tuple[int, int]
    fps: Tuple[int, int]
    duration: Optional[TimePoint]


class MediaFileReader:
    """Demux every track of a container file into CodedMediaSamples with
    exact container pts and the codec config record in side data."""

    def __init__(self, path: str, *, asset_id: str = "file",
                 workspace_id: str = ""):
        lib = _lib()
        self._h = lib.sv_demux_open(path.encode())
        if not self._h:
            raise FileNotFoundError(f"demux open failed: {path}")
        self.asset_id = asset_id
        self.workspace_id = workspace_id
        self.streams: List[StreamInfo] = []
        for i in range(lib.sv_demux_nb_streams(self._h)):
            self.streams.append(self._stream_info(i))

    def _stream_info(self, index: int) -> StreamInfo:
        lib = _lib()
        c = ctypes
        name = c.c_char_p()
        mtype = c.c_int()
        w = c.c_int()
        h = c.c_int()
        rate = c.c_int()
        ch = c.c_int()
        extra = c.c_void_p()
        extra_size = c.c_int()
        tbn = c.c_int()
        tbd = c.c_int()
        fpsn = c.c_int()
        fpsd = c.c_int()
        dur = c.c_int64()
        rc = lib.sv_demux_stream_info(
            self._h, index, c.byref(name), c.byref(mtype), c.byref(w),
            c.byref(h), c.byref(rate), c.byref(ch), c.byref(extra),
            c.byref(extra_size), c.byref(tbn), c.byref(tbd), c.byref(fpsn),
            c.byref(fpsd), c.byref(dur))
        if rc < 0:
            raise RuntimeError(f"stream_info({index}) failed")
        codec = (name.value or b"unknown").decode()
        config = b""
        if extra.value and extra_size.value > 0:
            config = bytes(c.cast(extra, c.POINTER(
                c.c_ubyte * extra_size.value)).contents)
        tb = (tbn.value or 1, tbd.value or 1)
        duration = (TimePoint(dur.value * tb[0], tb[1])
                    if dur.value > 0 else None)
        return StreamInfo(
            index=index, codec=codec,
            media_format=_CODEC_TO_FMT.get(codec),
            media_type=(MediaType.video if mtype.value == 0 else
                        MediaType.audio if mtype.value == 1 else
                        MediaType.subtitle),
            width=w.value, height=h.value, sample_rate=rate.value,
            channels=ch.value, config=config, time_base=tb,
            fps=(fpsn.value, fpsd.value), duration=duration)

    def packets(self) -> Iterator[Tuple[int, CodedMediaSample]]:
        """Yield ``(stream_index, sample)`` in container order; samples of
        unsupported codecs are skipped.  pts/dts become exact TimePoints
        via the stream time base (no float rounding)."""
        lib = _lib()
        c = ctypes
        while True:
            idx = c.c_int()
            data = c.c_void_p()
            size = c.c_int()
            pts = c.c_int64()
            dts = c.c_int64()
            duration = c.c_int64()
            flags = c.c_int()
            rc = lib.sv_demux_read(self._h, c.byref(idx), c.byref(data),
                                   c.byref(size), c.byref(pts),
                                   c.byref(dts), c.byref(duration),
                                   c.byref(flags))
            if rc == AVERROR_EOF:
                return
            if rc < 0:
                raise RuntimeError(
                    lib.sv_demux_last_error(self._h).decode())
            info = self.streams[idx.value]
            if info.media_format is None:
                continue
            payload = bytes(c.cast(data, c.POINTER(
                c.c_ubyte * size.value)).contents) if size.value else b""
            num, den = info.time_base
            raw_pts = pts.value if pts.value != AV_NOPTS_VALUE else (
                dts.value if dts.value != AV_NOPTS_VALUE else 0)
            raw_dts = dts.value if dts.value != AV_NOPTS_VALUE else raw_pts
            side = {"config": info.config} if info.config else {}
            yield idx.value, CodedMediaSample(
                buffer=payload,
                pts_value=TimePoint(raw_pts * num, den),
                dts_value=TimePoint(raw_dts * num, den),
                media_type=info.media_type,
                media_format=info.media_format,
                id_asset=self.asset_id, id_workspace=self.workspace_id,
                side=side)

    def seek_start(self) -> None:
        lib = _lib()
        rc = lib.sv_demux_seek_start(self._h)
        if rc < 0:
            raise RuntimeError(lib.sv_demux_last_error(self._h).decode())

    def close(self) -> None:
        if self._h is not None:
            _lib().sv_demux_free(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):  # pragma: no cover - GC safety net
        try:
            self.close()
        except Exception:  # noqa: BLE001
            pass


class MediaFileWriter:
    """Mux CodedMediaSamples into a container (mp4/flv/mkv/webm by file
    extension).  Streams are declared from a representative sample's
    format + config record, then ``write()`` rescales TimePoints into the
    stream time base exactly."""

    _VIDEO_TB = 90000

    def __init__(self, path: str, *, format: Optional[str] = None):
        lib = _lib()
        self._h = lib.sv_mux_open(path.encode(),
                                  (format or "").encode() or None)
        if not self._h:
            raise RuntimeError(f"mux open failed: {path}")
        self._header = False
        self._tb: List[int] = []

    def add_video_stream(self, fmt: MediaFormat, width: int, height: int,
                         config: bytes = b"") -> int:
        lib = _lib()
        idx = lib.sv_mux_add_stream(
            self._h, _FMT_TO_CODEC[fmt].encode(), 0, width, height, 0, 0,
            config or None, len(config), self._VIDEO_TB)
        if idx < 0:
            raise RuntimeError(lib.sv_mux_last_error(self._h).decode())
        self._tb.append(self._VIDEO_TB)
        return idx

    def add_audio_stream(self, fmt: MediaFormat, sample_rate: int,
                         channels: int, config: bytes = b"") -> int:
        lib = _lib()
        idx = lib.sv_mux_add_stream(
            self._h, _FMT_TO_CODEC[fmt].encode(), 1, 0, 0, sample_rate,
            channels, config or None, len(config), sample_rate)
        if idx < 0:
            raise RuntimeError(lib.sv_mux_last_error(self._h).decode())
        self._tb.append(sample_rate)
        return idx

    def write_header(self) -> None:
        lib = _lib()
        if lib.sv_mux_write_header(self._h) < 0:
            raise RuntimeError(lib.sv_mux_last_error(self._h).decode())
        self._header = True

    def write(self, stream_index: int, sample: CodedMediaSample,
              *, duration: Optional[TimePoint] = None) -> None:
        if not self._header:
            self.write_header()
        lib = _lib()
        tb = self._tb[stream_index]

        def scale(tp: TimePoint) -> int:
            return (tp.value * tb) // tp.scale

        from ..media.coded import is_keyframe
        data = sample.data()
        dur = scale(duration) if duration is not None else 0
        rc = lib.sv_mux_write(self._h, stream_index, data, len(data),
                              scale(sample.pts()), scale(sample.dts()),
                              dur, 1 if is_keyframe(sample) else 0, tb)
        if rc < 0:
            raise RuntimeError(lib.sv_mux_last_error(self._h).decode())

    def close(self) -> None:
        if self._h is not None:
            lib = _lib()
            if self._header:
                lib.sv_mux_write_trailer(self._h)
            lib.sv_mux_free(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):  # pragma: no cover - GC safety net
        try:
            self.close()
        except Exception:  # noqa: BLE001
            pass
