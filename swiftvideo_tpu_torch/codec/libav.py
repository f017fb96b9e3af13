"""In-process libavcodec backend (ctypes over ``csrc/libav_shim.cpp``).

Role parity with the reference's linked-FFmpeg codecs — the reference calls
libavcodec in-process from Swift (``dec.video.ffmpeg.swift:24-221``,
``enc.video.ffmpeg.swift:21-297``, ``dec.audio.ffmpeg.swift``,
``enc.audio.ffmpeg.swift``); this backend does the same from Python via a
thin C ABI, so REAL codec bytes flow with no subprocess pipes in between.

Sample conventions match the subprocess backend exactly (AVCC payloads +
``side["config"]`` records in, y420p PictureSamples / s16i AudioSamples out),
so the two backends are interchangeable behind the ``codecs.py`` dispatch.

Timestamps: every packet/frame crossing the ABI carries an opaque int64 id
mapped to a TimePoint on this side — decoders return frames in presentation
order with their original ids, so B-frame reorder is handled by libavcodec
itself rather than the subprocess backend's smallest-pending-pts heuristic
(the reference gets the same guarantee from AVFrame.pts,
dec.video.ffmpeg.swift:144-160).
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core import EventBox, EventError, TimePoint, Tx
from ..media.audio import AudioSample
from ..media.coded import CodedMediaSample, MediaFormat, MediaType
from ..media.picture import ImageBuffer, PictureSample
from ..media.pixel import BufferType, PixelFormat, planes_for_format
from ..ops.barriers import download
from . import bitstream, containers

# --------------------------------------------------------------------------
# library loading / prototypes
# --------------------------------------------------------------------------

_LIB_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_LIB_TRIED = False

_c_ubyte_p = ctypes.POINTER(ctypes.c_ubyte)


def _candidate_paths() -> List[str]:
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return [os.environ.get("SWIFTVIDEO_LIBAV_SHIM", ""),
            os.path.join(here, "csrc", "libsvav.so"),
            "libsvav.so"]


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _LIB_TRIED
    with _LIB_LOCK:
        if _LIB is not None or _LIB_TRIED:
            return _LIB
        _LIB_TRIED = True
        for path in _candidate_paths():
            if not path:
                continue
            try:
                lib = ctypes.CDLL(path)
            except OSError:
                continue
            _prototype(lib)
            lib.sv_av_set_log_level(16)      # AV_LOG_ERROR: no banner spam
            _LIB = lib
            break
        return _LIB


def _prototype(lib: ctypes.CDLL) -> None:
    c = ctypes
    lib.sv_av_set_log_level.argtypes = [c.c_int]
    lib.sv_av_last_error.restype = c.c_char_p
    lib.sv_av_last_error.argtypes = [c.c_void_p]
    lib.sv_av_codec_exists.argtypes = [c.c_char_p, c.c_int]
    lib.sv_dec_open.restype = c.c_void_p
    lib.sv_dec_open.argtypes = [c.c_char_p, c.c_char_p, c.c_int, c.c_int,
                                c.c_int]
    lib.sv_codec_free.argtypes = [c.c_void_p]
    lib.sv_dec_send.argtypes = [c.c_void_p, c.c_char_p, c.c_int, c.c_int64]
    lib.sv_vdec_recv.argtypes = [
        c.c_void_p, c.POINTER(c.c_int), c.POINTER(c.c_int),
        c.POINTER(c.c_char_p), c.POINTER(c.c_int64),
        c.c_void_p, c.c_void_p, c.c_void_p]
    lib.sv_adec_recv.argtypes = [
        c.c_void_p, c.POINTER(c.c_int), c.POINTER(c.c_int),
        c.POINTER(c.c_int), c.POINTER(c.c_char_p), c.POINTER(c.c_int64),
        c.c_void_p]
    lib.sv_venc_open.restype = c.c_void_p
    lib.sv_venc_open.argtypes = [c.c_char_p, c.c_int, c.c_int, c.c_char_p,
                                 c.c_int, c.c_int, c.c_int64, c.c_int,
                                 c.c_char_p]
    lib.sv_enc_extradata.argtypes = [c.c_void_p, c.POINTER(c.c_void_p),
                                     c.POINTER(c.c_int)]
    lib.sv_venc_send.argtypes = [c.c_void_p, c.POINTER(c.c_void_p),
                                 c.POINTER(c.c_int), c.c_int64, c.c_int]
    lib.sv_enc_recv.argtypes = [c.c_void_p, c.POINTER(c.c_void_p),
                                c.POINTER(c.c_int), c.POINTER(c.c_int64),
                                c.POINTER(c.c_int64), c.POINTER(c.c_int)]
    lib.sv_aenc_open.restype = c.c_void_p
    lib.sv_aenc_open.argtypes = [c.c_char_p, c.c_int, c.c_int, c.c_char_p,
                                 c.c_int64, c.c_char_p]
    lib.sv_aenc_frame_size.argtypes = [c.c_void_p]
    lib.sv_aenc_send.argtypes = [c.c_void_p, c.POINTER(c.c_void_p), c.c_int,
                                 c.c_int64]


def libav_available() -> bool:
    """True when the native shim loads (system FFmpeg libraries present)."""
    return _load() is not None


AVERROR_EOF = -541478725  # FFERRTAG('E','O','F',' ')


def _err(handle) -> str:
    lib = _load()
    msg = lib.sv_av_last_error(ctypes.c_void_p(handle))
    return msg.decode("utf-8", "replace") if msg else "unknown libav error"


def _copy_bytes(ptr: ctypes.c_void_p, size: int) -> bytes:
    if not ptr or size <= 0:
        return b""
    return bytes(ctypes.cast(ptr, ctypes.POINTER(
        ctypes.c_ubyte * size)).contents)


class _PtsMap:
    """Opaque int64 id <-> TimePoint (ids survive codec reorder)."""

    def __init__(self):
        self._seq = 0
        self._map: Dict[int, TimePoint] = {}

    def put(self, pts: TimePoint) -> int:
        self._seq += 1
        self._map[self._seq] = pts
        return self._seq

    def take(self, key: int, fallback: TimePoint) -> TimePoint:
        return self._map.pop(key, fallback)

    def clear(self) -> None:
        self._map.clear()


# --------------------------------------------------------------------------
# video decoder
# --------------------------------------------------------------------------

_DEC_NAMES = {MediaFormat.avc: b"h264", MediaFormat.hevc: b"hevc",
              MediaFormat.vp8: b"vp8", MediaFormat.vp9: b"vp9",
              MediaFormat.av1: b"libdav1d"}

_PIX_FMTS = {b"yuv420p": PixelFormat.y420p, b"yuvj420p": PixelFormat.y420p,
             b"nv12": PixelFormat.nv12, b"nv21": PixelFormat.nv21}


class LibavVideoDecoder(Tx):
    """Tx[CodedMediaSample, List[PictureSample]] over in-process libavcodec
    (dec.video.ffmpeg.swift:24-221 role, same sample contract as
    FFmpegVideoDecoder)."""

    def __init__(self):
        self._h = None
        self._fmt: Optional[MediaFormat] = None
        self._pts = _PtsMap()
        self._meta: Optional[CodedMediaSample] = None
        self._primed_config = b""
        super().__init__(self._impl)

    def _ensure(self, sample: CodedMediaSample) -> None:
        if self._h is not None:
            return
        lib = _load()
        if lib is None:
            raise RuntimeError("libav shim not available")
        config = sample.side_data().get("config", b"")
        # avc/hevc: the avcC/hvcC record as extradata switches libavcodec
        # into length-prefixed (AVCC) packet mode — our wire format already
        self._h = lib.sv_dec_open(_DEC_NAMES[sample.media_format],
                                  config or None, len(config), 0, 0)
        if not self._h:
            raise RuntimeError(
                f"libav decoder open failed for {sample.media_format.name}")
        self._fmt = sample.media_format
        self._primed_config = config

    def _drain(self) -> List[PictureSample]:
        lib = _load()
        meta = self._meta
        out: List[PictureSample] = []
        while True:
            w = ctypes.c_int()
            h = ctypes.c_int()
            fmt_name = ctypes.c_char_p()
            pts_id = ctypes.c_int64()
            planes = (ctypes.c_void_p * 4)()
            strides = (ctypes.c_int * 4)()
            heights = (ctypes.c_int * 4)()
            rc = lib.sv_vdec_recv(self._h, ctypes.byref(w), ctypes.byref(h),
                                  ctypes.byref(fmt_name),
                                  ctypes.byref(pts_id), planes, strides,
                                  heights)
            if rc == 0 or rc == AVERROR_EOF:
                return out
            if rc < 0:
                raise RuntimeError(_err(self._h))
            pix = _PIX_FMTS.get(fmt_name.value or b"")
            if pix is None:
                raise RuntimeError(
                    f"unsupported decode pixel format "
                    f"{(fmt_name.value or b'?').decode()}")
            bufs = []
            specs = planes_for_format(pix, (w.value, h.value))
            for i, _spec in enumerate(specs):
                ph = heights[i]
                stride = strides[i]
                row_bytes = {0: w.value}.get(i, None)
                if row_bytes is None:
                    # chroma plane width: y420p u/v are w/2; nv12/nv21
                    # interleave two channels into w bytes
                    row_bytes = (w.value if pix in (PixelFormat.nv12,
                                                    PixelFormat.nv21)
                                 else (w.value + 1) // 2)
                arr = np.ctypeslib.as_array(
                    ctypes.cast(planes[i], _c_ubyte_p),
                    (ph, stride))[:, :row_bytes].copy()
                bufs.append(arr)
            img = ImageBuffer(pix, BufferType.cpu, (w.value, h.value),
                              tuple(specs), tuple(bufs))
            pts = self._pts.take(pts_id.value, meta.pts())
            out.append(PictureSample(
                img, meta.asset_id(), meta.workspace_id(),
                time_point=meta.time(), pts_value=pts,
                event_info=meta.info()))

    def _impl(self, sample: CodedMediaSample) -> EventBox:
        if sample.media_format not in _DEC_NAMES:
            return EventBox.nothing(sample.info())
        pending: List[PictureSample] = []
        cfg = sample.side_data().get("config", b"")
        if (self._h is not None and cfg and cfg != self._primed_config
                and sample.media_format in (MediaFormat.avc,
                                            MediaFormat.hevc)):
            # mid-stream parameter-set change: packets stay AVCC keyed to
            # the open decoder's extradata, so drain and re-open with the
            # new record (same segment-boundary semantics as the
            # subprocess backend and enc.video.ffmpeg.swift:92-130)
            pending = self.flush()
            self.close()
            self._pts.clear()
        try:
            self._ensure(sample)
        except Exception as exc:  # noqa: BLE001
            return EventBox.error(EventError("libav.dec", -1, str(exc)))
        lib = _load()
        self._meta = sample
        pts_id = self._pts.put(sample.pts())
        data = sample.data()
        rc = lib.sv_dec_send(self._h, data, len(data), pts_id)
        if rc < 0:
            return EventBox.error(EventError("libav.dec", rc,
                                             _err(self._h)))
        try:
            out = pending + self._drain()
        except Exception as exc:  # noqa: BLE001
            return EventBox.error(EventError("libav.dec", -1, str(exc)))
        if not out:
            return EventBox.nothing(sample.info())
        return EventBox.just(out)

    def flush(self) -> List[PictureSample]:
        """End of stream: frames still buffered inside the decoder."""
        if self._h is None:
            return []
        lib = _load()
        lib.sv_dec_send(self._h, None, 0, 0)
        try:
            return self._drain()
        except Exception:  # noqa: BLE001
            return []

    def close(self) -> None:
        if self._h is not None:
            _load().sv_codec_free(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover - GC safety net
        try:
            self.close()
        except Exception:  # noqa: BLE001
            pass


# --------------------------------------------------------------------------
# video encoder
# --------------------------------------------------------------------------

_ENC_NAMES = {MediaFormat.avc: b"libx264", MediaFormat.hevc: b"libx265",
              MediaFormat.vp8: b"libvpx", MediaFormat.vp9: b"libvpx-vp9",
              MediaFormat.av1: b"libaom-av1"}


class LibavVideoEncoder(Tx):
    """Tx[PictureSample, List[CodedMediaSample]] over in-process libavcodec
    with the reference's low-latency operating point
    (enc.video.ffmpeg.swift:240-265), same sample contract as
    FFmpegVideoEncoder (AVCC payloads + config record side data)."""

    def __init__(self, fmt: MediaFormat = MediaFormat.avc,
                 bitrate: int = 3_000_000, fps: int = 30,
                 keyframe_interval_s: float = 2.0):
        if fmt not in _ENC_NAMES:
            raise ValueError(f"unsupported encode format {fmt.name}")
        self.fmt = fmt
        self.bitrate = bitrate
        self.fps = fps
        self.keyint = max(1, int(round(keyframe_interval_s * fps)))
        self._h = None
        self._size: Optional[Tuple[int, int]] = None
        self._pts = _PtsMap()
        self._config: Optional[bytes] = None
        self._meta: Optional[PictureSample] = None
        super().__init__(self._impl)

    # the same zero-latency operating points as the subprocess backend
    def _opts(self) -> bytes:
        if self.fmt == MediaFormat.avc:
            return (f"preset=veryfast,tune=zerolatency,x264-params="
                    f"keyint={self.keyint}:min-keyint={self.keyint}:"
                    f"scenecut=0:bframes=0:rc-lookahead=0:sync-lookahead=0"
                    ).encode()
        if self.fmt == MediaFormat.hevc:
            return (f"preset=ultrafast,x265-params=keyint={self.keyint}:"
                    f"min-keyint={self.keyint}:scenecut=0:bframes=0:"
                    f"rc-lookahead=0").encode()
        if self.fmt == MediaFormat.av1:
            return b"usage=realtime,cpu-used=8,lag-in-frames=0"
        return b"deadline=realtime,cpu-used=8,lag-in-frames=0"

    def _ensure(self, sample: PictureSample) -> None:
        if self._h is not None:
            return
        lib = _load()
        if lib is None:
            raise RuntimeError("libav shim not available")
        w, h = sample.size()
        self._h = lib.sv_venc_open(_ENC_NAMES[self.fmt], w, h, b"yuv420p",
                                   self.fps, 1, self.bitrate, self.keyint,
                                   self._opts())
        if not self._h:
            raise RuntimeError(
                f"libav encoder open failed for {self.fmt.name}")
        self._size = (w, h)
        self._config = self._config_from_extradata()

    def _extradata(self) -> bytes:
        lib = _load()
        ptr = ctypes.c_void_p()
        size = ctypes.c_int()
        lib.sv_enc_extradata(self._h, ctypes.byref(ptr), ctypes.byref(size))
        return _copy_bytes(ptr, size.value)

    def _config_from_extradata(self) -> Optional[bytes]:
        """Build the wire config record from GLOBAL_HEADER extradata:
        Annex-B parameter sets for x264/x265, nothing for vpx/aom (their
        records come from the first keyframe payload instead)."""
        from .ffmpeg_subprocess import make_avcdcr, split_annexb
        extra = self._extradata()
        if self.fmt == MediaFormat.avc:
            nals = split_annexb(extra)
            sps = next((n for n in nals if n and n[0] & 0x1F == 7), None)
            pps = next((n for n in nals if n and n[0] & 0x1F == 8), None)
            return make_avcdcr(sps, pps) if sps and pps else None
        if self.fmt == MediaFormat.hevc:
            nals = split_annexb(extra)
            by_type = {}
            for n in nals:
                if n:
                    by_type.setdefault((n[0] >> 1) & 0x3F, n)
            if all(t in by_type for t in (32, 33, 34)):
                return containers.make_hvcc(by_type[32], by_type[33],
                                            by_type[34])
        return None

    def _payload(self, pkt: bytes, keyframe: bool) -> Optional[bytes]:
        from .ffmpeg_subprocess import annexb_to_avcc, split_annexb
        if self.fmt in (MediaFormat.avc, MediaFormat.hevc):
            params = (7, 8, 9) if self.fmt == MediaFormat.avc \
                else (32, 33, 34, 35)
            nals = [n for n in split_annexb(pkt) if n and
                    ((n[0] & 0x1F) if self.fmt == MediaFormat.avc
                     else (n[0] >> 1) & 0x3F) not in params]
            return annexb_to_avcc(b"".join(b"\x00\x00\x00\x01" + n
                                           for n in nals)) or None
        if self._config is None and keyframe and self.fmt != MediaFormat.vp8:
            try:
                self._config = (containers.make_vpcc(pkt)
                                if self.fmt == MediaFormat.vp9
                                else containers.make_av1c(pkt))
            except (ValueError, IndexError):
                pass
        return pkt or None

    def _drain(self) -> List[CodedMediaSample]:
        lib = _load()
        meta = self._meta
        out: List[CodedMediaSample] = []
        while True:
            data = ctypes.c_void_p()
            size = ctypes.c_int()
            pts_id = ctypes.c_int64()
            dts_id = ctypes.c_int64()
            flags = ctypes.c_int()
            rc = lib.sv_enc_recv(self._h, ctypes.byref(data),
                                 ctypes.byref(size), ctypes.byref(pts_id),
                                 ctypes.byref(dts_id), ctypes.byref(flags))
            if rc == 0 or rc == AVERROR_EOF:
                return out
            if rc < 0:
                raise RuntimeError(_err(self._h))
            pkt = _copy_bytes(data, size.value)
            pts = self._pts.take(pts_id.value, meta.pts())
            payload = self._payload(pkt, bool(flags.value & 1))
            if payload is None or self._config is None and \
                    self.fmt != MediaFormat.vp8:
                continue
            side = ({"config": self._config}
                    if self._config is not None else {})
            out.append(CodedMediaSample(
                buffer=payload, pts_value=pts, dts_value=pts,
                media_type=MediaType.video, media_format=self.fmt,
                id_asset=meta.asset_id(),
                id_workspace=meta.workspace_id(),
                time_point=meta.time(), side=side,
                event_info=meta.info()))

    def _impl(self, sample: PictureSample) -> EventBox:
        if sample.pixel_format() != PixelFormat.y420p:
            return EventBox.error(EventError("libav.enc", -2,
                                             "encoder wants y420p"))
        pending: List[CodedMediaSample] = []
        if self._h is not None and tuple(sample.size()) != self._size:
            # mid-stream resolution change: re-create the codec context at
            # the new size (enc.video.ffmpeg.swift:92-130)
            try:
                pending = self.flush()
            except Exception:  # noqa: BLE001
                pending = []
            self.close()
            self._pts.clear()
            self._config = None
        try:
            self._ensure(sample)
        except Exception as exc:  # noqa: BLE001
            return EventBox.error(EventError("libav.enc", -1, str(exc)))
        lib = _load()
        self._meta = sample
        pts_id = self._pts.put(sample.pts())
        arrs = [np.ascontiguousarray(download(p)) for p in sample.planes()]
        planes = (ctypes.c_void_p * 3)(*[a.ctypes.data for a in arrs])
        strides = (ctypes.c_int * 3)(*[a.shape[-1] for a in arrs])
        rc = lib.sv_venc_send(self._h, planes, strides, pts_id, 0)
        if rc < 0:
            return EventBox.error(EventError("libav.enc", rc,
                                             _err(self._h)))
        try:
            out = pending + self._drain()
        except Exception as exc:  # noqa: BLE001
            return EventBox.error(EventError("libav.enc", -1, str(exc)))
        if not out:
            return EventBox.nothing(sample.info())
        return EventBox.just(out)

    def flush(self) -> List[CodedMediaSample]:
        """End of stream: drain packets still buffered inside the encoder."""
        if self._h is None or self._meta is None:
            return []
        lib = _load()
        lib.sv_venc_send(self._h, None, None, 0, 0)
        try:
            return self._drain()
        except Exception:  # noqa: BLE001
            return []

    def close(self) -> None:
        if self._h is not None:
            _load().sv_codec_free(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover - GC safety net
        try:
            self.close()
        except Exception:  # noqa: BLE001
            pass


# --------------------------------------------------------------------------
# audio decoder
# --------------------------------------------------------------------------

def _strip_adts(payload: bytes) -> bytes:
    """Raw AAC frame from a possibly ADTS-framed packet (syncword guard
    around the shared header-length logic in ffmpeg_subprocess)."""
    if len(payload) >= 7 and payload[0] == 0xFF and \
            (payload[1] & 0xF0) == 0xF0:
        from .ffmpeg_subprocess import adts_payload
        return adts_payload(payload)
    return payload


_SAMPLE_DTYPES = {b"s16": np.int16, b"s16p": np.int16,
                  b"flt": np.float32, b"fltp": np.float32,
                  b"s32": np.int32, b"s32p": np.int32}


class LibavAudioDecoder(Tx):
    """Tx[CodedMediaSample, List[AudioSample]] for AAC/Opus over in-process
    libavcodec (dec.audio.ffmpeg.swift:24-211 role): output is interleaved
    s16 in ``chunk_samples`` chunks, pts anchored at the first input pts
    minus known priming — the same contract as FFmpegAudioDecoder."""

    _FORMATS = (MediaFormat.aac, MediaFormat.opus)

    def __init__(self, *, chunk_samples: int = 1024,
                 priming_samples: int = 0):
        self._h = None
        self._rate: Optional[int] = None
        self._channels: Optional[int] = None
        self._pcm: Optional[np.ndarray] = None   # (n, ch) s16 carry
        self._next_pts: Optional[TimePoint] = None
        self._first_pts: Optional[TimePoint] = None
        self._meta: Optional[CodedMediaSample] = None
        self._primed_config = b""
        self.chunk_samples = chunk_samples
        self.priming_samples = priming_samples
        super().__init__(self._impl)

    def _ensure(self, sample: CodedMediaSample) -> None:
        if self._h is not None:
            return
        lib = _load()
        if lib is None:
            raise RuntimeError("libav shim not available")
        config = sample.side_data().get("config", b"")
        if sample.media_format == MediaFormat.aac:
            channels, rate, _spf = bitstream.aac_parse_asc(config)
            self._h = lib.sv_dec_open(b"aac", config, len(config), rate,
                                      channels)
        else:
            channels = 2
            if config[:8] == b"OpusHead":
                channels = containers.parse_opus_head(config)["channels"]
            rate = 48000
            self._h = lib.sv_dec_open(b"opus", config or None, len(config),
                                      rate, channels)
        if not self._h:
            raise RuntimeError(
                f"libav decoder open failed for {sample.media_format.name}")
        self._rate, self._channels = rate, channels
        self._primed_config = config

    def _receive_pcm(self) -> None:
        """Drain decoded frames into the interleaved s16 carry buffer."""
        lib = _load()
        while True:
            rate = ctypes.c_int()
            ch = ctypes.c_int()
            n = ctypes.c_int()
            fmt_name = ctypes.c_char_p()
            pts_id = ctypes.c_int64()
            planes = (ctypes.c_void_p * 8)()
            rc = lib.sv_adec_recv(self._h, ctypes.byref(rate),
                                  ctypes.byref(ch), ctypes.byref(n),
                                  ctypes.byref(fmt_name),
                                  ctypes.byref(pts_id), planes)
            if rc == 0 or rc == AVERROR_EOF:
                return
            if rc < 0:
                raise RuntimeError(_err(self._h))
            fmt = fmt_name.value or b""
            dtype = _SAMPLE_DTYPES.get(fmt)
            if dtype is None:
                raise RuntimeError(f"unsupported sample format "
                                   f"{fmt.decode()}")
            planar = fmt.endswith(b"p")
            count, nch = n.value, ch.value
            if planar:
                chans = [np.ctypeslib.as_array(
                    ctypes.cast(planes[i],
                                ctypes.POINTER(np.ctypeslib.as_ctypes_type(
                                    dtype))), (count,)).copy()
                    for i in range(nch)]
                pcm = np.stack(chans, axis=1)
            else:
                pcm = np.ctypeslib.as_array(
                    ctypes.cast(planes[0],
                                ctypes.POINTER(np.ctypeslib.as_ctypes_type(
                                    dtype))), (count * nch,)
                ).copy().reshape(count, nch)
            if dtype == np.float32:
                pcm = np.clip(np.rint(pcm.astype(np.float64) * 32768.0),
                              -32768, 32767).astype(np.int16)
            elif dtype == np.int32:
                pcm = (pcm >> 16).astype(np.int16)
            self._pcm = (pcm if self._pcm is None
                         else np.concatenate([self._pcm, pcm], axis=0))

    def _emit_chunks(self, *, final: bool = False) -> List[AudioSample]:
        meta = self._meta
        out: List[AudioSample] = []
        step = self.chunk_samples
        while self._pcm is not None:
            avail = self._pcm.shape[0]
            n = avail if (final and avail) else (step if avail >= step else 0)
            if n == 0:
                break
            pcm, self._pcm = self._pcm[:n], self._pcm[n:]
            if self._pcm.shape[0] == 0:
                self._pcm = None
            if self._next_pts is None:
                anchor = (self._first_pts if self._first_pts is not None
                          else meta.pts())
                if self.priming_samples:
                    anchor = anchor - TimePoint(self.priming_samples,
                                                self._rate)
                self._next_pts = anchor
            pts = self._next_pts
            self._next_pts = pts + TimePoint(n, self._rate)
            out.append(AudioSample(
                buffers=(np.ascontiguousarray(pcm).reshape(-1),),
                frequency=self._rate, channels=self._channels,
                format="s16i", sample_count=n,
                id_asset=meta.asset_id(), id_workspace=meta.workspace_id(),
                pts_value=pts, time_point=meta.time(),
                event_info=meta.info()))
        return out

    def _impl(self, sample: CodedMediaSample) -> EventBox:
        if sample.media_format not in self._FORMATS:
            return EventBox.nothing(sample.info())
        pending: List[AudioSample] = []
        cfg = sample.side_data().get("config", b"")
        if self._h is not None and cfg and cfg != self._primed_config:
            # mid-stream ASC/OpusHead change: drain and restart at the new
            # segment, re-anchoring pts (same as the subprocess backend)
            pending = self.flush()
            self.close()
            self._pcm = None
            self._next_pts = None
            self._first_pts = None
        try:
            self._ensure(sample)
            self._meta = sample
            if self._first_pts is None:
                self._first_pts = sample.pts()
            data = sample.data()
            if sample.media_format == MediaFormat.aac:
                data = _strip_adts(data)
            lib = _load()
            # opaque id 0: audio pts is derived from the first-pts /
            # priming anchor in _emit_chunks, never from the frame's
            # returned id — putting every packet here leaked one map
            # entry per packet for the decoder's lifetime
            rc = lib.sv_dec_send(self._h, data, len(data), 0)
            if rc < 0:
                raise RuntimeError(_err(self._h))
            self._receive_pcm()
            out = pending + self._emit_chunks()
        except Exception as exc:  # noqa: BLE001
            return EventBox.error(EventError("libav.dec.audio", -1,
                                             str(exc)))
        if not out:
            return EventBox.nothing(sample.info())
        return EventBox.just(out)

    def flush(self) -> List[AudioSample]:
        if self._h is None:
            return []
        lib = _load()
        lib.sv_dec_send(self._h, None, 0, 0)
        try:
            self._receive_pcm()
            return self._emit_chunks(final=True)
        except Exception:  # noqa: BLE001
            return []

    def close(self) -> None:
        if self._h is not None:
            _load().sv_codec_free(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover - GC safety net
        try:
            self.close()
        except Exception:  # noqa: BLE001
            pass


# --------------------------------------------------------------------------
# audio encoder
# --------------------------------------------------------------------------

class LibavAudioEncoder(Tx):
    """Tx[AudioSample, List[CodedMediaSample]] for AAC/Opus over in-process
    libavcodec (enc.audio.ffmpeg.swift:119-160 role): s16i input is
    accumulated to the codec's exact frame size (the reference's makeAVFrame
    loop), packets carry the REAL AudioSpecificConfig / OpusHead from the
    codec's extradata in ``side["config"]``."""

    def __init__(self, fmt: MediaFormat = MediaFormat.aac,
                 bitrate: int = 96_000):
        if fmt not in (MediaFormat.aac, MediaFormat.opus):
            raise ValueError(f"unsupported audio encode format {fmt.name}")
        self.fmt = fmt
        self.bitrate = bitrate
        self._h = None
        self._rate: Optional[int] = None
        self._channels: Optional[int] = None
        self._frame_size = 0
        self._pcm: Optional[np.ndarray] = None
        self._config: Optional[bytes] = None
        self._next_pts: Optional[TimePoint] = None
        self._first_pts: Optional[TimePoint] = None
        self._in_pts = 0  # input sample counter for encoder frame pts
        self._meta: Optional[AudioSample] = None
        super().__init__(self._impl)

    def _ensure(self, sample: AudioSample) -> None:
        if self._h is not None:
            return
        lib = _load()
        if lib is None:
            raise RuntimeError("libav shim not available")
        rate, channels = sample.sample_rate(), sample.number_channels()
        if self.fmt == MediaFormat.aac:
            self._h = lib.sv_aenc_open(b"aac", rate, channels, b"fltp",
                                       self.bitrate, None)
        else:
            if rate not in (48000, 24000, 16000, 12000, 8000):
                raise RuntimeError(
                    f"opus encode wants 8/12/16/24/48 kHz input, got {rate}"
                    " (resample first: ops/resample.py)")
            self._h = lib.sv_aenc_open(b"libopus", rate, channels, b"s16",
                                       self.bitrate, None)
        if not self._h:
            raise RuntimeError(
                f"libav encoder open failed for {self.fmt.name}")
        self._rate, self._channels = rate, channels
        self._frame_size = lib.sv_aenc_frame_size(self._h) or 1024
        ptr = ctypes.c_void_p()
        size = ctypes.c_int()
        lib.sv_enc_extradata(self._h, ctypes.byref(ptr), ctypes.byref(size))
        self._config = _copy_bytes(ptr, size.value) or None

    def _send_frames(self, *, final: bool = False) -> None:
        lib = _load()
        step = self._frame_size
        while self._pcm is not None and (
                self._pcm.shape[0] >= step
                or (final and self._pcm.shape[0] > 0)):
            n = min(step, self._pcm.shape[0])
            chunk, self._pcm = self._pcm[:n], self._pcm[n:]
            if self._pcm.shape[0] == 0:
                self._pcm = None
            if self.fmt == MediaFormat.aac:
                flt = (chunk.astype(np.float32) / 32768.0)
                arrs = [np.ascontiguousarray(flt[:, c])
                        for c in range(self._channels)]
            else:
                arrs = [np.ascontiguousarray(chunk.reshape(-1))]
            planes = (ctypes.c_void_p * len(arrs))(
                *[a.ctypes.data for a in arrs])
            rc = lib.sv_aenc_send(self._h, planes, n, self._in_pts)
            self._in_pts += n
            if rc < 0:
                raise RuntimeError(_err(self._h))

    def _emit(self, payload: bytes,
              duration: TimePoint) -> CodedMediaSample:
        meta = self._meta
        if self._next_pts is None:
            self._next_pts = (self._first_pts if self._first_pts is not None
                              else meta.pts())
        pts = self._next_pts
        self._next_pts = pts + duration
        side = {"config": self._config} if self._config else {}
        return CodedMediaSample(
            buffer=payload, pts_value=pts, dts_value=pts,
            media_type=MediaType.audio, media_format=self.fmt,
            id_asset=meta.asset_id(), id_workspace=meta.workspace_id(),
            time_point=meta.time(), side=side, event_info=meta.info())

    def _drain(self) -> List[CodedMediaSample]:
        lib = _load()
        out: List[CodedMediaSample] = []
        while True:
            data = ctypes.c_void_p()
            size = ctypes.c_int()
            pts = ctypes.c_int64()
            dts = ctypes.c_int64()
            flags = ctypes.c_int()
            rc = lib.sv_enc_recv(self._h, ctypes.byref(data),
                                 ctypes.byref(size), ctypes.byref(pts),
                                 ctypes.byref(dts), ctypes.byref(flags))
            if rc == 0 or rc == AVERROR_EOF:
                return out
            if rc < 0:
                raise RuntimeError(_err(self._h))
            payload = _copy_bytes(data, size.value)
            if self.fmt == MediaFormat.aac:
                duration = TimePoint(self._frame_size, self._rate)
            else:
                # Opus TOC durations are ALWAYS in 48 kHz units
                # regardless of the encoder input rate (RFC 6716 3.1)
                duration = TimePoint(
                    containers.opus_packet_samples(payload), 48000)
            out.append(self._emit(payload, duration))

    def _impl(self, sample: AudioSample) -> EventBox:
        if sample.format != "s16i":
            return EventBox.error(EventError("libav.enc.audio", -2,
                                             "encoder wants s16i input"))
        pending: List[CodedMediaSample] = []
        if self._h is not None and (
                sample.sample_rate() != self._rate
                or sample.number_channels() != self._channels):
            # mid-stream rate/channel change: restart at the new layout
            try:
                pending = self.flush()
            except Exception:  # noqa: BLE001
                pending = []
            self.close()
            self._pcm = None
            self._config = None
            self._next_pts = None
            self._first_pts = None
            self._in_pts = 0
        try:
            self._ensure(sample)
            self._meta = sample
            if self._first_pts is None:
                self._first_pts = sample.pts()
            pcm = download(sample.data()[0]).reshape(
                sample.number_samples(), self._channels)
            self._pcm = (pcm if self._pcm is None
                         else np.concatenate([self._pcm, pcm], axis=0))
            self._send_frames()
            out = pending + self._drain()
        except Exception as exc:  # noqa: BLE001
            return EventBox.error(EventError("libav.enc.audio", -1,
                                             str(exc)))
        if not out:
            return EventBox.nothing(sample.info())
        return EventBox.just(out)

    def flush(self) -> List[CodedMediaSample]:
        if self._h is None:
            return []
        lib = _load()
        try:
            self._send_frames(final=True)
            lib.sv_aenc_send(self._h, None, 0, 0)
            return self._drain()
        except Exception:  # noqa: BLE001
            return []

    def close(self) -> None:
        if self._h is not None:
            _load().sv_codec_free(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover - GC safety net
        try:
            self.close()
        except Exception:  # noqa: BLE001
            pass
