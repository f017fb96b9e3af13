"""FileSource: clock-paced demuxer source.

Reference semantics: ``FileSource``
(reference Sources/SwiftVideo_FFmpeg/file.ffmpeg.swift:32-206):
frames are emitted on a clock schedule ~250 ms ahead of their dts with a
2 s read-ahead window, looping via seek + timestamp rebasing.

Backends:

* ``SyntheticSource`` — a frame generator (callable or list) paced with
  the same semantics; the deterministic path for tests and demos.
* cv2-backed file reading (``open_media_file``) — decodes container files
  (mp4/avi/...) into uncompressed CodedMediaSamples when OpenCV can open
  them (no raw bitstream demux without an ffmpeg binary).
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

from ..core import Clock, Source, TimePoint
from ..media.coded import CodedMediaSample, MediaFormat, MediaType
from ..media.picture import ImageBuffer, PictureSample
from ..media.pixel import BufferType, PixelFormat, planes_for_format
from .codecs import pack_uncompressed_picture

_READ_AHEAD = TimePoint(2000, 1000)   # 2 s (file.ffmpeg.swift:184-187)
_EMIT_AHEAD = TimePoint(250, 1000)    # 250 ms (:147-158)


class SyntheticSource(Source):
    """Paced source over a pull function returning CodedMediaSamples.

    ``puller(index)`` returns the sample for frame ``index`` (its pts is
    rewritten onto the pacing timeline) or None at end-of-stream.
    """

    def __init__(self, clock: Clock, puller: Callable[[int],
                                                      Optional[CodedMediaSample]],
                 *, frame_duration: TimePoint, asset_id: str = "file",
                 workspace_id: str = "", loop: bool = False):
        super().__init__()
        self.clock = clock
        self.puller = puller
        self.frame_duration = frame_duration
        self.id_asset = asset_id
        self.id_workspace = workspace_id
        self.loop = loop
        self._index = 0
        self._next_pts = TimePoint(0, frame_duration.scale)
        self._epoch: Optional[TimePoint] = None
        self._playing = False
        self._gen = 0          # bumped by stop(): voids scheduled closures
        self._lock = threading.RLock()
        # fired once when a non-looping pull drains (EOS); the Composer's
        # Load closeOnEnd semantics hang off this (Rpc.public.proto:58)
        self.on_end: Optional[Callable[[], None]] = None
        # resource teardown hook (e.g. terminate a demux subprocess);
        # invoked at most once, by close()
        self.on_close: Optional[Callable[[], None]] = None

    def close(self) -> None:
        """Stop pacing and release puller resources (demux subprocesses,
        pipes).  stop() only pauses; a stopped source can play() again —
        a closed one cannot."""
        self.stop()
        cb, self.on_close = self.on_close, None
        if cb is not None:
            cb()

    def asset_id(self) -> str:
        return self.id_asset

    def workspace_id(self) -> str:
        return self.id_workspace

    def play(self) -> None:
        """file.ffmpeg.swift:95-99"""
        with self._lock:
            if self._playing:
                return
            self._playing = True
            # resume after stop(): rebase the epoch so the pacing horizon
            # lands at _next_pts — a bare `now` would leave the source
            # silent for as long as it had previously played
            self._epoch = self.clock.current() - self._next_pts
        self._refill()

    def stop(self) -> None:
        self._playing = False
        # invalidate frames and refill ticks already scheduled on the
        # clock: their closures check the generation before emitting
        self._gen += 1

    def _refill(self) -> None:
        """Schedule everything inside the read-ahead window
        (file.ffmpeg.swift:115-189)."""
        if not self._playing:
            return
        gen = self._gen
        now = self.clock.current()
        horizon = (now - self._epoch) + _READ_AHEAD
        while self._next_pts < horizon:
            sample = self.puller(self._index)
            if sample is None:
                if not self.loop:
                    self._playing = False
                    if self.on_end is not None:
                        self.on_end()
                    return
                # loop: restart the pull; timestamps rebase implicitly
                # because _next_pts keeps advancing (reset,
                # file.ffmpeg.swift:101-113)
                self._index = 0
                sample = self.puller(0)
                if sample is None:
                    self._playing = False
                    if self.on_end is not None:
                        self.on_end()
                    return
            pts = self._next_pts
            out = sample.with_(pts=pts, dts=pts,
                               asset_id=self.id_asset)
            deadline = self._epoch + pts + _EMIT_AHEAD
            self.clock.schedule(
                deadline,
                lambda _evt, s=out, g=gen:
                    self.emit(s) if self._gen == g else None)
            self._index += 1
            self._next_pts = self._next_pts + self.frame_duration
        # check back in half the read-ahead window
        self.clock.schedule(
            now + _READ_AHEAD / 2,
            lambda _evt, g=gen: self._refill() if self._gen == g else None)


def open_media_file_av(clock: Clock, path: str, *, asset_id: str = "file",
                       workspace_id: str = "", loop: bool = False,
                       sample_rate: int = 48000, channels: int = 2,
                       audio_chunk: int = 1024):
    """Demux EVERY track of a container file like the reference
    (file.ffmpeg.swift:44-72 maps all streams): returns
    ``(video_source, audio_source_or_None)``.

    Prefers the in-process libav backend (real demux + decode, loop
    support via container seek); falls back to the gated ffmpeg subprocess
    backend.  The SyntheticSource pacing (2 s read-ahead, 250 ms
    emit-ahead) applies per track.  Audio is emitted as uncompressed s16i
    CodedMediaSamples in ``audio_chunk``-sample packets at
    ``sample_rate``/``channels``.
    """
    import subprocess
    from .codecs import bitstream_backend, pack_uncompressed_audio
    from .ffmpeg_subprocess import ffmpeg_path
    from .containers import Y4MReader
    from ..media.audio import AudioSample
    import numpy as np

    if bitstream_backend() == "libav":
        return _open_media_file_libav(
            clock, path, asset_id=asset_id, workspace_id=workspace_id,
            loop=loop, sample_rate=sample_rate, channels=channels,
            audio_chunk=audio_chunk)

    exe = ffmpeg_path()
    if exe is None:
        raise RuntimeError("no libav shim or ffmpeg binary "
                           "(use open_media_file for cv2 video-only)")

    def spawn(args):
        return subprocess.Popen([exe, "-hide_banner", "-loglevel", "error",
                                 "-i", path] + args,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.DEVNULL)

    def reap(proc):
        # closing stdout first unblocks a decoder stalled writing into a
        # full pipe; terminate+wait reaps the process either way
        try:
            if proc.stdout is not None:
                proc.stdout.close()
        except Exception:  # noqa: BLE001
            pass
        try:
            proc.terminate()
            proc.wait(timeout=2)
        except Exception:  # noqa: BLE001
            pass

    if loop:
        # the subprocess pipes are one-shot: there is no seek-to-start on
        # a drained decoder (the cv2 backend supports looping)
        raise ValueError("loop=True is not supported by the subprocess "
                         "demux backend; use open_media_file")

    # --- video track ------------------------------------------------------
    vproc = spawn(["-an", "-f", "yuv4mpegpipe", "-pix_fmt", "yuv420p",
                   "pipe:1"])
    y4m = Y4MReader()
    vstate = {"frames": [], "eof": False}

    def vfill():
        while not vstate["frames"] and not vstate["eof"]:
            chunk = vproc.stdout.read(65536)
            if not chunk:
                vstate["eof"] = True
                break
            vstate["frames"].extend(y4m.feed(chunk))

    def vpull(index: int) -> Optional[CodedMediaSample]:
        vfill()
        if not vstate["frames"]:
            return None
        data = vstate["frames"].pop(0)
        w, h = y4m.width, y4m.height
        from .containers import y4m_frame_to_planes
        img = ImageBuffer(PixelFormat.y420p, BufferType.cpu, (w, h),
                          tuple(planes_for_format(PixelFormat.y420p,
                                                  (w, h))),
                          y4m_frame_to_planes(data, w, h))
        pict = PictureSample(img, asset_id, workspace_id)
        return CodedMediaSample(
            buffer=pack_uncompressed_picture(pict),
            pts_value=TimePoint(0, 1000), dts_value=TimePoint(0, 1000),
            media_type=MediaType.video,
            media_format=MediaFormat.uncompressed,
            id_asset=asset_id, id_workspace=workspace_id)

    # prime the reader so the stream header's real frame rate (the y4m
    # 'F' token) paces emission — the cv2 path reads CAP_PROP_FPS the
    # same way; 30 fps only as a last resort
    vfill()
    num, den = y4m.fps if y4m.fps else (30, 1)
    video = SyntheticSource(clock, vpull,
                            frame_duration=TimePoint(den * 1000, num * 1000),
                            asset_id=asset_id, workspace_id=workspace_id,
                            loop=False)
    video.on_close = lambda: reap(vproc)

    # --- audio track (None when the container has no audio) ----------------
    aproc = spawn(["-vn", "-f", "s16le", "-ar", str(sample_rate),
                   "-ac", str(channels), "pipe:1"])
    astate = {"carry": b"", "eof": False}
    chunk_bytes = audio_chunk * channels * 2

    def apull(index: int) -> Optional[CodedMediaSample]:
        while len(astate["carry"]) < chunk_bytes and not astate["eof"]:
            chunk = aproc.stdout.read(65536)
            if not chunk:
                astate["eof"] = True
                break
            astate["carry"] += chunk
        if len(astate["carry"]) < channels * 2:   # nothing left
            return None
        take = min(chunk_bytes, len(astate["carry"]) // (channels * 2)
                   * channels * 2)
        raw, astate["carry"] = astate["carry"][:take], astate["carry"][take:]
        n = len(raw) // (channels * 2)
        pcm = np.frombuffer(raw, np.int16).copy()
        audio = AudioSample(buffers=(pcm,), frequency=sample_rate,
                            channels=channels, format="s16i",
                            sample_count=n, id_asset=asset_id,
                            id_workspace=workspace_id)
        return CodedMediaSample(
            buffer=pack_uncompressed_audio(audio),
            pts_value=TimePoint(0, 1000), dts_value=TimePoint(0, 1000),
            media_type=MediaType.audio,
            media_format=MediaFormat.uncompressed,
            id_asset=asset_id, id_workspace=workspace_id)

    # probe: if the first pull yields nothing, the file has no audio track
    first_audio = apull(0)
    audio_src = None
    if first_audio is not None:
        queued = [first_audio]

        def apull_with_head(index: int) -> Optional[CodedMediaSample]:
            if queued:
                return queued.pop(0)
            return apull(index)

        audio_src = SyntheticSource(
            clock, apull_with_head,
            frame_duration=TimePoint(audio_chunk, sample_rate),
            asset_id=asset_id, workspace_id=workspace_id, loop=False)
        audio_src.on_close = lambda: reap(aproc)
    else:
        reap(aproc)
    return video, audio_src


def _open_media_file_libav(clock: Clock, path: str, *, asset_id: str,
                           workspace_id: str, loop: bool, sample_rate: int,
                           channels: int, audio_chunk: int):
    """In-process demux + decode FileSource backend: one MediaFileReader
    shared by per-track pullers (packets interleave in container order,
    so each puller pumps the shared reader and queues the other track's
    output).  Loop rewinds via container seek + decoder restart — the
    reference's seek-and-rebase (file.ffmpeg.swift:101-113,208-216)."""
    import numpy as np

    from ..media.audio import AudioSample
    from ..mix.src_audio import AudioSampleRateConversion
    from .avformat import MediaFileReader
    from .codecs import pack_uncompressed_audio
    from .libav import LibavAudioDecoder, LibavVideoDecoder

    reader = MediaFileReader(path, asset_id=asset_id,
                             workspace_id=workspace_id)
    vstream = next((s for s in reader.streams
                    if s.media_type == MediaType.video
                    and s.media_format is not None), None)
    astream = next((s for s in reader.streams
                    if s.media_type == MediaType.audio
                    and s.media_format is not None), None)
    if vstream is None and astream is None:
        reader.close()
        raise ValueError(f"no decodable streams in {path}")

    st = {"packets": reader.packets(), "eof": False, "closed": False,
          "vq": [], "aq": [], "pcm": None, "warned": False,
          "vdec": LibavVideoDecoder() if vstream is not None else None,
          "adec": LibavAudioDecoder() if astream is not None else None,
          "src": (AudioSampleRateConversion(sample_rate, channels, "s16i")
                  if astream is not None else None)}
    lock = threading.Lock()

    # one demux pump feeds both tracks, so a track nobody consumes
    # would grow without bound (uncompressed 1080p is ~3 MB/frame; the
    # subprocess backend's full pipes blocked instead).  Bound each
    # queue and drop the OLDEST beyond it — live semantics for an
    # unconsumed track; interleaved containers never come close.
    _VQ_CAP, _AQ_CAP = 128, 4096

    def _bound(key: str, cap: int) -> None:
        if len(st[key]) > cap:
            if not st["warned"]:
                st["warned"] = True
                import logging
                logging.getLogger("swiftvideo_tpu.codec").warning(
                    "open_media_file_av(%s): %s overflow (unconsumed "
                    "track or non-interleaved container); dropping "
                    "oldest beyond %d", path, key, cap)
            del st[key][:len(st[key]) - cap]

    def push_video(picts) -> None:
        for pict in picts:
            st["vq"].append(CodedMediaSample(
                buffer=pack_uncompressed_picture(pict),
                pts_value=pict.pts(), dts_value=pict.pts(),
                media_type=MediaType.video,
                media_format=MediaFormat.uncompressed,
                id_asset=asset_id, id_workspace=workspace_id))
        _bound("vq", _VQ_CAP)

    def push_audio(samples) -> None:
        for audio in samples:
            box = st["src"](audio)
            if box.is_just():
                _append_pcm(box.value())

    def _append_pcm(converted) -> None:
        for audio in (converted if isinstance(converted, list)
                      else [converted]):
            pcm = np.asarray(audio.data()[0]).reshape(-1, channels)
            st["pcm"] = (pcm if st["pcm"] is None
                         else np.concatenate([st["pcm"], pcm], axis=0))
        while st["pcm"] is not None and st["pcm"].shape[0] >= audio_chunk:
            chunk, st["pcm"] = (st["pcm"][:audio_chunk],
                                st["pcm"][audio_chunk:])
            _emit_audio_chunk(chunk)

    def _emit_audio_chunk(chunk) -> None:
        audio = AudioSample(
            buffers=(np.ascontiguousarray(chunk).reshape(-1),),
            frequency=sample_rate, channels=channels, format="s16i",
            sample_count=chunk.shape[0], id_asset=asset_id,
            id_workspace=workspace_id)
        st["aq"].append(CodedMediaSample(
            buffer=pack_uncompressed_audio(audio),
            pts_value=TimePoint(0, 1000), dts_value=TimePoint(0, 1000),
            media_type=MediaType.audio,
            media_format=MediaFormat.uncompressed,
            id_asset=asset_id, id_workspace=workspace_id))
        _bound("aq", _AQ_CAP)

    def _finish_eof() -> None:
        if st["vdec"] is not None:
            push_video(st["vdec"].flush())
        if st["adec"] is not None:
            push_audio(st["adec"].flush())
            for tail in st["src"].flush():
                _append_pcm(tail)
            if st["pcm"] is not None and st["pcm"].shape[0]:
                _emit_audio_chunk(st["pcm"])
                st["pcm"] = None
        st["eof"] = True

    def pump(queue_key: str) -> None:
        """Demux until the wanted queue has something or the file ends."""
        while not st[queue_key] and not st["eof"]:
            try:
                idx, sample = next(st["packets"])
            except StopIteration:
                _finish_eof()
                return
            if vstream is not None and idx == vstream.index:
                box = st["vdec"](sample)
                if box.is_just():
                    push_video(box.value())
            elif astream is not None and idx == astream.index:
                box = st["adec"](sample)
                if box.is_just():
                    push_audio(box.value())

    def restart() -> None:
        """Loop: rewind the container and restart both decode chains."""
        reader.seek_start()
        if st["vdec"] is not None:
            st["vdec"].close()
            st["vdec"] = LibavVideoDecoder()
        if st["adec"] is not None:
            st["adec"].close()
            st["adec"] = LibavAudioDecoder()
            st["src"] = AudioSampleRateConversion(sample_rate, channels,
                                                  "s16i")
            st["pcm"] = None
        st["packets"] = reader.packets()
        st["eof"] = False

    def make_puller(queue_key: str):
        def puller(index: int) -> Optional[CodedMediaSample]:
            with lock:
                if st["closed"]:
                    return None
                pump(queue_key)
                if not st[queue_key] and st["eof"] and loop:
                    # both tracks drained? rewind once; samples still
                    # queued on the OTHER track keep stream order there
                    restart()
                    pump(queue_key)
                if st[queue_key]:
                    return st[queue_key].pop(0)
                return None
        return puller

    def close_all() -> None:
        with lock:
            if st["closed"]:
                return
            st["closed"] = True
            if st["vdec"] is not None:
                st["vdec"].close()
            if st["adec"] is not None:
                st["adec"].close()
            reader.close()

    video = None
    if vstream is not None:
        num, den = vstream.fps if vstream.fps[0] else (30, 1)
        video = SyntheticSource(
            clock, make_puller("vq"),
            frame_duration=TimePoint(den * 1000, num * 1000),
            asset_id=asset_id, workspace_id=workspace_id, loop=loop)
        video.on_close = close_all

    audio_src = None
    if astream is not None:
        # probe one chunk: audio-less containers return None
        head = make_puller("aq")(0)
        if head is not None:
            queued = [head]
            pull = make_puller("aq")

            def apull(index: int) -> Optional[CodedMediaSample]:
                if queued:
                    return queued.pop(0)
                return pull(index)

            audio_src = SyntheticSource(
                clock, apull,
                frame_duration=TimePoint(audio_chunk, sample_rate),
                asset_id=asset_id, workspace_id=workspace_id, loop=loop)
            audio_src.on_close = (close_all if video is None
                                  else (lambda: None))
    if video is None and audio_src is not None:
        audio_src.on_close = close_all
    return video, audio_src


def open_media_file(clock: Clock, path: str, *, asset_id: str = "file",
                    workspace_id: str = "", loop: bool = False
                    ) -> SyntheticSource:
    """cv2-backed file source: decodes frames and re-packages them as
    uncompressed CodedMediaSamples on the pacing timeline (video only —
    cv2 cannot demux audio; :func:`open_media_file_av` covers A+V where
    an ffmpeg binary exists)."""
    import cv2
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise FileNotFoundError(path)
    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    frame_duration = TimePoint(int(round(1000.0 / fps)), 1000)
    lock = threading.Lock()

    def puller(index: int) -> Optional[CodedMediaSample]:
        with lock:
            if index == 0:
                cap.set(cv2.CAP_PROP_POS_FRAMES, 0)
            ok, bgr = cap.read()
        if not ok:
            return None
        rgba = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGBA)
        h, w = rgba.shape[:2]
        img = ImageBuffer(pixel_format=PixelFormat.RGBA,
                          buffer_type=BufferType.cpu, size=(w, h),
                          planes=tuple(planes_for_format(PixelFormat.RGBA,
                                                         (w, h))),
                          buffers=(rgba,))
        pict = PictureSample(img, asset_id, workspace_id)
        return CodedMediaSample(
            buffer=pack_uncompressed_picture(pict),
            pts_value=TimePoint(0, 1000), dts_value=TimePoint(0, 1000),
            media_type=MediaType.video, media_format=MediaFormat.uncompressed,
            id_asset=asset_id, id_workspace=workspace_id)

    return SyntheticSource(clock, puller, frame_duration=frame_duration,
                           asset_id=asset_id, workspace_id=workspace_id,
                           loop=loop)
