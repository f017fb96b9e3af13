"""VideoMixer: clock-driven composited frame source.

Reference semantics: SwiftVideo's ``Sources/SwiftVideo/mix.video.swift``,
as ported by ``swiftvideo_tpu/mix/video_mixer.py``.

Every ``frame_duration`` tick the mixer merges **two generations** of
per-revision sample maps (fresh frames win; the previous generation repeats
a source's last frame when no new one arrived — mix.video.swift:105-114),
z-sorts them, and composites the whole frame in one call.

On a cuda context (the default) with a y420p / nv12 / nv21 / RGBA / BGRA
target that call is one launch of the frame kernel (ops/frame.py); a
y422p / y444p target, and a cpu context, take the plain torch version
(ops/composite.py).  Emitted frames
hold tensors on the context's device (``BufferType.gpu`` on the card).  pts
comes from the clock tick, never from device completion.
"""

from __future__ import annotations

import threading
import uuid
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core import (Clock, ClockTickEvent, EventBox, Source,
                    StatsReport, TimePoint, rescale)
from ..media.picture import BufferType, ImageBuffer, PictureSample
from ..media.pixel import PixelFormat, planes_for_format

from ..ops.registry import (ComputeContext, composite_frame,
                            make_compute_context, to_device)
from ..ops.uniforms import ImageUniforms


class VideoMixer(Source):
    def __init__(self, clock: Clock, *, workspace_id: str,
                 frame_duration: TimePoint, output_size: Tuple[int, int],
                 output_format: PixelFormat = PixelFormat.nv12,
                 compute_context: Optional[ComputeContext] = None,
                 asset_id: Optional[str] = None,
                 stats_report: Optional[StatsReport] = None,
                 epoch: Optional[int] = None):
        super().__init__()
        self.clock = clock
        self.frame_duration = frame_duration
        self.output_size = tuple(output_size)
        self.output_format = output_format
        self.ctx = compute_context or make_compute_context()
        self.id_workspace = workspace_id
        self.id_asset = asset_id or str(uuid.uuid4())
        self.stats = stats_report or StatsReport(asset_id=self.id_asset,
                                                 clock=clock)
        now = clock.current()
        epoch_tp = (clock.from_unix_time(epoch) if epoch is not None else now)
        self.epoch = rescale(epoch_tp, frame_duration.scale)
        # two generations of per-revision sample maps (mix.video.swift:44)
        self._samples: List[Dict[str, PictureSample]] = [{}, {}]
        self._lock = threading.RLock()
        self._closed = False

        def digest(pic: PictureSample) -> EventBox:
            if pic.asset_id() != self.id_asset:
                with self._lock:
                    self._samples[0][pic.revision()] = pic
                return EventBox.nothing(pic.info())
            return EventBox.just(pic)

        self.set(digest)
        clock.schedule(now + frame_duration, self._mix)

    def asset_id(self) -> str:
        return self.id_asset

    def workspace_id(self) -> str:
        return self.id_workspace

    def compute_context(self) -> ComputeContext:
        return self.ctx

    def close(self) -> None:
        self._closed = True
        self.stats.close()

    # --- tick (mix.video.swift:95-131) -----------------------------------
    def _mix(self, at: ClockTickEvent) -> None:
        if self._closed:
            return
        pts = at.time() - self.epoch
        self.clock.schedule(at.time() + self.frame_duration, self._mix)
        self.stats.end_timer("mix.video.delta")
        self.stats.start_timer("mix.video.delta")
        self.stats.start_timer("mix.video.compose")
        with self._lock:
            merged = dict(self._samples[1])
            merged.update(self._samples[0])  # fresh generation wins
            self._samples[1] = self._samples[0]
            self._samples[0] = {}
        images = sorted(merged.values(), key=lambda s: s.z_index())
        try:
            sources = []
            for img in images:
                try:
                    uni = ImageUniforms(
                        transform_inv=np.linalg.inv(
                            img.matrix().astype(np.float64)).astype(np.float32),
                        texture_inv=np.linalg.inv(
                            img.texture_matrix().astype(np.float64)).astype(np.float32),
                        border_inv=np.linalg.inv(
                            img.border_matrix().astype(np.float64)).astype(np.float32),
                        fill_color=np.asarray(img.fill_color(), np.float32),
                        input_size=img.size(), output_size=self.output_size,
                        opacity=img.opacity())
                except np.linalg.LinAlgError:
                    # degenerate transform (zero-size element): skip the
                    # source, keep the frame
                    continue
                sources.append((to_device(img.planes(), self.ctx.device),
                                img.pixel_format(), uni))
            planes = composite_frame(self.ctx, self.output_format,
                                     self.output_size, sources)
            self.stats.end_timer("mix.video.compose")
            img = ImageBuffer(
                pixel_format=self.output_format,
                buffer_type=(BufferType.gpu if self.ctx.kind == "cuda"
                             else BufferType.cpu),
                size=self.output_size,
                planes=tuple(planes_for_format(self.output_format,
                                               self.output_size)),
                buffers=tuple(planes))
            sample = PictureSample(
                img, self.id_asset, self.id_workspace,
                time_point=at.time(), pts_value=pts,
                event_info=self.stats)
            self.emit(sample)
        except Exception:  # mix errors must not kill the clock loop
            self.stats.end_timer("mix.video.compose")
            import traceback
            traceback.print_exc()
