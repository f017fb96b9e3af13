"""PictureSample: immutable picture value over dense plane tensors.

Reference semantics: ``/root/reference/Sources/SwiftVideo/sample.pict.linux.swift``
(ImageBuffer :23-72, PictureSample :105-249, createPictureSample :254-311)
and the PictureEvent protocol (sample.pict.swift:67-81).

TPU-first deviations:

* Planes are dense numpy arrays (host) or jax arrays (device).  ``bufferType``
  maps to where the planes currently live: ``cpu`` = numpy, ``gpu`` = jax
  device arrays.  GPUBarrierUpload/Download (ops.barriers) move between them.
* Matrices use the column-vector convention of utils.matrix.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Optional, Sequence, Tuple

import numpy as np

from ..core import EventInfo, TimePoint
from ..utils import matrix as m4
from .pixel import BufferType, PixelFormat, Plane, allocate_planes, planes_for_format


@dataclass(frozen=True)
class ImageBuffer:
    """Pixel storage: dense planes + geometry (sample.pict.linux.swift:23-72)."""

    pixel_format: PixelFormat
    buffer_type: BufferType
    size: Tuple[int, int]  # (w, h)
    planes: Tuple[Plane, ...]
    buffers: Tuple[Any, ...]  # numpy (cpu) or jax (gpu) arrays, one per plane

    def with_buffers(self, buffers: Sequence[Any], buffer_type: Optional[BufferType] = None) -> "ImageBuffer":
        return replace(self, buffers=tuple(buffers),
                       buffer_type=buffer_type or self.buffer_type)


@dataclass(frozen=True)
class PictureSample:
    """Immutable picture event (sample.pict.linux.swift:105-249).

    Composition state rides with the sample: a model matrix placing the
    picture on the canvas (NDC), a texture matrix mapping element-local
    coords to texture uv, a border matrix, fill color, and opacity — exactly
    the uniforms the composite kernel consumes (compute.swift:145-170).
    """

    img: ImageBuffer
    id_asset: str
    id_workspace: str
    token_workspace: Optional[str] = None
    time_point: TimePoint = field(default_factory=lambda: TimePoint(0, 100000))
    pts_value: TimePoint = field(default_factory=lambda: TimePoint(0, 100000))
    matrix_value: np.ndarray = field(default_factory=m4.identity4)
    texture_matrix_value: np.ndarray = field(default_factory=m4.identity4)
    border_matrix_value: Optional[np.ndarray] = None
    fill_color_value: np.ndarray = field(
        default_factory=lambda: np.zeros(4, dtype=np.float32))
    opacity_value: float = 1.0
    revision_value: str = ""
    event_info: Optional[EventInfo] = None
    constituents_value: Tuple = ()

    # --- Event protocol --------------------------------------------------
    def type(self) -> str:
        return "pict"

    def time(self) -> TimePoint:
        return self.time_point

    def asset_id(self) -> str:
        return self.id_asset

    def workspace_id(self) -> str:
        return self.id_workspace

    def workspace_token(self) -> Optional[str]:
        return self.token_workspace

    def info(self) -> Optional[EventInfo]:
        return self.event_info

    # --- PictureEvent protocol (sample.pict.swift:67-81) -----------------
    def pts(self) -> TimePoint:
        return self.pts_value

    def matrix(self) -> np.ndarray:
        return self.matrix_value

    def texture_matrix(self) -> np.ndarray:
        return self.texture_matrix_value

    def border_matrix(self) -> np.ndarray:
        return self.border_matrix_value if self.border_matrix_value is not None \
            else self.matrix_value

    def z_index(self) -> int:
        # z translation of the model matrix (sample.pict.linux.swift:116)
        return int(self.matrix_value[2, 3])

    def pixel_format(self) -> PixelFormat:
        return self.img.pixel_format

    def buffer_type(self) -> BufferType:
        return self.img.buffer_type

    def size(self) -> Tuple[int, int]:
        return self.img.size

    def revision(self) -> str:
        return self.revision_value

    def fill_color(self) -> np.ndarray:
        return self.fill_color_value

    def opacity(self) -> float:
        return self.opacity_value

    def planes(self) -> Tuple[Any, ...]:
        return self.img.buffers

    def constituents(self):
        return self.constituents_value

    # --- copy-on-modify (sample.pict.linux.swift:137-249) ----------------
    def with_(self, **kwargs) -> "PictureSample":
        """Copy with modified composition state / timing / buffers."""
        mapping = {
            "matrix": "matrix_value", "texture_matrix": "texture_matrix_value",
            "border_matrix": "border_matrix_value", "fill_color": "fill_color_value",
            "opacity": "opacity_value", "pts": "pts_value", "time": "time_point",
            "revision": "revision_value", "asset_id": "id_asset",
            "constituents": "constituents_value", "img": "img",
            "event_info": "event_info",
        }
        return replace(self, **{mapping.get(k, k): v for k, v in kwargs.items()})


def create_picture_sample(size: Tuple[int, int], fmt: PixelFormat, *,
                          asset_id: str, workspace_id: str,
                          token_workspace: Optional[str] = None) -> PictureSample:
    """Allocate a zeroed cpu-backed sample (sample.pict.linux.swift:254-311)."""
    w, h = int(size[0]), int(size[1])
    if w <= 0 or h <= 0:
        raise ValueError("invalid size")
    planes = tuple(planes_for_format(fmt, (w, h)))
    buffers = tuple(allocate_planes(fmt, (w, h)))
    img = ImageBuffer(pixel_format=fmt, buffer_type=BufferType.cpu,
                      size=(w, h), planes=planes, buffers=buffers)
    return PictureSample(img, asset_id, workspace_id, token_workspace)
