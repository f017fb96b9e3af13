"""Text rendering: glyph rasterization to RGBA picture samples.

Role parity with the reference's FreeType renderer
(reference Sources/SwiftVideo_Freetype/text.swift): ``TextSample``
(string + font size + color + optional canvas placement, :33-84) rendered
by ``TextRenderer`` — a ``Tx[TextSample, PictureSample]`` producing a
tinted RGBA sample (:93-170, per-glyph gray bitmaps tinted into RGBA rows
:212-247).  Rasterization here uses PIL's FreeType binding; when no
TrueType font is found a built-in PIL bitmap font is the fallback.
"""

from __future__ import annotations

import glob
import os
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np

from ..core import EventBox, EventError, EventInfo, TimePoint, Tx
from ..media.picture import ImageBuffer, PictureSample
from ..media.pixel import BufferType, PixelFormat, planes_for_format

_FONT_DIRS = ("/usr/share/fonts", "/usr/local/share/fonts",
              os.path.expanduser("~/.fonts"))


def find_default_font() -> Optional[str]:
    for base in _FONT_DIRS:
        for pattern in ("**/*.ttf", "**/*.otf"):
            hits = glob.glob(os.path.join(base, pattern), recursive=True)
            if hits:
                return sorted(hits)[0]
    return None


@dataclass(frozen=True)
class TextSample:
    """A string to rasterize (text.swift:33-84)."""

    text: str
    font_size: float = 24.0
    color: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)
    id_asset: str = ""
    id_workspace: str = ""
    time_point: TimePoint = field(default_factory=lambda: TimePoint(0, 1000))
    pts_value: TimePoint = field(default_factory=lambda: TimePoint(0, 1000))
    event_info: Optional[EventInfo] = None

    def type(self) -> str:
        return "text"

    def time(self) -> TimePoint:
        return self.time_point

    def pts(self) -> TimePoint:
        return self.pts_value

    def asset_id(self) -> str:
        return self.id_asset

    def workspace_id(self) -> str:
        return self.id_workspace

    def workspace_token(self) -> Optional[str]:
        return None

    def info(self) -> Optional[EventInfo]:
        return self.event_info


def render_text_rgba(text: str, font_size: float,
                     color: Tuple[float, float, float, float],
                     font_path: Optional[str] = None) -> np.ndarray:
    """Rasterize to a tight [H, W, 4] u8 RGBA array (tinted glyph alpha,
    matching the reference's gray-bitmap-to-tinted-RGBA path)."""
    from PIL import Image, ImageDraw, ImageFont
    path = font_path or find_default_font()
    if path is not None:
        font = ImageFont.truetype(path, int(round(font_size)))
    else:
        font = ImageFont.load_default()
    # width pre-pass (text.swift:249-262)
    probe = Image.new("L", (1, 1))
    draw = ImageDraw.Draw(probe)
    bbox = draw.textbbox((0, 0), text, font=font)
    w = max(1, bbox[2] - bbox[0] + 2)
    h = max(1, bbox[3] - bbox[1] + 2)
    img = Image.new("L", (w, h), 0)
    draw = ImageDraw.Draw(img)
    draw.text((-bbox[0] + 1, -bbox[1] + 1), text, font=font, fill=255)
    alpha = np.asarray(img, dtype=np.float32) / 255.0
    rgba = np.zeros((h, w, 4), np.uint8)
    for ch in range(3):
        rgba[..., ch] = np.clip(np.rint(alpha * color[ch] * 255.0),
                                0, 255).astype(np.uint8)
    rgba[..., 3] = np.clip(np.rint(alpha * color[3] * 255.0),
                           0, 255).astype(np.uint8)
    return rgba


class TextRenderer(Tx):
    """Tx[TextSample, PictureSample] (text.swift:93-170)."""

    def __init__(self, font_path: Optional[str] = None):
        self.font_path = font_path or find_default_font()
        super().__init__(self._impl)

    def _impl(self, sample: TextSample) -> EventBox:
        try:
            rgba = render_text_rgba(sample.text, sample.font_size,
                                    sample.color, self.font_path)
        except Exception as exc:  # noqa: BLE001
            return EventBox.error(EventError("text.render", -1, str(exc)))
        h, w = rgba.shape[:2]
        img = ImageBuffer(pixel_format=PixelFormat.RGBA,
                          buffer_type=BufferType.cpu, size=(w, h),
                          planes=tuple(planes_for_format(PixelFormat.RGBA,
                                                         (w, h))),
                          buffers=(rgba,))
        return EventBox.just(PictureSample(
            img, sample.asset_id(), sample.workspace_id(),
            time_point=sample.time(), pts_value=sample.pts(),
            event_info=sample.info()))
