"""Carry the JAX package's state into this package.

The two packages keep their own copies of the host layers, so their types
differ: ``swiftvideo_tpu.media.PixelFormat.y420p`` is not this package's
``PixelFormat.y420p``, and neither are the two packages' ``TimePoint``s,
pictures or audio samples.  These functions convert by value, so that the
two packages compute on the same data:

* pixel formats by ``.value``;
* ``ImageUniforms`` as the packed float32 [29] vector (the same layout in
  both packages);
* planes and PCM as numpy arrays (or u8 tensors, for a source list);
* ``TimePoint``s by (value, scale).

Nothing here imports the JAX package: its objects are read by attribute.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from .core import TimePoint
from .media.audio import AudioSample
from .media.picture import ImageBuffer, PictureSample
from .media.pixel import BufferType, PixelFormat, planes_for_format
from .ops.composite import packed


def pixel_format(fmt) -> PixelFormat:
    """Either package's pixel format as this package's."""
    return PixelFormat(fmt.value)


def uniforms(uni) -> np.ndarray:
    """Either package's ``ImageUniforms`` (or a packed vector) as a packed
    float32 [29] vector."""
    return packed(uni).copy()


def time_point(tp) -> TimePoint:
    return TimePoint(tp.value, tp.scale)


def to_port_sources(sources: Sequence, device) -> List[Tuple[list, PixelFormat,
                                                              np.ndarray]]:
    """``[(planes, fmt, ImageUniforms | packed [29])]`` of the JAX package
    (planes as numpy or JAX-produced arrays) as ``[(u8 tensors on device,
    fmt, packed float32 [29])]`` of this package."""
    device = torch.device(device)
    return [([torch.from_numpy(np.array(p, dtype=np.uint8)).to(device)
              for p in planes], pixel_format(fmt), uniforms(uni))
            for planes, fmt, uni in sources]


def picture_sample(sample) -> PictureSample:
    """A JAX-package ``PictureSample`` as this package's, its planes copied
    to numpy (``BufferType.cpu``) and its composition state carried over."""
    fmt = pixel_format(sample.pixel_format())
    size = tuple(sample.size())
    img = ImageBuffer(pixel_format=fmt, buffer_type=BufferType.cpu, size=size,
                      planes=tuple(planes_for_format(fmt, size)),
                      buffers=tuple(np.array(p) for p in sample.planes()))
    border = sample.border_matrix_value
    return PictureSample(
        img, sample.asset_id(), sample.workspace_id(),
        token_workspace=sample.workspace_token(),
        time_point=time_point(sample.time()), pts_value=time_point(sample.pts()),
        matrix_value=np.array(sample.matrix()),
        texture_matrix_value=np.array(sample.texture_matrix()),
        border_matrix_value=None if border is None else np.array(border),
        fill_color_value=np.array(sample.fill_color(), np.float32),
        opacity_value=float(sample.opacity()),
        revision_value=sample.revision())


def audio_sample(sample) -> AudioSample:
    """A JAX-package ``AudioSample`` as this package's, its PCM copied to
    numpy."""
    return AudioSample(
        buffers=tuple(np.array(b) for b in sample.data()),
        frequency=sample.sample_rate(), channels=sample.number_channels(),
        format=sample.format, sample_count=sample.number_samples(),
        time_point=time_point(sample.time()), pts_value=time_point(sample.pts()),
        id_asset=sample.asset_id(), id_workspace=sample.workspace_id(),
        token_workspace=sample.workspace_token(),
        transform=np.array(sample.transform))
