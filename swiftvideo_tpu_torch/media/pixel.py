"""Pixel formats and plane geometry.

Reference semantics: ``/root/reference/Sources/SwiftVideo/sample.pict.swift``
(PixelFormat :20-33, Plane :47-58, componentsForPlane :83-102) and the plane
layout rules of ``sample.pict.linux.swift:275-294``.

TPU-first deviation: planes are **dense** numpy / jax arrays — strides are
removed at ingest (TPU wants contiguous, lane-aligned data; any stride
handling happens host-side when wrapping foreign buffers).  Planar layouts:

================ ==========================================================
format           planes (arrays)
================ ==========================================================
y420p            [H,W] luma u8, [H/2,W/2] cb u8, [H/2,W/2] cr u8
y422p            [H,W] luma, [H,W/2] cb, [H,W/2] cr
y444p            [H,W] x3
nv12 / nv21      [H,W] luma, [H/2,W/2,2] interleaved cbcr (nv21: crcb)
RGBA / BGRA      [H,W,4]
yuvs / zvuy      [H,W,2] packed 4:2:2 (y,cb,y,cr pairs along W)
================ ==========================================================
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import List, Tuple

import numpy as np


class PixelFormat(Enum):
    nv12 = "nv12"
    nv21 = "nv21"
    yuvs = "yuvs"
    zvuy = "zvuy"
    y420p = "y420p"
    y422p = "y422p"
    y444p = "y444p"
    RGBA = "rgba"
    BGRA = "bgra"
    shape = "shape"
    text = "text"
    invalid = "invalid"


class Component(Enum):
    r = "r"
    g = "g"
    b = "b"
    a = "a"
    y = "y"
    cr = "cr"
    cb = "cb"


class BufferType(Enum):
    shared = "shared"
    cpu = "cpu"
    gpu = "gpu"
    invalid = "invalid"


@dataclass(frozen=True)
class Plane:
    """Geometry of one plane (sample.pict.swift:47-58).  ``size`` is (w, h);
    stride is in bytes (== dense row bytes here)."""

    size: Tuple[int, int]
    stride: int
    bit_depth: int
    components: Tuple[Component, ...]


def components_for_plane(fmt: PixelFormat, idx: int) -> Tuple[Component, ...]:
    """sample.pict.swift:83-102"""
    C = Component
    if fmt in (PixelFormat.y420p, PixelFormat.y422p, PixelFormat.y444p):
        return ((C.y,), (C.cb,), (C.cr,))[idx]
    if fmt == PixelFormat.nv12:
        return ((C.y,), (C.cb, C.cr))[idx]
    if fmt == PixelFormat.nv21:
        return ((C.y,), (C.cr, C.cb))[idx]
    if fmt == PixelFormat.yuvs:
        return (C.y, C.cb, C.y, C.cr)
    if fmt == PixelFormat.zvuy:
        return (C.cb, C.y, C.cr, C.y)
    if fmt == PixelFormat.BGRA:
        return (C.b, C.g, C.r, C.a)
    if fmt == PixelFormat.RGBA:
        return (C.r, C.g, C.b, C.a)
    return ()


def planes_for_format(fmt: PixelFormat, size: Tuple[int, int]) -> List[Plane]:
    """Dense-plane geometry (sample.pict.linux.swift:275-294)."""
    w, h = int(size[0]), int(size[1])
    C = Component
    if fmt == PixelFormat.y420p:
        return [Plane((w, h), w, 8, (C.y,)),
                Plane((w // 2, h // 2), w // 2, 8, (C.cb,)),
                Plane((w // 2, h // 2), w // 2, 8, (C.cr,))]
    if fmt == PixelFormat.y422p:
        return [Plane((w, h), w, 8, (C.y,)),
                Plane((w // 2, h), w // 2, 8, (C.cb,)),
                Plane((w // 2, h), w // 2, 8, (C.cr,))]
    if fmt == PixelFormat.y444p:
        return [Plane((w, h), w, 8, (C.y,)),
                Plane((w, h), w, 8, (C.cb,)),
                Plane((w, h), w, 8, (C.cr,))]
    if fmt in (PixelFormat.nv12, PixelFormat.nv21):
        return [Plane((w, h), w, 8, (C.y,)),
                Plane((w // 2, h // 2), w, 8, components_for_plane(fmt, 1))]
    if fmt in (PixelFormat.RGBA, PixelFormat.BGRA):
        return [Plane((w, h), w * 4, 8, components_for_plane(fmt, 0))]
    if fmt in (PixelFormat.yuvs, PixelFormat.zvuy):
        return [Plane((w, h), w * 2, 8, components_for_plane(fmt, 0))]
    raise ValueError(f"Invalid pixel format {fmt}")


def plane_array_shape(fmt: PixelFormat, size: Tuple[int, int], idx: int) -> Tuple[int, ...]:
    """Dense array shape for plane ``idx``: (H, W[, C])."""
    w, h = int(size[0]), int(size[1])
    if fmt in (PixelFormat.y420p,):
        return [(h, w), (h // 2, w // 2), (h // 2, w // 2)][idx]
    if fmt == PixelFormat.y422p:
        return [(h, w), (h, w // 2), (h, w // 2)][idx]
    if fmt == PixelFormat.y444p:
        return [(h, w), (h, w), (h, w)][idx]
    if fmt in (PixelFormat.nv12, PixelFormat.nv21):
        return [(h, w), (h // 2, w // 2, 2)][idx]
    if fmt in (PixelFormat.RGBA, PixelFormat.BGRA):
        return (h, w, 4)
    if fmt in (PixelFormat.yuvs, PixelFormat.zvuy):
        return (h, w, 2)
    raise ValueError(f"Invalid pixel format {fmt}")


def num_planes(fmt: PixelFormat) -> int:
    return len(planes_for_format(fmt, (2, 2)))


def allocate_planes(fmt: PixelFormat, size: Tuple[int, int]) -> List[np.ndarray]:
    """Zeroed dense planes for a format (host side)."""
    return [np.zeros(plane_array_shape(fmt, size, i), dtype=np.uint8)
            for i in range(num_planes(fmt))]


def packed422_to_planar(arr, fmt: "PixelFormat", xp=np):
    """Convert packed 4:2:2 (yuvs / zvuy, [H, W, 2]) to y422p planes
    ([H,W] y, [H,W/2] cb, [H,W/2] cr).

    Layout per 2-pixel group along W (sample.pict.swift:83-102 component
    orders): yuvs = (y0, cb, y1, cr), zvuy = (cb, y0, cr, y1).  TPU ingest
    normalizes packed formats to planar so device kernels stay dense.
    ``xp`` keeps device arrays on device (jnp slices stay jnp).
    """
    if fmt == PixelFormat.yuvs:
        y = arr[..., 0]
        cb = arr[:, 0::2, 1]
        cr = arr[:, 1::2, 1]
    elif fmt == PixelFormat.zvuy:
        y = arr[..., 1]
        cb = arr[:, 0::2, 0]
        cr = arr[:, 1::2, 0]
    else:
        raise ValueError(f"not a packed 4:2:2 format: {fmt}")
    if xp is np:
        return [np.ascontiguousarray(y), np.ascontiguousarray(cb),
                np.ascontiguousarray(cr)]
    return [y, cb, cr]


def planar_to_packed422(planes, fmt: "PixelFormat", xp=np):
    """Inverse of packed422_to_planar (egress to packed-422 consumers);
    functional construction so it works on immutable device arrays."""
    y, cb, cr = planes
    h, w = y.shape
    # interleave cb/cr along W: chroma[:, 0::2] = cb, chroma[:, 1::2] = cr
    chroma = xp.stack([cb, cr], axis=-1).reshape(h, w)
    if fmt == PixelFormat.yuvs:
        return xp.stack([y, chroma], axis=-1)
    if fmt == PixelFormat.zvuy:
        return xp.stack([chroma, y], axis=-1)
    raise ValueError(f"not a packed 4:2:2 format: {fmt}")
