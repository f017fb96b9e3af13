"""Whole-frame composite on the card: the hand-written Hopper kernel.

``composite_frame_cuda`` composites every z-sorted source of a frame onto a
y420p / nv12 / nv21 or RGBA / BGRA target in one launch of
``csrc/frame_composite.cu``.  It replaces the three TPU frame kernels of
the JAX package, ``pallas_frame.py::_frame_kernel`` (planar-yuv sources),
``::_frame_kernel_rgba`` (RGBA/BGRA overlays) and
``::_frame_kernel_rgbaout`` (RGBA/BGRA targets), and computes
``golden.composite_stack``.  None of the TPU kernels' planning comes over
(row-pair views, scale classes, hat matrices, edge pads, VMEM gates, runs
of one source shape, the exact 2:1 limit of the RGBA-target kernel):
sources of any format, scale or rotation share the launch.

The kernel is built on first use with ``nvcc`` into ``build/`` inside this
package (ops/nvcc.py: a plain C interface, loaded with ctypes) and launches
on the current stream.  CPU tensors take the plain version
(ops/composite.composite_stack_torch); CUDA tensors take the kernel or
raise.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..media.pixel import PixelFormat, num_planes, plane_array_shape

from . import nvcc
from .composite import composite_stack_torch, packed

# kernel launches since import; a plain integer so a run can show that its
# frames went through the kernel
launches = 0

KERNEL_TARGETS = (PixelFormat.y420p, PixelFormat.nv12, PixelFormat.nv21,
                  PixelFormat.RGBA, PixelFormat.BGRA)

SOURCE = nvcc.CSRC / "frame_composite.cu"

# one SrcDesc of frame_composite.cu (192 bytes, same field order)
_DESC = np.dtype([("plane", "<u8", 3), ("fmt", "<i4"), ("dims", "<i4", 4),
                  ("box", "<i4", (2, 4)), ("u", "<f4", 29)])
assert _DESC.itemsize == 192

_SRC_CODES = {PixelFormat.y420p: 0, PixelFormat.y422p: 0, PixelFormat.y444p: 0,
              PixelFormat.nv12: 1, PixelFormat.nv21: 2,
              PixelFormat.RGBA: 3, PixelFormat.BGRA: 4}
_OUT_CODES = {PixelFormat.y420p: 0, PixelFormat.nv12: 1, PixelFormat.nv21: 2,
              PixelFormat.RGBA: 3, PixelFormat.BGRA: 4}


def build() -> ctypes.CDLL:
    """Compile (once per source/flags digest) and load the kernel library."""
    lib = nvcc.load(SOURCE)
    fn = lib.sv_frame_composite
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _source_shapes_ok(planes, fmt: PixelFormat) -> bool:
    dims = [tuple(p.shape) for p in planes]
    if fmt in (PixelFormat.y420p, PixelFormat.y422p, PixelFormat.y444p):
        return (len(dims) == 3 and all(len(d) == 2 for d in dims)
                and dims[1] == dims[2])
    if fmt in (PixelFormat.nv12, PixelFormat.nv21):
        return (len(dims) == 2 and len(dims[0]) == 2 and len(dims[1]) == 3
                and dims[1][2] == 2)
    return len(dims) == 1 and len(dims[0]) == 3 and dims[0][2] == 4


def _check(sources, target, device) -> torch.device:
    """Validate every plane; returns the one device they all live on."""
    seen = set()
    for planes, fmt, _uni in sources:
        if fmt not in _SRC_CODES:
            raise ValueError(f"frame kernel takes no {fmt} source")
        for p in planes:
            if not isinstance(p, torch.Tensor):
                raise TypeError(f"source planes must be tensors, got {type(p)}")
            if p.dtype != torch.uint8:
                raise TypeError(f"source planes must be uint8, got {p.dtype}")
            if not p.is_contiguous():
                raise ValueError("source planes must be contiguous")
            if p.numel() == 0:
                raise ValueError("empty source plane")
            seen.add(p.device)
        if not _source_shapes_ok(planes, fmt):
            raise ValueError(f"plane shapes {[tuple(p.shape) for p in planes]}"
                             f" do not fit {fmt}")
    for p in target or ():
        if not isinstance(p, torch.Tensor) or p.dtype != torch.uint8:
            raise TypeError("target planes must be uint8 tensors")
        seen.add(p.device)
    if device is not None:
        seen.add(torch.device(device))
    if len(seen) != 1:
        raise ValueError(f"frame planes must share one device, got {seen}")
    return seen.pop()


def border_box(p: np.ndarray, gh: int, gw: int) -> Tuple[int, int, int, int]:
    """Half-open pixel box (y0, y1, x0, x1) of a gh x gw grid that holds
    every pixel whose border coordinates can fall inside [0, 1]^2, padded
    by 2 px against float32 rounding.  The kernel still tests each pixel
    exactly; the box only lets it skip a source."""
    a, b, c, d, tx, ty = np.asarray(p[12:18], np.float64)
    det = a * d - b * c
    if not np.isfinite(det) or abs(det) < 1e-30:
        return (0, gh, 0, gw)
    # ndc = M^-1 (border - t) at the border square's corners
    xs, ys = [], []
    for bx, by in ((0.0, 0.0), (1.0, 0.0), (0.0, 1.0), (1.0, 1.0)):
        nx = (d * (bx - tx) - b * (by - ty)) / det
        ny = (-c * (bx - tx) + a * (by - ty)) / det
        xs.append((nx + 1.0) / 2.0 * gw)
        ys.append((ny + 1.0) / 2.0 * gh)

    def span(lo, hi, n):
        lo = max(0.0, min(float(n), np.floor(lo) - 2.0))
        hi = max(0.0, min(float(n), np.ceil(hi) + 3.0))
        return int(lo), int(hi)

    y0, y1 = span(min(ys), max(ys), gh)
    x0, x1 = span(min(xs), max(xs), gw)
    return (y0, y1, x0, x1)


def descriptors(size: Tuple[int, int], sources) -> np.ndarray:
    """The kernel's per-source table (one _DESC row per source)."""
    w, h = int(size[0]), int(size[1])
    table = np.zeros(max(len(sources), 1), _DESC)
    for i, (planes, fmt, uni) in enumerate(sources):
        p = packed(uni)
        table["plane"][i, :len(planes)] = [t.data_ptr() for t in planes]
        table["fmt"][i] = _SRC_CODES[fmt]
        chroma = planes[1] if len(planes) > 1 else planes[0]
        table["dims"][i] = (planes[0].shape[0], planes[0].shape[1],
                            chroma.shape[0], chroma.shape[1])
        table["box"][i, 0] = border_box(p, h, w)
        table["box"][i, 1] = border_box(p, h // 2, w // 2)
        table["u"][i] = p
    return table


def composite_frame_cuda(size: Tuple[int, int], sources,
                         out_fmt: PixelFormat = PixelFormat.y420p, *,
                         device: Optional[torch.device] = None,
                         target=None) -> List[torch.Tensor]:
    """Clear (or start from ``target``'s planes) and fold ``sources`` —
    [(planes, fmt, ImageUniforms or packed [29])], z-sorted — onto a
    ``size`` = (w, h) y420p / nv12 / nv21 / RGBA / BGRA frame.  Returns the
    target's u8 planes on the sources' device.  ``device`` names it when
    there are no sources."""
    global launches
    if out_fmt not in KERNEL_TARGETS:
        raise ValueError(f"frame kernel writes no {out_fmt} target")
    dev = _check(sources, target, device)
    if dev.type == "cpu":
        return composite_stack_torch(out_fmt, size, sources, dev, target=target)
    if dev.type != "cuda":
        raise ValueError(f"frame kernel runs on cuda, not {dev}")
    w, h = int(size[0]), int(size[1])
    shapes = [plane_array_shape(out_fmt, (w, h), i)
              for i in range(num_planes(out_fmt))]
    if target is not None:
        if [tuple(t.shape) for t in target] != shapes:
            raise ValueError(f"target planes do not fit {out_fmt} {size}")
        outs = [t.clone(memory_format=torch.contiguous_format)
                for t in target]
    else:
        outs = [torch.empty(s, dtype=torch.uint8, device=dev) for s in shapes]
    lib = build()
    table = descriptors(size, sources)
    with torch.cuda.device(dev):
        descs = torch.from_numpy(table.view(np.uint8)).pin_memory().to(
            dev, non_blocking=True)
        stream = torch.cuda.current_stream(dev).cuda_stream
        ptrs = [t.data_ptr() for t in outs] + [None] * (3 - len(outs))
        err = lib.sv_frame_composite(descs.data_ptr(), len(sources), *ptrs,
                                     h, w, _OUT_CODES[out_fmt],
                                     int(target is not None), stream)
    if err != 0:
        raise RuntimeError(f"frame_composite launch failed: CUDA error {err}")
    launches += 1
    return outs
