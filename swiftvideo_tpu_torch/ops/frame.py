"""Whole-frame composite on the card: the hand-written Hopper kernels.

``composite_frame_cuda`` composites every z-sorted source of a frame onto a
y420p / y422p / y444p / nv12 / nv21 or RGBA / BGRA target with
``csrc/frame_composite.cu``; the launch carries the target's chroma grid.
It replaces the three TPU frame kernels of the JAX package,
``pallas_frame.py::_frame_kernel`` (planar-yuv sources),
``::_frame_kernel_rgba`` (RGBA/BGRA overlays) and
``::_frame_kernel_rgbaout`` (RGBA/BGRA targets), and computes
``golden.composite_stack``.  None of the TPU kernels' planning comes over
(row-pair views, scale classes, hat matrices, edge pads, VMEM gates, runs
of one source shape, the exact 2:1 limit of the RGBA-target kernel):
sources of any format, scale or rotation share a launch.

Launch path: the per-source table (``descriptors``, one 192-byte row per
source) and a 64-byte header are packed on the host into one
``FrameParams`` (``pack_params``) that the kernel takes by value as a
``__grid_constant__`` parameter, so a call neither pins nor copies a table.
One launch takes up to ``CAPACITY`` sources; a longer stack runs as
consecutive launches onto the same target, each after the first in chained
mode (``launch_plan``).

The kernels are built on first use with ``nvcc`` into ``build/`` inside
this package (ops/nvcc.py: a plain C interface, loaded with ctypes) and
launch on the current stream.  CPU tensors take the plain version
(ops/composite.composite_stack_torch); CUDA tensors take the kernel or
raise.  ``launches`` counts kernel launches, ``kernel_launches`` the same
by kernel name.
"""

from __future__ import annotations

import ctypes
import math
from functools import lru_cache
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..media.pixel import PixelFormat, num_planes, plane_array_shape

from . import nvcc
from .composite import composite_stack_torch, packed

# kernel launches since import; a plain integer so a run can show that its
# frames went through the kernel, and the same count by kernel: the yuv
# targets' (K1, K2) and the RGBA / BGRA targets' (K3)
launches = 0
YUV_KERNEL, RGBA_KERNEL = "frame_composite_kernel", "frame_composite_rgba_kernel"
kernel_launches = {YUV_KERNEL: 0, RGBA_KERNEL: 0}

KERNEL_TARGETS = (PixelFormat.y420p, PixelFormat.y422p, PixelFormat.y444p,
                  PixelFormat.nv12, PixelFormat.nv21,
                  PixelFormat.RGBA, PixelFormat.BGRA)

SOURCE = nvcc.CSRC / "frame_composite.cu"

# sources per launch (frame_composite.cu kCapacity)
CAPACITY = 32

# one SrcDesc of frame_composite.cu (192 bytes, same field order)
_DESC = np.dtype([("plane", "<u8", 3), ("fmt", "<i4"), ("dims", "<i4", 4),
                  ("box", "<i4", (2, 4)), ("u", "<f4", 29)])
assert _DESC.itemsize == 192
# FrameParams: the 64-byte header, then CAPACITY SrcDesc rows
_HEADER = np.dtype([("out", "<u8", 3), ("n", "<i4"), ("h", "<i4"),
                    ("w", "<i4"), ("out_fmt", "<i4"), ("chained", "<i4"),
                    ("ch", "<i4"), ("cw", "<i4"), ("pad", "<i4", 3)])
assert _HEADER.itemsize == 64
_PARAMS = np.dtype([("head", _HEADER), ("src", _DESC, CAPACITY)])

_SRC_CODES = {PixelFormat.y420p: 0, PixelFormat.y422p: 0, PixelFormat.y444p: 0,
              PixelFormat.nv12: 1, PixelFormat.nv21: 2,
              PixelFormat.RGBA: 3, PixelFormat.BGRA: 4}
_OUT_CODES = {PixelFormat.y420p: 0, PixelFormat.y422p: 0, PixelFormat.y444p: 0,
              PixelFormat.nv12: 1, PixelFormat.nv21: 2,
              PixelFormat.RGBA: 3, PixelFormat.BGRA: 4}


def build() -> ctypes.CDLL:
    """Compile (once per source/flags digest) and load the kernel library;
    raises if its parameter layout is not this module's."""
    lib = nvcc.load(SOURCE)
    fn = lib.sv_frame_composite
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        for info in (lib.sv_frame_params_size, lib.sv_frame_capacity):
            info.argtypes = []
            info.restype = ctypes.c_int
        layout = (lib.sv_frame_params_size(), lib.sv_frame_capacity())
        if layout != (_PARAMS.itemsize, CAPACITY):
            fn.argtypes = None
            raise RuntimeError(f"frame_composite.cu packs {layout} (bytes, "
                               f"sources), ops/frame.py "
                               f"{(_PARAMS.itemsize, CAPACITY)}")
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


def chroma_grid(out_fmt: PixelFormat, size: Tuple[int, int]) -> Tuple[int, int]:
    """(rows, columns) of a yuv target's chroma grid; (0, 0) for an RGBA /
    BGRA target, which has none."""
    if out_fmt in (PixelFormat.RGBA, PixelFormat.BGRA):
        return 0, 0
    ch, cw = plane_array_shape(out_fmt, size, 1)[:2]
    return ch, cw


@lru_cache(maxsize=1024)
def _boxes(border: bytes, h: int, w: int, ch: int,
           cw: int) -> Tuple[Tuple[int, ...], ...]:
    """The luma- and chroma-grid boxes of one border map (the packed
    uniforms' bytes 12:18 as float32) on an h x w luma grid and a ch x cw
    chroma grid."""
    a, b, c, d, tx, ty = np.frombuffer(border, np.float32).tolist()
    det = a * d - b * c
    grids = ((h, w), (ch, cw))
    if not math.isfinite(det) or abs(det) < 1e-30:
        return tuple((0, gh, 0, gw) for gh, gw in grids)
    # ndc = M^-1 (border - t) at the border square's corners
    nxs, nys = [], []
    for bx, by in ((0.0, 0.0), (1.0, 0.0), (0.0, 1.0), (1.0, 1.0)):
        nxs.append((d * (bx - tx) - b * (by - ty)) / det)
        nys.append((-c * (bx - tx) + a * (by - ty)) / det)
    if not all(map(math.isfinite, nxs + nys)):
        return tuple((0, gh, 0, gw) for gh, gw in grids)

    def span(lo, hi, n):
        return (int(max(0.0, min(float(n), math.floor(lo) - 2.0))),
                int(max(0.0, min(float(n), math.ceil(hi) + 3.0))))

    boxes = []
    for gh, gw in grids:
        xs = [(v + 1.0) / 2.0 * gw for v in nxs]
        ys = [(v + 1.0) / 2.0 * gh for v in nys]
        boxes.append(span(min(ys), max(ys), gh) + span(min(xs), max(xs), gw))
    return tuple(boxes)


def border_boxes(u: np.ndarray, size: Tuple[int, int],
                 out_fmt: PixelFormat) -> np.ndarray:
    """[n, 2, 4] half-open pixel boxes (y0, y1, x0, x1) on the luma and the
    chroma grid (``chroma_grid``) of a ``size`` = (w, h) ``out_fmt`` target,
    one pair per packed uniform row of ``u`` ([n, 29]).  A box holds every
    pixel whose border coordinates can fall inside [0, 1]^2, padded by 2 px
    against float32 rounding.  The kernel still tests each pixel exactly; a box only lets a
    tile skip a source.  Boxes are cached per border map: a live scene
    keeps its layout from frame to frame."""
    u = np.asarray(u, np.float32).reshape(-1, 29)
    grids = (int(size[1]), int(size[0])) + chroma_grid(out_fmt, size)
    return np.array([_boxes(row[12:18].tobytes(), *grids) for row in u],
                    np.int32).reshape(-1, 2, 4)


def descriptors(size: Tuple[int, int], sources,
                out_fmt: PixelFormat) -> np.ndarray:
    """The kernel's per-source table (one _DESC row per source) for a
    ``size`` ``out_fmt`` target."""
    table = np.zeros(len(sources), _DESC)
    if not sources:
        return table
    ptrs, codes, dims, us = [], [], [], []
    for planes, fmt, uni in sources:
        ptrs.append([t.data_ptr() for t in planes] + [0] * (3 - len(planes)))
        codes.append(_SRC_CODES[fmt])
        chroma = planes[1] if len(planes) > 1 else planes[0]
        dims.append(tuple(planes[0].shape[:2]) + tuple(chroma.shape[:2]))
        us.append(packed(uni))
    u = np.stack(us)
    table["plane"] = ptrs
    table["fmt"] = codes
    table["dims"] = dims
    table["box"] = border_boxes(u, size, out_fmt)
    table["u"] = u
    return table


def launch_plan(n: int) -> List[Tuple[int, int]]:
    """The launches of an n-source stack: [start, stop) slices of at most
    CAPACITY sources, one launch (a clear, or a copy of the target) when
    there are none.  Every launch after the first runs chained."""
    return [(a, min(a + CAPACITY, n)) for a in range(0, max(n, 1), CAPACITY)]


def pack_params(size: Tuple[int, int], out_fmt: PixelFormat, outs,
                rows: np.ndarray, chained: bool) -> np.ndarray:
    """One launch's FrameParams: the target's planes, shape and chroma
    grid, and ``rows`` (at most CAPACITY _DESC rows) as its sources."""
    if len(rows) > CAPACITY:
        raise ValueError(f"{len(rows)} sources in one launch, at most "
                         f"{CAPACITY}")
    params = np.zeros((), _PARAMS)
    head = params["head"]
    head["out"][:len(outs)] = [t.data_ptr() for t in outs]
    head["n"] = len(rows)
    head["w"], head["h"] = int(size[0]), int(size[1])
    head["out_fmt"] = _OUT_CODES[out_fmt]
    head["chained"] = int(chained)
    head["ch"], head["cw"] = chroma_grid(out_fmt, size)
    params["src"][:len(rows)] = rows
    return params


def composite_frame_cuda(size: Tuple[int, int], sources,
                         out_fmt: PixelFormat = PixelFormat.y420p, *,
                         device: Optional[torch.device] = None,
                         target=None) -> List[torch.Tensor]:
    """Clear (or start from ``target``'s planes) and fold ``sources`` —
    [(planes, fmt, ImageUniforms or packed [29])], z-sorted — onto a
    ``size`` = (w, h) y420p / y422p / y444p / nv12 / nv21 / RGBA / BGRA
    frame (packed 4:2:2 targets go through ``registry.composite_frame``).
    Returns the target's u8 planes on the sources' device.  ``device``
    names it when there are no sources."""
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
    kernel = RGBA_KERNEL if out_fmt in (PixelFormat.RGBA,
                                        PixelFormat.BGRA) else YUV_KERNEL
    table = descriptors(size, sources, out_fmt)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(dev).cuda_stream
    for a, b in launch_plan(len(sources)):
        params = pack_params(size, out_fmt, outs, table[a:b],
                             a > 0 or target is not None)
        err = lib.sv_frame_composite(params.ctypes.data, index, stream)
        if err != 0:
            raise RuntimeError(f"frame_composite launch failed: CUDA error "
                               f"{err}")
        launches += 1
        kernel_launches[kernel] += 1
    return outs
