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
source, its boxes and uniforms cached by value) and a 64-byte header are
packed on the host into one ``FrameParams`` (``pack_params``) that the
kernel takes by value as a ``__grid_constant__`` parameter, so a call
neither pins nor copies a table.
One launch takes up to ``CAPACITY`` sources; a longer stack runs as
consecutive launches onto the same target, each after the first in chained
mode (``launch_plan``).

``composite_cells_cuda`` composites each frame of a batch alone onto its
own cell of a grid of cell rows and columns (the mixing wall's canvas, or
a one-column stack of scaled frames): the header's cell grid makes the
kernel place every pixel inside its cell, so a launch of up to
``CAPACITY`` cells gives the pixels of one launch per cell.  A layout's
launches (boxes, dims, format, uniforms, bands of cell rows, each frame's
offset into the batch) are built once and kept as a ``CellPlan``
(``cell_plan``); a call that repeats the layout checks its planes against
the plan and hands the plan and six base addresses to one C call, which
adds the bases and makes the launches (``cell_params`` gives the same
words on the host).  ``composite_ladder_cuda`` does the same for every
rung of a rendition ladder at once, each rung a one-column layout of its
own cell size and uniform: one kept ``LadderPlan`` (``ladder_plan``) holds
all the rungs' launches onto three flat canvases, and one C call makes
them.  A cell launch whose sources are all axis-aligned,
each in its own cell, is marked in its mode word for the row kernel
(``cell_mode``, decided once per plan), which stages each cell's tap rows
in shared memory with bulk copies.  The C call decides what the kernel's
tables and stages hold: it gives a marked launch to the row kernel where
every source is planar with rows that fit its stage, merges such launches,
unchained, into one kernel launch, gives every other launch to the tile
kernel, and reports the kernel launches it made.

The kernels are built on first use with ``nvcc`` into ``build/`` inside
this package and launched on the current stream, both by ops/nvcc.py
(``SIGNATURES`` declares the C entries).  CPU tensors take the plain
version (ops/composite.composite_stack_torch, composite_cells_torch); CUDA
tensors take the kernel or raise.  ``launches`` counts kernel launches,
``kernel_launches`` the same by the names the profiler matches
(``YUV_KERNEL`` holds the row kernel's launches too); the recorder's
counters ``frame.cell_launches`` and ``frame.cell_row_launches`` count the
cell wrapper's kernel launches and those of the row kernel, as the C call
reports them, and ``frame.cell_plan_fast`` the plan lookups (one a
``composite_cells_cuda`` or ``composite_ladder_cuda`` call) that the last
plan answered.
"""

from __future__ import annotations

import copy
import ctypes
import math
import struct
from functools import lru_cache
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core import spans
from ..media.pixel import PixelFormat, num_planes, plane_array_shape

from . import nvcc
from .composite import composite_cells_torch, composite_stack_torch, packed

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

# the kernel a yuv launch asks for (FrameParams mode): the tile kernel, or
# the row kernel for a cell launch whose sources are all axis-aligned, each
# in its own cell (frame_composite.cu takes_rows decides the rest)
TILES, ROWS = 0, 1

# one SrcDesc of frame_composite.cu (192 bytes, same field order)
_DESC = np.dtype([("plane", "<u8", 3), ("fmt", "<i4"), ("dims", "<i4", 4),
                  ("box", "<i4", (2, 4)), ("u", "<f4", 29)])
assert _DESC.itemsize == 192
# FrameParams: the 64-byte header, then CAPACITY SrcDesc rows
_HEADER = np.dtype([("out", "<u8", 3), ("n", "<i4"), ("h", "<i4"),
                    ("w", "<i4"), ("out_fmt", "<i4"), ("chained", "<i4"),
                    ("ch", "<i4"), ("cw", "<i4"), ("cell_h", "<i4"),
                    ("cell_w", "<i4"), ("mode", "<i4")])
assert _HEADER.itemsize == 64
_PARAMS = np.dtype([("head", _HEADER), ("src", _DESC, CAPACITY)])
# a _DESC row's plane pointers, format code and dims as a struct (its boxes
# and uniforms follow, ``_row_tail``)
_ROW_HEAD = struct.Struct("<3Qi4i")
assert _ROW_HEAD.size == _DESC.fields["box"][1]

_SRC_CODES = {PixelFormat.y420p: 0, PixelFormat.y422p: 0, PixelFormat.y444p: 0,
              PixelFormat.nv12: 1, PixelFormat.nv21: 2,
              PixelFormat.RGBA: 3, PixelFormat.BGRA: 4}
_OUT_CODES = {PixelFormat.y420p: 0, PixelFormat.y422p: 0, PixelFormat.y444p: 0,
              PixelFormat.nv12: 1, PixelFormat.nv21: 2,
              PixelFormat.RGBA: 3, PixelFormat.BGRA: 4}


_P, _I, _U64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64
# the C entries of frame_composite.cu, {name: (restype, [argtypes])}
SIGNATURES = {
    "sv_frame_composite": (_I, [_P, _I, _P]),
    "sv_frame_cells": (_I, [_P, _I] + [_U64] * 6 + [_P, _P, _I, _P]),
    "sv_frame_params_size": (_I, []),
    "sv_frame_capacity": (_I, []),
}


def _check_layout(lib: ctypes.CDLL) -> None:
    layout = (lib.sv_frame_params_size(), lib.sv_frame_capacity())
    if layout != (_PARAMS.itemsize, CAPACITY):
        raise RuntimeError(f"frame_composite.cu packs {layout} (bytes, "
                           f"sources), ops/frame.py "
                           f"{(_PARAMS.itemsize, CAPACITY)}")


def build() -> ctypes.CDLL:
    """Compile (once per source/flags digest) and load the kernel library;
    raises if its parameter layout is not this module's."""
    return nvcc.load(SOURCE, SIGNATURES, _check_layout)


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


def cell_boxes(u: np.ndarray, cell_size: Tuple[int, int],
               cols: int = 1) -> np.ndarray:
    """[n, 2, 4] boxes of packed uniform row i of ``u`` on a grid of
    ``cols`` columns of y420p cells of ``cell_size`` = (w, h), cell i at
    row i // cols and column i % cols: its boxes on a cell-sized target
    (``border_boxes``, clipped to the cell), shifted to its cell, by (r h,
    c w) on the luma grid and (r h / 2, c w / 2) on the chroma grid."""
    w, h = int(cell_size[0]), int(cell_size[1])
    boxes = border_boxes(u, (w, h), PixelFormat.y420p)
    rows, cols_at = np.divmod(np.arange(len(boxes), dtype=np.int32),
                              np.int32(cols))
    for grid, (gh, gw) in enumerate(((h, w), (h // 2, w // 2))):
        boxes[:, grid, :2] += (rows * gh)[:, None]
        boxes[:, grid, 2:] += (cols_at * gw)[:, None]
    return boxes


@lru_cache(maxsize=1024)
def _row_tail(u: bytes, h: int, w: int, ch: int, cw: int) -> bytes:
    """The boxes and uniforms of a _DESC row: the packed uniform vector
    ``u`` (float32 bytes) on an h x w luma and a ch x cw chroma grid.  A
    live scene's sources keep their uniforms from frame to frame."""
    boxes = _boxes(u[12 * 4:18 * 4], h, w, ch, cw)
    return np.array(boxes, np.int32).tobytes() + u


def descriptors(size: Tuple[int, int], sources,
                out_fmt: PixelFormat) -> np.ndarray:
    """The kernel's per-source table (one _DESC row per source) for a
    ``size`` ``out_fmt`` target."""
    grids = (int(size[1]), int(size[0])) + chroma_grid(out_fmt, size)
    rows = []
    for planes, fmt, uni in sources:
        ptrs = [t.data_ptr() for t in planes] + [0] * (3 - len(planes))
        chroma = planes[1] if len(planes) > 1 else planes[0]
        rows.append(_ROW_HEAD.pack(*ptrs, _SRC_CODES[fmt], *planes[0].shape[:2],
                                   *chroma.shape[:2]))
        rows.append(_row_tail(packed(uni).tobytes(), *grids))
    return np.frombuffer(bytearray(b"".join(rows)), _DESC)


def _batch_dims(planes) -> Tuple[int, int, int, int]:
    """A batch's frame dims: luma (h, w), then chroma (h, w)."""
    chroma = planes[1] if len(planes) > 1 else planes[0]
    return tuple(planes[0].shape[1:3]) + tuple(chroma.shape[1:3])


def _cell_rows(cell_size: Tuple[int, int], cols: int, fmt: PixelFormat,
               dims: Tuple[int, ...], u: np.ndarray) -> np.ndarray:
    """The _DESC rows of a batch of cells with no plane pointers: format,
    dims, boxes on a ``cols``-wide grid (``cell_boxes``) and uniforms."""
    table = np.zeros(len(u), _DESC)
    table["fmt"] = _SRC_CODES[fmt]
    table["dims"] = dims
    table["box"] = cell_boxes(u, cell_size, cols)
    table["u"] = u
    return table


def _write_planes(rows: np.ndarray, planes, frames: np.ndarray) -> None:
    """Point ``rows`` at frames ``frames`` (uint64 indices) of the batch:
    each plane's pointer plus the frame index times its frame stride, so
    no frame is sliced on the host."""
    for k, p in enumerate(planes):
        rows["plane"][:, k] = (np.uint64(p.data_ptr())
                               + frames * np.uint64(p.stride(0)))


def cell_descriptors(cell_size: Tuple[int, int], planes, fmt: PixelFormat,
                     uniforms: np.ndarray, cols: int = 1) -> np.ndarray:
    """The table of a batch of cells: frame i of ``planes`` (the planes of
    ``fmt``, each with a leading axis of n contiguous frames), with
    packed uniform row i of ``uniforms``, on cell i of a ``cols``-wide
    grid of ``cell_size`` y420p cells (``cell_boxes``)."""
    u = np.asarray(uniforms, np.float32).reshape(-1, 29)
    table = _cell_rows(cell_size, cols, fmt, _batch_dims(planes), u)
    _write_planes(table, planes, np.arange(len(u), dtype=np.uint64))
    return table


def launch_plan(n: int) -> List[Tuple[int, int]]:
    """The launches of an n-source stack: [start, stop) slices of at most
    CAPACITY sources, one launch (a clear, or a copy of the target) when
    there are none.  Every launch after the first runs chained."""
    return [(a, min(a + CAPACITY, n)) for a in range(0, max(n, 1), CAPACITY)]


def axis_aligned(u: np.ndarray) -> np.ndarray:
    """Per packed uniform row of ``u`` ([n, 29] float32): whether its maps
    are axis-aligned (no rotation in the element, texture or border map:
    u[1], u[2], u[7], u[8], u[13], u[14] zero) and finite (every map term
    below 1e6 in size), as frame_composite.cu ``axis_aligned`` tests it."""
    u = np.asarray(u, np.float32).reshape(-1, 29)
    with np.errstate(invalid="ignore"):
        return ((u[:, [1, 2, 7, 8, 13, 14]] == 0).all(1)
                & (np.abs(u[:, :18]) < np.float32(1e6)).all(1))


def cell_mode(rows: np.ndarray, cell: Tuple[int, int],
              size: Tuple[int, int]) -> int:
    """The mode word of a cell launch onto a ``size`` band of ``cell`` =
    (w, h) cells with the _DESC ``rows`` as its sources: the row kernel
    (ROWS, and in bits 16-31 the band's cell of source 0) where every
    source's maps are axis-aligned and source j's boxes lie inside cell
    first + j of the band (row-major) on both grids, as ``CellPlan`` lays
    them out; else the tile kernel (TILES).  The C call gives a launch so
    marked to the tile kernel all the same where a source's format or
    width, or the cell's width, is beyond the row kernel
    (frame_composite.cu takes_rows)."""
    w, h = int(cell[0]), int(cell[1])
    n = len(rows)
    if not (n and bool(axis_aligned(rows["u"]).all())):
        return TILES
    cols = int(size[0]) // w
    box = rows["box"].astype(np.int64)
    # the cell of each source from its luma box's first pixel
    luma = box[:, 0]
    drawn = (luma[:, 1] > luma[:, 0]) & (luma[:, 3] > luma[:, 2])
    firsts = set(((luma[:, 0] // h) * cols + luma[:, 2] // w
                  - np.arange(n))[drawn].tolist())
    first = firsts.pop() if len(firsts) == 1 else 0 if not firsts else -1
    if not 0 <= first < 1 << 15:
        return TILES
    r, c = np.divmod(first + np.arange(n), cols)
    for grid, (gh, gw) in enumerate(((h, w), (h // 2, w // 2))):
        y0, y1, x0, x1 = box[:, grid].T
        inside = ((y0 >= r * gh) & (y1 <= (r + 1) * gh)
                  & (x0 >= c * gw) & (x1 <= (c + 1) * gw))
        if not (inside | (y1 <= y0) | (x1 <= x0)).all():
            return TILES
    return ROWS | first << 16


# a FrameParams is kept as whole 64-bit words (CellPlan.words)
assert _PARAMS.itemsize % 8 == 0


def cell_launch_plan(n: int, cols: int,
                     rows: int) -> List[Tuple[int, int, int, int, bool]]:
    """The launches of n cells in row-major order on a grid of ``cols`` x
    ``rows`` cells: (a, b, r0, r1, chained), cells [a, b) of at most
    CAPACITY onto the band of cell rows [r0, r1).  A launch runs chained
    when its first cell row holds cells of the launch before it.  A launch
    that starts a chain also writes every row its chained successors reach,
    and the last launch every row below the last cell, so no launch reads
    a row that no launch has written and no cell is left unwritten (a cell
    no source covers comes out as the clear)."""
    plan = []
    for a, b in launch_plan(n):
        chained = a % cols != 0
        if not chained:
            head = len(plan)
        plan.append([a, b, a // cols, -(-b // cols), chained])
        plan[head][3] = max(plan[head][3], plan[-1][3])
    plan[-1][3] = plan[head][3] = rows
    return [tuple(p) for p in plan]


def pack_params(size: Tuple[int, int], out_fmt: PixelFormat, outs,
                rows: np.ndarray, chained: bool,
                cell: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """One launch's FrameParams: the target's planes, shape and chroma
    grid, its cell grid (``cell`` = (w, h) of a y420p target's cells, in
    rows and columns that tile the target, or None), ``rows`` (at most
    CAPACITY _DESC rows) as its sources, and its kernel (a cell launch's
    ``cell_mode``, else the tile kernel)."""
    if len(rows) > CAPACITY:
        raise ValueError(f"{len(rows)} sources in one launch, at most "
                         f"{CAPACITY}")
    if cell is not None:
        cell_w, cell_h = int(cell[0]), int(cell[1])
        if out_fmt != PixelFormat.y420p:
            raise ValueError(f"a cell grid needs a y420p target, not {out_fmt}")
        if (cell_w <= 0 or cell_h <= 0 or cell_w % 2 or cell_h % 2
                or int(size[0]) % cell_w or int(size[1]) % cell_h):
            raise ValueError(f"cells of {cell} do not tile a y420p {size} "
                             f"target as a grid of even-sized cells")
    params = np.zeros((), _PARAMS)
    head = params["head"]
    head["out"][:len(outs)] = [t.data_ptr() for t in outs]
    head["n"] = len(rows)
    head["w"], head["h"] = int(size[0]), int(size[1])
    head["out_fmt"] = _OUT_CODES[out_fmt]
    head["chained"] = int(chained)
    head["ch"], head["cw"] = chroma_grid(out_fmt, size)
    if cell is not None:
        head["cell_h"], head["cell_w"] = cell_h, cell_w
        head["mode"] = cell_mode(rows, cell, size)
    params["src"][:len(rows)] = rows
    return params


class CellPlan:
    """The launches of one layout of cells, kept for every call that repeats
    it: the FrameParams of each launch of ``cell_launch_plan`` (``table``,
    and the same bytes as rows of 64-bit words, ``words``, read-only) with
    every field but the pointers filled in, each launch's target pointers
    holding its band's offsets into the canvas planes, each source's plane
    pointers its frame times the plane's frame stride, and the kernel each
    launch asks for (``pack_params``).  Nothing here depends on where the
    planes lie: a live wall's frames are new allocations every tick, and a
    call adds the planes' base addresses (``params`` on the host,
    ``sv_frame_cells`` in the launch).  The key:
    the cell size, the grid as the call gave it (None: one column), the
    format, each plane's shape and strides (u8), the device and the packed
    uniforms' float32 bytes."""

    __slots__ = ("cell", "grid_arg", "grid", "fmt", "shapes", "strides",
                 "device", "u", "table", "words", "ptr", "out_shapes")

    def __init__(self, cell, grid_arg, fmt, shapes, strides, device, u):
        self.cell, self.grid_arg, self.fmt = cell, grid_arg, fmt
        self.shapes, self.strides, self.device, self.u = (shapes, strides,
                                                          device, u)
        w, h = cell
        n = shapes[0][0]
        cols, rows = self.grid = (1, n) if grid_arg is None else grid_arg
        self.out_shapes = ((rows * h, cols * w),) + (
            (rows * h // 2, cols * w // 2),) * 2
        chroma = shapes[1] if len(shapes) > 1 else shapes[0]
        table = _cell_rows(cell, cols, fmt, shapes[0][1:3] + chroma[1:3],
                           np.frombuffer(u, np.float32).reshape(-1, 29))
        table["plane"][:, :len(strides)] = (
            np.arange(n, dtype=np.uint64)[:, None]
            * np.array([s[0] for s in strides], np.uint64))
        # a contiguous canvas plane's bytes per cell row
        row_bytes = np.array([h * cols * w] + [(h // 2) * (cols * w // 2)] * 2,
                             np.uint64)
        bands = cell_launch_plan(n, cols, rows)
        self.table = np.zeros(len(bands), _PARAMS)
        for k, (a, b, r0, r1, chained) in enumerate(bands):
            band = table[a:b].copy()
            band["box"][:, 0, :2] -= r0 * h
            band["box"][:, 1, :2] -= r0 * (h // 2)
            self.table[k] = pack_params((cols * w, (r1 - r0) * h),
                                        PixelFormat.y420p, (), band, chained,
                                        cell=cell)
            self.table[k]["head"]["out"] = np.uint64(r0) * row_bytes
        self._keep(self.table)

    def _keep(self, table: np.ndarray) -> None:
        table.flags.writeable = False
        self.table, self.ptr = table, table.ctypes.data
        self.words = table.view(np.uint64).reshape(len(table), -1)

    def on_tiles(self) -> "CellPlan":
        """The plan with every launch on the tile kernel (its mode words
        cleared): the same canvas by the other kernel, to compare the
        two."""
        other = copy.copy(self)
        table = self.table.copy()
        table["head"]["mode"] = TILES
        other._keep(table)
        return other

    def fits(self, cell_size, grid, planes, fmt) -> bool:
        """Whether a call's cell size, grid, format and planes are the
        plan's: each plane a u8 tensor on the plan's device of the plan's
        shape and strides (so each frame as contiguous as the plan's)."""
        if (tuple(cell_size) != self.cell or fmt is not self.fmt
                or (grid if grid is None else tuple(grid)) != self.grid_arg
                or len(planes) != len(self.shapes)):
            return False
        dev = self.device
        for p, shape, stride in zip(planes, self.shapes, self.strides):
            if not (isinstance(p, torch.Tensor) and p.dtype is torch.uint8
                    and p.shape == shape and p.stride() == stride
                    and p.device == dev):
                return False
        return True

    def params(self, outs, planes) -> np.ndarray:
        """The words ``sv_frame_cells`` launches for the canvas planes
        ``outs`` and the batch ``planes``: each launch's target pointers
        plus the canvas planes' addresses, and plane k of each of its
        sources plus plane k's address."""
        table = self.table.copy()
        table["head"]["out"] += np.array([o.data_ptr() for o in outs],
                                         np.uint64)
        bases = np.zeros(3, np.uint64)
        bases[:len(planes)] = [p.data_ptr() for p in planes]
        live = np.arange(CAPACITY) < table["head"]["n"][:, None]
        table["src"]["plane"] += np.where(live[..., None], bases,
                                          np.uint64(0))
        return table.view(np.uint64).reshape(len(table), -1)


# sv_frame_cells' count of the kernel launches it made, and of those the row
# kernel's (one a call: the C call runs without the GIL)
_Made = ctypes.c_int * 2

# the last plan a lookup returned: the one a steady caller repeats
_recent: Optional[CellPlan] = None


def _cell_uniforms(cell_size, uniforms, n: int):
    """``cell_size`` as (w, h) and ``uniforms`` as [n, 29] float32 rows,
    raising for a cell of odd or non-positive size or another count of
    rows."""
    w, h = int(cell_size[0]), int(cell_size[1])
    if w <= 0 or h <= 0 or w % 2 or h % 2:
        raise ValueError(f"cells of {cell_size} need even, positive sizes")
    u = np.ascontiguousarray(uniforms, np.float32).reshape(-1, 29)
    if len(u) != n:
        raise ValueError(f"{len(u)} uniform rows, not {n}")
    return (w, h), u


@lru_cache(maxsize=64)
def _plan(cell, grid_arg, fmt, shapes, strides, device, u) -> CellPlan:
    if spans.ON:
        spans.count("frame.cell_plan_misses")
    return CellPlan(cell, grid_arg, fmt, shapes, strides, device, u)


def cell_plan(cell_size: Tuple[int, int], grid: Optional[Tuple[int, int]],
              planes, fmt: PixelFormat, uniforms) -> CellPlan:
    """The kept plan of a call of ``composite_cells_cuda`` (its arguments
    as it takes them).  A call whose planes, cell size, grid, format and
    uniforms (by value) are the last plan's takes it after checking just
    that; any other goes through every check of the batch, raising what it
    finds, then takes the plan of its key, built on first use."""
    global _recent
    if spans.ON:
        spans.count("frame.cell_plan_lookups")
    planes = list(planes)
    plan = _recent
    if (plan is not None and plan.fits(cell_size, grid, planes, fmt)
            and np.asarray(uniforms, np.float32).tobytes() == plan.u):
        if spans.ON:
            spans.count("frame.cell_plan_fast")
        return plan
    dev, n = _check_batch(planes, fmt)
    (w, h), u = _cell_uniforms(cell_size, uniforms, n)
    cols, rows = (1, n) if grid is None else (int(grid[0]), int(grid[1]))
    if cols <= 0 or rows <= 0 or cols * rows < n:
        raise ValueError(f"a grid of {cols}x{rows} cells holds fewer than "
                         f"{n} frames")
    plan = _recent = _plan(
        (w, h), None if grid is None else (cols, rows), fmt,
        tuple(tuple(p.shape) for p in planes),
        tuple(p.stride() for p in planes), dev, u.tobytes())
    return plan


def cell_params(cell_size: Tuple[int, int], grid: Tuple[int, int], planes,
                fmt: PixelFormat, uniforms: np.ndarray,
                outs) -> List[np.ndarray]:
    """The FrameParams, as 64-bit words, of each launch that puts frame i
    of ``planes`` on cell i of the ``grid`` = (columns, rows) canvas
    ``outs`` (its three contiguous y420p planes): what
    ``composite_cells_cuda`` launches, its plan's words with the canvas's
    and the planes' addresses added (``CellPlan.params``)."""
    planes = list(planes)
    return list(cell_plan(cell_size, grid, planes, fmt, uniforms)
                .params(outs, planes))


# each rung's block of a ladder canvas starts on this many bytes, as a fresh
# torch.empty does on the card
LADDER_ALIGN = 512


def launch_order(sizes) -> List[int]:
    """The order of a ladder's rungs (``sizes`` = [(w, h)]) in its launch
    table (``LadderPlan``): by cell width, widest first, with the rungs of
    the widest width last, ties in rung order.  A stopgap tied to
    ``kMerge`` = 2 in ``sv_frame_cells``, which merges consecutive launches
    whatever their cell widths: once the C entry merges only launches of
    one shared-memory size, the table can keep rung order and this goes."""
    widest = max(w for w, _h in sizes)
    return sorted(range(len(sizes)),
                  key=lambda k: (sizes[k][0] == widest, -sizes[k][0]))


class LadderPlan:
    """The launches of a rendition ladder, kept for every call that repeats
    it: each rung's ``CellPlan`` (one column of n cells of the rung's size,
    every frame with the rung's packed uniform), their FrameParams one
    rung after another in ``order`` (``table``, ``words`` and ``ptr`` as
    ``CellPlan`` keeps them), each rung's target pointers shifted to its
    block of three flat canvases, one a plane (``sizes`` bytes each).  The
    blocks lie in rung order, each on ``LADDER_ALIGN`` bytes, and
    ``views`` gives rung k's plane j as ``as_strided`` arguments: [n, h, w]
    luma, [n, h / 2, w / 2] chroma.  The key: the format, each plane's
    shape and strides (u8), the device and each rung's ((w, h), packed
    uniform's float32 bytes).

    ``order`` (``launch_order``) puts the rungs by cell width, widest
    first, but the widest last: ``sv_frame_cells`` merges consecutive
    launches two to a row-kernel launch, whose blocks all take the shared
    memory of its widest cell, so a rung merged with a wider one runs
    fewer blocks at once.  The widest rung then runs alone and the others
    merge with their nearest widths (PERF.md: 262 against 280 us a tick of
    K1 in rung order on the HLS ladder)."""

    __slots__ = ("fmt", "device", "rungs", "plans", "order", "offsets",
                 "sizes", "views", "table", "words", "ptr")

    def __init__(self, fmt, shapes, strides, device, rungs):
        self.fmt, self.device, self.rungs = fmt, device, rungs
        n = shapes[0][0]
        self.plans = [CellPlan(size, None, fmt, shapes, strides, device,
                               u * n) for size, u in rungs]
        at = [0, 0, 0]
        self.offsets, self.views = [], []
        for plan in self.plans:
            self.offsets.append(tuple(at))
            views = []
            for k, (rows, w) in enumerate(plan.out_shapes):
                views.append(((n, rows // n, w), (rows // n * w, w, 1), at[k]))
                at[k] += -(-rows * w // LADDER_ALIGN) * LADDER_ALIGN
            self.views.append(tuple(views))
        self.sizes = tuple(at)
        self.order = launch_order([size for size, _u in rungs])
        table = np.concatenate([self.plans[k].table for k in self.order])
        table["head"]["out"] += np.repeat(
            np.array([self.offsets[k] for k in self.order], np.uint64),
            [len(self.plans[k].table) for k in self.order], axis=0)
        self._keep(table)

    _keep = CellPlan._keep
    params = CellPlan.params

    def fits(self, planes, fmt, rungs) -> bool:
        """Whether a call's planes and format are the plan's (as
        ``CellPlan.fits`` tests them) and its rungs, in order, the plan's
        sizes and packed uniforms by value."""
        if len(rungs) != len(self.rungs) or not self.plans[0].fits(
                self.plans[0].cell, None, planes, fmt):
            return False
        for (size, u), (cell, kept) in zip(rungs, self.rungs):
            if (tuple(size) != cell
                    or np.asarray(u, np.float32).tobytes() != kept):
                return False
        return True


# the last ladder plan a lookup returned
_recent_ladder: Optional[LadderPlan] = None


@lru_cache(maxsize=16)
def _ladder(fmt, shapes, strides, device, rungs) -> LadderPlan:
    if spans.ON:
        spans.count("frame.cell_plan_misses")
    return LadderPlan(fmt, shapes, strides, device, rungs)


def ladder_plan(planes, fmt: PixelFormat, rungs) -> LadderPlan:
    """The kept plan of a call of ``composite_ladder_cuda`` (its arguments
    as it takes them), one cell-plan lookup: a call whose planes, format
    and rungs (sizes and uniforms by value, in order) are the last ladder
    plan's takes it after checking just that; any other goes through every
    check ``cell_plan`` makes of each rung, raising what it raises, then
    takes the plan of its key, built on first use."""
    global _recent_ladder
    if spans.ON:
        spans.count("frame.cell_plan_lookups")
    planes, rungs = list(planes), list(rungs)
    plan = _recent_ladder
    if plan is not None and plan.fits(planes, fmt, rungs):
        if spans.ON:
            spans.count("frame.cell_plan_fast")
        return plan
    if not rungs:
        raise ValueError("a ladder needs at least one rung")
    dev, _n = _check_batch(planes, fmt)
    keyed = []
    for size, uniform in rungs:
        cell, u = _cell_uniforms(size, uniform, 1)
        keyed.append((cell, u.tobytes()))
    plan = _recent_ladder = _ladder(
        fmt, tuple(tuple(p.shape) for p in planes),
        tuple(p.stride() for p in planes), dev, tuple(keyed))
    return plan


def _launch_cells(plan, outs, planes, dev: torch.device,
                  echo: Optional[np.ndarray] = None) -> None:
    """Make ``plan``'s launches (a ``CellPlan`` or a ``LadderPlan``) onto
    the canvas planes ``outs`` from the batch ``planes`` with one C call,
    and count the kernel launches it reports; ``echo`` ([launches, words]
    u64) receives each launch's words as launched."""
    global launches
    bases = [p.data_ptr() for p in planes] + [0] * (3 - len(planes))
    made = _Made()
    nvcc.launch(build().sv_frame_cells, dev, plan.ptr, len(plan.words),
                outs[0].data_ptr(), outs[1].data_ptr(), outs[2].data_ptr(),
                *bases, None if echo is None else echo.ctypes.data,
                ctypes.addressof(made), span="frame.launch")
    launches += made[0]
    if spans.ON:
        spans.count("frame.cell_launches", made[0])
        spans.count("frame.cell_row_launches", made[1])
    kernel_launches[YUV_KERNEL] += made[0]


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
    for a, b in launch_plan(len(sources)):
        params = pack_params(size, out_fmt, outs, table[a:b],
                             a > 0 or target is not None)
        nvcc.launch(lib.sv_frame_composite, dev, params.ctypes.data,
                    span="frame.launch")
        launches += 1
        kernel_launches[kernel] += 1
    return outs


def _check_batch(planes, fmt: PixelFormat) -> Tuple[torch.device, int]:
    """Validate a batch of frames (each plane with a leading frame axis,
    each frame contiguous, as ``_check`` validates its first); returns the
    one device they live on and the frame count."""
    counts = {p.shape[0] if isinstance(p, torch.Tensor) and p.dim() > 1
              else 0 for p in planes}
    if len(counts) != 1 or 0 in counts:
        raise ValueError(f"planes {[getattr(p, 'shape', p) for p in planes]} "
                         f"are not one batch of frames")
    return _check([([p[0] for p in planes], fmt, None)], None, None), \
        counts.pop()


def composite_cells_cuda(cell_size: Tuple[int, int], planes,
                         fmt: PixelFormat, uniforms, *,
                         grid: Optional[Tuple[int, int]] = None
                         ) -> List[torch.Tensor]:
    """Composite frame i of a batch — ``planes``, the planes of ``fmt``
    each with a leading axis of n frames (u8, each frame contiguous), and
    ``uniforms``, [n, 29] packed — alone onto cell i of a y420p canvas of
    ``grid`` = (columns, rows) cells of ``cell_size`` = (w, h), even, in
    row-major order: cell i at row r = i // columns and column c = i %
    columns holds (luma rows r h to (r + 1) h, columns c w to (c + 1) w)
    bit for bit what ``composite_frame_cuda`` makes of that frame alone on
    a cleared cell, and every cell past the last frame is the clear (luma
    0, chroma 128).  Without ``grid`` the canvas is one column of n cells.
    Returns the canvas's three u8 planes, [rows h, columns w] and two
    [rows h / 2, columns w / 2], on the frames' device.  On the card: one
    launch a ``CAPACITY`` cells onto its band of cell rows, chained where a
    band shares a row with the launch before (``cell_launch_plan``), all
    made by one C call from the layout's kept plan (``cell_plan``); CPU
    tensors take the plain per-cell fold (``composite_cells_torch``)."""
    span = spans.ON and spans.begin("frame.cells")
    planes = list(planes)
    plan = cell_plan(cell_size, grid, planes, fmt, uniforms)
    dev = plan.device
    if dev.type == "cpu":
        frames = zip(*(p.unbind(0) for p in planes))
        unis = np.frombuffer(plan.u, np.float32).reshape(-1, 29)
        outs = composite_cells_torch(
            plan.cell, [(list(f), fmt, u) for f, u in zip(frames, unis)], dev,
            grid=plan.grid)
        if span:
            spans.end(span)
        return outs
    if dev.type != "cuda":
        raise ValueError(f"frame kernel runs on cuda, not {dev}")
    # the shape as separate ints: torch parses them faster than a tuple
    outs = [torch.empty(*s, dtype=torch.uint8, device=dev)
            for s in plan.out_shapes]
    _launch_cells(plan, outs, planes, dev)
    if span:
        spans.end(span)
    return outs


def composite_ladder_cuda(planes, fmt: PixelFormat, rungs
                          ) -> List[Tuple[torch.Tensor, ...]]:
    """Composite every frame of a batch — ``planes`` as
    ``composite_cells_cuda`` takes them — alone onto a cell of each rung
    of a ladder, ``rungs`` = [((w, h), packed uniform [29])]: rung k's
    canvas is bit for bit ``composite_cells_cuda``'s with that cell size
    and that uniform for every frame.  Returns one (y, u, v) a rung, in
    rung order, [n, h, w] and two [n, h / 2, w / 2] u8 views on the
    frames' device.  The rungs share storage, one flat canvas a plane: a
    caller that keeps a rung past the next call clones it, or it keeps
    the whole ladder's canvases alive.  One kept plan (``ladder_plan``),
    three allocations and one C call for every rung's launches; the card
    only (the CPU takes ``composite_cells_cuda`` a rung)."""
    span = spans.ON and spans.begin("frame.cells")
    planes = list(planes)
    plan = ladder_plan(planes, fmt, rungs)
    dev = plan.device
    if dev.type != "cuda":
        raise ValueError(f"frame kernel runs on cuda, not {dev}")
    flats = [torch.empty(s, dtype=torch.uint8, device=dev)
             for s in plan.sizes]
    _launch_cells(plan, flats, planes, dev)
    if span:
        spans.end(span)
    return [tuple(f.as_strided(*v) for f, v in zip(flats, views))
            for views in plan.views]
