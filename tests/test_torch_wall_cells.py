"""The frame kernel's cell launch (``ops/frame.py::composite_cells_cuda``)
and the routes that take it on the card, on the CPU.

* The launch data: the cell grid in the ``FrameParams`` header (still a
  64-byte header, 6208 bytes in all), and each source's boxes: its boxes on
  a cell-sized target shifted down to its own cell and clipped to it, on
  the luma and the chroma grid, at the wall's 240x136 tile and at a 34x18
  tile whose chroma cell (17x9) is odd both ways; every pixel a source
  changes lies inside its box; the box cache tells cell sizes apart.
* The canvas of cell rows and columns: boxes shifted to each cell's row
  and column (grids whose width does not divide 32 included), the launch
  bands and their chaining, the launch table kept per layout (the cell
  plan) against a fresh build after new frames at new addresses, its
  rebuild on a new key (uniforms, strides, dims, grid), its counters, and
  the launches run on a CPU emulation of the kernel's launch semantics
  against the plain canvas.
* The plain version of the cell launch: bit for bit the per-cell fold (one
  frame composite per cell, stacked, or blanked and placed on the canvas
  by the wall's own assembly), and within 1 LSB of the JAX package's
  ``MixingWall`` on the 8-device CPU mesh of tests/conftest.py.
* The routes on the card, with the cell launch and the frame launch
  replaced by a recorder that folds with ``composite.apply_composite`` and
  the plain version replaced by a raiser: on a ``cuda`` wall both video
  paths make one cell call a tick (ceil(n / 32) launches) for 16, 60 and 64
  streams, no product call and no plain call, and give the CPU wall's
  per-cell pixels bit for bit; ``scale_y420p`` makes one frame-kernel call
  a rung and ``scale_y420p_batch`` one cell call; on one card the wall
  assembles nothing, and an aligned rank (a stubbed group of 4) writes its
  band of rows straight from its cell call.  The ladder's route is
  decided by the planes' device, so ``meta`` tensors stand in for CUDA
  ones there.  A cell grid on any target but y420p raises.

Inputs come from ``np.random.default_rng``.  Tolerance: 0 between the
port's plain versions, 1 LSB against the JAX wall (its default cells are
float32 products).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swiftvideo_tpu.parallel import MixingWall as JaxWall, make_mesh
from swiftvideo_tpu_torch.core import spans
from swiftvideo_tpu_torch.media import PixelFormat as PortPF
from swiftvideo_tpu_torch.ops import composite, frame, matscale
from swiftvideo_tpu_torch.ops.uniforms import identity_uniforms, rect_uniforms
from swiftvideo_tpu_torch.parallel import MixingWall
from swiftvideo_tpu_torch.parallel import wall as wall_mod

CPU = torch.device("cpu")
CAP = frame.CAPACITY
TOL = 1
Y420P = PortPF.y420p
# the plain version, for expected results in the route tests (which replace
# it with a raiser)
PLAIN = composite.composite_stack_torch
CELLS = [(240, 136), (34, 18)]


def _u8(rng, *shape):
    return rng.integers(0, 256, shape, np.int64).astype(np.uint8)


def _y420p(rng, w, h, n):
    return [_u8(rng, n, h, w), _u8(rng, n, h // 2, w // 2),
            _u8(rng, n, h // 2, w // 2)]


def _cell_uniforms(n, stream, cell, rng):
    """[n, 29] per-cell uniforms: identity, half opacity, an aspect inset
    with a fill colour and a border, a rect overhanging the cell's top and
    bottom, one overhanging its right edge (edges at quarter pixels, clear
    of exact-integer seams).  Cell 0 is at half opacity, cell 1 overhangs
    the top and bottom."""
    tw, th = cell
    kinds = [
        lambda: identity_uniforms(stream, cell),
        lambda: identity_uniforms(stream, cell, opacity=0.5),
        lambda: rect_uniforms(stream, cell, x=1.25, y=2.25, w=tw - 2.5,
                              h=th - 4.5, fill_color=(0.9, 0.2, 0.1, 0.6),
                              border=(0.25, 0.25, tw - 0.5, th - 0.5)),
        lambda: rect_uniforms(stream, cell, x=3.25, y=-1.75, w=tw * 0.75,
                              h=th * 1.25, opacity=0.8),
        lambda: rect_uniforms(stream, cell, x=tw * 0.5 + 0.25, y=0.25,
                              w=tw * 0.75, h=th * 0.5, opacity=0.9),
    ]
    picks = [1, 3] + [int(k) for k in rng.integers(0, len(kinds),
                                                   max(n - 2, 0))]
    return np.stack([kinds[k]().pack() for k in picks[:n]])


def _batch(rng, n, stream, cell):
    """n y420p frames as [n, h, w] planes, and per-cell uniforms."""
    planes = [torch.from_numpy(a) for a in _y420p(rng, *stream, n)]
    return planes, _cell_uniforms(n, stream, cell, rng)


def _per_cell_fold(cell, planes, unis):
    """Each frame alone onto its own cleared cell, stacked: the wall's
    per-cell route before the cell launch existed."""
    cells = [PLAIN(Y420P, cell, [([p[i] for p in planes], Y420P, u)], CPU)
             for i, u in enumerate(unis)]
    return [torch.cat(planes) for planes in zip(*cells)]


# --- the launch data ---------------------------------------------------------

def test_pack_params_carries_the_cell_grid():
    rng = np.random.default_rng(1)
    cell, n = (240, 136), 3
    planes, unis = _batch(rng, n, (64, 36), cell)
    size = (cell[0], n * cell[1])
    outs = composite.clear_planes(Y420P, size, CPU)
    rows = frame.cell_descriptors(cell, planes, Y420P, unis)
    raw = frame.pack_params(size, Y420P, outs, rows, False, cell=cell).tobytes()
    assert frame._HEADER.itemsize == 64
    assert len(raw) == 64 + CAP * 192 == 6208
    # header: out[3] (u64), n, h, w, out_fmt, chained, ch, cw, cell_h,
    # cell_w, mode (i32)
    n_at, h, w, fmt_code, chained = np.frombuffer(raw, "<i4", 5, 24)
    assert (n_at, h, w, fmt_code, chained) == (n, n * 136, 240, 0, 0)
    assert tuple(np.frombuffer(raw, "<i4", 2, 44)) == (n * 68, 120)
    assert tuple(np.frombuffer(raw, "<i4", 3, 52)) == (136, 240, frame.ROWS)
    for i in range(n):
        at = 64 + 192 * i
        # each frame's planes by its frame stride; the frame's dims
        ptrs = np.frombuffer(raw, "<u8", 3, at)
        assert list(ptrs) == [p[i].data_ptr() for p in planes]
        assert list(np.frombuffer(raw, "<i4", 4, at + 28)) == [36, 64, 18, 32]
        box = np.frombuffer(raw, "<i4", 8, at + 44).reshape(2, 4)
        assert np.array_equal(box, rows["box"][i])
        u = np.frombuffer(raw, "<f4", 29, at + 76)
        assert np.array_equal(u.view(np.uint32),
                              unis[i].astype(np.float32).view(np.uint32))
    # no cell grid: the three words stay 0, as every other launch packs
    # them
    plain = frame.pack_params(size, Y420P, outs, rows, False).tobytes()
    assert not any(np.frombuffer(plain, "<i4", 3, 52))
    assert raw[:52] == plain[:52] and raw[64:] == plain[64:]
    text = frame.SOURCE.read_text()
    assert "int cell_h, cell_w;" in text and "int mode;" in text


@pytest.mark.parametrize("out_fmt", [PortPF.y422p, PortPF.y444p, PortPF.nv12,
                                     PortPF.RGBA], ids=lambda f: f.value)
def test_cell_grid_needs_a_y420p_target(out_fmt):
    rng = np.random.default_rng(2)
    cell = (34, 18)
    planes, unis = _batch(rng, 2, (32, 16), cell)
    size = (34, 36)
    outs = composite.clear_planes(out_fmt, size, CPU)
    rows = frame.cell_descriptors(cell, planes, Y420P, unis)
    with pytest.raises(ValueError, match="y420p"):
        frame.pack_params(size, out_fmt, outs, rows, False, cell=cell)


@pytest.mark.parametrize("cell,size", [((34, 18), (34, 27)),
                                       ((33, 18), (33, 36)),
                                       ((34, 18), (51, 36)),
                                       ((68, 18), (34, 36))],
                         ids=["rows do not divide", "odd cell",
                              "columns do not divide",
                              "cell wider than the target"])
def test_cell_grid_must_tile_the_target(cell, size):
    outs = composite.clear_planes(Y420P, size, CPU)
    with pytest.raises(ValueError, match="do not tile"):
        frame.pack_params(size, Y420P, outs, np.zeros(0, frame._DESC), False,
                          cell=cell)


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: "x".join(map(str, c)))
def test_cell_boxes_are_cell_boxes_shifted_to_each_cell(cell):
    tw, th = cell
    n = 7
    unis = _cell_uniforms(n, (64, 36), cell, np.random.default_rng(3))
    boxes = frame.cell_boxes(unis, cell)
    local = frame.border_boxes(unis, cell, Y420P)
    assert boxes.shape == (n, 2, 4) and boxes.dtype == np.int32
    for i in range(n):
        assert np.array_equal(boxes[i, 0], local[i, 0] + [i * th, i * th, 0, 0])
        assert np.array_equal(boxes[i, 1], local[i, 1]
                              + [i * th // 2, i * th // 2, 0, 0])
        for (y0, y1, x0, x1), (gh, gw) in zip(boxes[i], ((th, tw),
                                                         (th // 2, tw // 2))):
            assert i * gh <= y0 <= y1 <= (i + 1) * gh
            assert 0 <= x0 <= x1 <= gw
    # the table of a batch carries them
    planes, _ = _batch(np.random.default_rng(4), n, (64, 36), cell)
    table = frame.cell_descriptors(cell, planes, Y420P, unis)
    assert np.array_equal(table["box"], boxes)


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: "x".join(map(str, c)))
def test_every_changed_pixel_lies_in_its_cell_box(cell):
    """A source changes no pixel of the stack outside its box: the box test
    alone keeps it out of the neighbouring cells, which share its local
    positions."""
    n = 9
    planes, unis = _batch(np.random.default_rng(5), n, (64, 36), cell)
    stack = frame.composite_cells_cuda(cell, planes, Y420P, unis)
    boxes = frame.cell_boxes(unis, cell)
    clear = composite.clear_planes(Y420P, (cell[0], n * cell[1]), CPU)
    changed = [(p != c).numpy() for p, c in zip(stack, clear)]
    for grid, planes in ((0, changed[:1]), (1, changed[1:])):
        inside = np.zeros_like(planes[0])
        for y0, y1, x0, x1 in boxes[:, grid]:
            inside[y0:y1, x0:x1] = True
        for c in planes:
            assert c.any() and not (c & ~inside).any()


def test_box_cache_tells_cell_sizes_apart():
    """One border map on 240x136 cells, then on 240x68 cells: the second
    call gets the boxes of its own cells, not the cached ones of the first
    (the cache key holds the cell grid)."""
    u = identity_uniforms((64, 36), (240, 136)).pack()[None].repeat(2, 0)
    first = frame.cell_boxes(u, (240, 136))
    second = frame.cell_boxes(u, (240, 68))
    frame._boxes.cache_clear()
    assert np.array_equal(frame.cell_boxes(u, (240, 68)), second)
    assert np.array_equal(frame.cell_boxes(u, (240, 136)), first)
    assert not np.array_equal(first, second)
    assert second[1, 0, 0] == 68 and first[1, 0, 0] == 136


# (cell, columns): the wall's 240x136 tile on its 8 columns, the 34x18 tile
# (odd chroma cell) on 3, 5 and 7 columns (5 and 7 do not divide 32), and a
# 64x36 tile on 5
GRIDS = [((240, 136), 8), ((34, 18), 3), ((34, 18), 5), ((34, 18), 7),
         ((64, 36), 5)]


@pytest.mark.parametrize("cell,cols", GRIDS,
                         ids=lambda v: "x".join(map(str, v))
                         if isinstance(v, tuple) else f"{v} columns")
def test_cell_boxes_on_a_grid_are_cell_boxes_shifted_to_row_and_column(cell,
                                                                        cols):
    tw, th = cell
    n = 2 * cols + 3
    unis = _cell_uniforms(n, (64, 36), cell, np.random.default_rng(cols))
    boxes = frame.cell_boxes(unis, cell, cols)
    local = frame.border_boxes(unis, cell, Y420P)
    assert boxes.shape == (n, 2, 4) and boxes.dtype == np.int32
    for i in range(n):
        r, c = divmod(i, cols)
        assert np.array_equal(boxes[i, 0], local[i, 0]
                              + [r * th, r * th, c * tw, c * tw])
        assert np.array_equal(boxes[i, 1], local[i, 1]
                              + [r * th // 2, r * th // 2, c * tw // 2,
                                 c * tw // 2])
        for (y0, y1, x0, x1), (gh, gw) in zip(boxes[i], ((th, tw),
                                                         (th // 2, tw // 2))):
            assert r * gh <= y0 <= y1 <= (r + 1) * gh
            assert c * gw <= x0 <= x1 <= (c + 1) * gw
    # one column is the stack's boxes, and the table carries the grid's
    assert np.array_equal(frame.cell_boxes(unis, cell, 1),
                          frame.cell_boxes(unis, cell))
    planes, _ = _batch(np.random.default_rng(4), n, (64, 36), cell)
    table = frame.cell_descriptors(cell, planes, Y420P, unis, cols)
    assert np.array_equal(table["box"], boxes)


# (cells, columns, rows)
# (100 on 12 columns: two chains, the first of three launches)
PLANS = [(64, 8, 8), (60, 8, 8), (64, 5, 13), (100, 7, 15), (70, 40, 2),
         (33, 1, 33), (10, 4, 4), (1, 3, 2), (100, 12, 9)]


@pytest.mark.parametrize("n,cols,rows", PLANS,
                         ids=lambda v: str(v))
def test_cell_launch_plan_writes_a_row_before_a_chained_launch_reads_it(
        n, cols, rows):
    """Launches take the cells in row-major order, at most CAPACITY each;
    one runs chained exactly when its first row holds cells of the launch
    before; a chained launch reads only rows some launch wrote, an
    unchained one writes only rows none wrote, and together they write
    every row of the canvas."""
    plan = frame.cell_launch_plan(n, cols, rows)
    assert [(a, b) for a, b, *_ in plan] == frame.launch_plan(n)
    written = set()
    for a, b, r0, r1, chained in plan:
        assert b - a <= CAP and 0 <= r0 < r1 <= rows
        assert r0 == a // cols and r1 >= -(-b // cols)
        assert chained == (a % cols != 0)
        band = set(range(r0, r1))
        if chained:
            assert band <= written
        else:
            assert not band & written
        written |= band
    assert written == set(range(rows))
    # grids whose rows take whole launches never chain
    if CAP % cols == 0:
        assert not any(p[4] for p in plan)


def _fresh_params(cell, grid, planes, unis, outs):
    """Each launch's FrameParams built from nothing kept: the table of
    the batch (``cell_descriptors``), cut to the launch, its boxes moved up
    to the band, packed onto the band's slices of ``outs``."""
    tw, th = cell
    cols, rows = grid
    table = frame.cell_descriptors(cell, planes, Y420P, unis, cols)
    launches = []
    for a, b, r0, r1, chained in frame.cell_launch_plan(len(unis), cols, rows):
        band_rows = table[a:b].copy()
        band_rows["box"][:, 0, :2] -= r0 * th
        band_rows["box"][:, 1, :2] -= r0 * (th // 2)
        band = [o[r0 * r:r1 * r] for o, r in zip(outs, (th, th // 2, th // 2))]
        launches.append(frame.pack_params((cols * tw, (r1 - r0) * th), Y420P,
                                          band, band_rows, chained, cell=cell))
    return launches


@pytest.fixture
def plan_counts(monkeypatch):
    """No cell plan kept and the port's recorder on; returns a function
    that gives the (lookups, misses) counted since it was last called."""
    frame._plan.cache_clear()
    monkeypatch.setattr(frame, "_recent", None)
    spans.start()

    def counts():
        c = spans.stop().counters
        spans.start()
        return (c.get("frame.cell_plan_lookups", 0),
                c.get("frame.cell_plan_misses", 0))
    yield counts
    spans.stop()


@pytest.mark.parametrize("n,cols,rows", [(9, 3, 3), (40, 7, 6), (64, 8, 8),
                                         (70, 40, 2)], ids=lambda v: str(v))
def test_kept_launch_table_after_a_pointer_rewrite_equals_a_fresh_build(
        plan_counts, n, cols, rows):
    """Three batches of new frames at new addresses, one layout: the
    plan is built once, and each call's params (the plan's words with the
    addresses added) are byte for byte a fresh build's; new uniforms make a
    new plan."""
    cell = (34, 18)
    rng = np.random.default_rng(40 + n)
    unis = _cell_uniforms(n, (32, 16), cell, rng)
    size = (cols * cell[0], rows * cell[1])
    for k in range(4):
        if k == 3:
            unis = unis.copy()
            unis[0] = rect_uniforms((32, 16), cell, x=2.25, y=1.25, w=20.5,
                                    h=10.5).pack()
        planes, _ = _batch(rng, n, (32, 16), cell)
        outs = composite.clear_planes(Y420P, size, CPU)
        got = frame.cell_params(cell, (cols, rows), planes, Y420P, unis, outs)
        want = _fresh_params(cell, (cols, rows), planes, unis, outs)
        assert len(got) == len(want) == len(frame.launch_plan(n))
        assert all(g.tobytes() == w.tobytes() for g, w in zip(got, want))
    # one lookup a call, one miss a build
    assert plan_counts() == (4, 2)


# a change to cell 35's uniforms (in the second of a 40-cell layout's two
# launches) and the kernel that launch then takes
_MODE_CHANGES = {
    "identity": (None, frame.ROWS),
    "rect": ("rect", frame.ROWS),
    **{f"u[{k}]": (k, frame.TILES) for k in (1, 2, 7, 8, 13, 14)},
    "nan": ("nan", frame.TILES),
    "inf": ("inf", frame.TILES),
    "1e6": ("1e6", frame.TILES),
}


@pytest.mark.parametrize("change", list(_MODE_CHANGES))
def test_cell_plan_marks_axis_aligned_launches_for_the_row_kernel(
        plan_counts, change):
    """A cell launch whose sources are all planar and axis-aligned is marked
    for the row kernel in its kept words; a rotation term (u[1], u[2],
    u[7], u[8], u[13], u[14] nonzero) or a map term that is not finite or
    not below 1e6 in size puts that launch on the tile kernel, and the
    other launch stays marked.  The mark is kept with the plan, and a
    changed uniform rebuilds it."""
    n, grid, cell, stream = 40, (8, 5), (34, 18), (32, 16)
    rng = np.random.default_rng(35)
    planes, _ = _batch(rng, n, stream, cell)
    unis = np.stack([identity_uniforms(stream, cell).pack()] * n)
    what, mode = _MODE_CHANGES[change]
    if what == "rect":
        unis[35] = rect_uniforms(stream, cell, x=3.25, y=-1.75, w=20.5,
                                 h=22.5, opacity=0.8,
                                 fill_color=(0.9, 0.2, 0.1, 0.6),
                                 border=(0.25, 0.25, 33.5, 17.5)).pack()
    elif what == "nan":
        unis[35, 4] = np.nan
    elif what == "inf":
        unis[35, 16] = np.inf
    elif what == "1e6":
        unis[35, 0] = 1e6
    elif what is not None:
        unis[35, what] = 0.125
    plan = frame.cell_plan(cell, grid, planes, Y420P, unis)
    modes = plan.table["head"]["mode"] & 255
    assert modes.tolist() == [frame.ROWS, mode]
    assert [int(w.view(frame._PARAMS)["head"]["mode"][0]) & 255
            for w in plan.words] == modes.tolist()
    again = frame.cell_plan(cell, grid, _batch(rng, n, stream, cell)[0],
                            Y420P, unis.copy())
    assert again is plan and plan_counts() == (2, 1)
    unis[35] = identity_uniforms(stream, cell).pack()
    fresh = frame.cell_plan(cell, grid, planes, Y420P, unis)
    assert (fresh is plan) == (what is None)
    assert (fresh.table["head"]["mode"] & 255).tolist() == [frame.ROWS] * 2
    assert plan_counts() == (1, int(what is not None))


@pytest.mark.parametrize("n,grid,rotated", [
    (40, None, None), (96, None, None), (64, (8, 8), None), (40, (7, 6), None),
    (70, (40, 2), None), (100, (12, 9), None), (40, None, 3),
    (64, (8, 8), 40)], ids=str)
def test_cell_plan_marks_each_launch_with_its_first_cell(n, grid, rotated):
    """Each FrameParams of a layout asks for the row kernel with, in bits
    16-31 of its mode word, the band's cell that its source 0 lies in
    (cells [a, b) onto the band of cell rows from r0: cell a - r0 * cols),
    chained bands included; the one that holds a rotated cell asks for the
    tile kernel."""
    cell, stream = (34, 18), (32, 16)
    rng = np.random.default_rng(n)
    planes, _ = _batch(rng, n, stream, cell)
    unis = np.stack([identity_uniforms(stream, cell).pack()] * n)
    if rotated is not None:
        unis[rotated, 1] = 0.125
    cols, rows = (1, n) if grid is None else grid
    plan = frame.cell_plan(cell, grid, planes, Y420P, unis)
    bands = frame.cell_launch_plan(n, cols, rows)
    want = [frame.TILES if rotated is not None and a <= rotated < b
            else frame.ROWS | (a - r0 * cols) << 16
            for a, b, r0, _r1, _chained in bands]
    assert len(plan.words) == len(bands) == -(-n // CAP)
    assert plan.table["head"]["mode"].tolist() == want


def _band(change):
    """The sources of the first FrameParams of a 64-cell 8x8 layout of
    34x18 cells, as ``CellPlan`` lays them out, with ``change`` made, and
    that launch's band size."""
    cell = (34, 18)
    rng = np.random.default_rng(64)
    planes, _ = _batch(rng, 64, (32, 16), cell)
    unis = np.stack([identity_uniforms((32, 16), cell).pack()] * 64)
    head = frame.cell_plan(cell, (8, 8), planes, Y420P, unis).table[0]
    rows = head["src"][:int(head["head"]["n"])].copy()
    box = rows["box"]
    if change == "luma box over the next cell":
        box[1, 0, 3] += cell[0]
    elif change == "chroma box over the next row":
        box[2, 1, 1] += cell[1] // 2
    elif change == "two sources swapped":
        box[[0, 1]] = box[[1, 0]]
    elif change == "an empty box":
        box[3, :, 1] = box[3, :, 0]
    return rows, cell, (int(head["head"]["w"]), int(head["head"]["h"]))


@pytest.mark.parametrize("change,marked", [
    ("as laid out", True), ("luma box over the next cell", False),
    ("chroma box over the next row", False), ("two sources swapped", False),
    ("an empty box", True)])
def test_cell_mode_marks_sources_each_in_its_own_cell(change, marked):
    """``cell_mode`` asks for the row kernel only where source j's boxes
    lie inside cell first + j of the band on both grids (a source that
    draws nothing places nothing); a box that reaches into another cell,
    or sources out of cell order, leave the launch to the tile kernel."""
    rows, cell, size = _band(change)
    assert frame.cell_mode(rows, cell, size) == (frame.ROWS if marked
                                                 else frame.TILES)


def test_plan_on_tiles_clears_only_the_mode_words():
    """``CellPlan.on_tiles``: the same launches, each asking for the tile
    kernel, kept read-only beside the plan, which is left as it was."""
    cell = (34, 18)
    rng = np.random.default_rng(7)
    planes, _ = _batch(rng, 64, (32, 16), cell)
    unis = np.stack([identity_uniforms((32, 16), cell).pack()] * 64)
    plan = frame.cell_plan(cell, (8, 8), planes, Y420P, unis)
    tiles = plan.on_tiles()
    assert tiles is not plan and tiles.out_shapes == plan.out_shapes
    assert (plan.table["head"]["mode"] & 255).tolist() == [frame.ROWS] * 2
    assert tiles.table["head"]["mode"].tolist() == [frame.TILES] * 2
    cleared = plan.table.copy()
    cleared["head"]["mode"] = frame.TILES
    assert tiles.table.tobytes() == cleared.tobytes()
    assert tiles.words.tobytes() == tiles.table.tobytes()
    assert tiles.ptr == tiles.table.ctypes.data
    assert not tiles.table.flags.writeable and not tiles.words.flags.writeable


def test_row_kernel_byte_to_float_is_the_tables_quotient():
    """frame_composite.cu u8f: v exactly (2^23 + v, less 2^23), times the
    reciprocal of 255 rounded to float32, corrected by one fused
    multiply-add of its residual, is v / 255 correctly rounded (the tile
    kernel's table) for every byte; worked in exact rationals, each step
    rounded to float32 as the card rounds it."""
    from fractions import Fraction

    def rn(x: Fraction) -> Fraction:
        f = np.float32(float(x))
        near = [np.nextafter(f, np.float32(-np.inf)), f,
                np.nextafter(f, np.float32(np.inf))]
        best = min(near, key=lambda c: (abs(Fraction(float(c)) - x),
                                        int(c.view(np.uint32)) & 1))
        return Fraction(float(best))

    r = Fraction(float(np.float32(float.fromhex("0x1.010102p-8"))))
    assert r == rn(Fraction(1, 255))
    for v in range(256):
        f = Fraction(np.float32(2 ** 23 + v).item()) - 2 ** 23
        q = rn(f * r)
        got = rn(rn(-q * 255 + f) * r + q)
        want = np.float32(v) / np.float32(255)
        assert got == Fraction(float(want)), v


def _changed(change, rng, n, planes, unis, grid):
    """The batch, uniforms and grid of a call that changes one part of the
    plan's key, or none ("equal uniforms": the same values in a new
    array)."""
    cell = (34, 18)
    if change == "uniforms in place":
        unis[4, 0] += 0.25
    elif change == "equal uniforms":
        unis = unis.copy()
    elif change == "strides":
        # every other frame of a batch twice as long: each frame's pointer
        # steps by twice the frame stride
        planes = [p[::2] for p in _batch(rng, 2 * n, (32, 16), cell)[0]]
    elif change == "dims":
        planes = _batch(rng, n, (48, 16), cell)[0]
    elif change == "grid":
        grid = (grid[0] + 1, grid[1])
    return planes, unis, grid


@pytest.mark.parametrize("change", ["uniforms in place", "equal uniforms",
                                    "strides", "dims", "grid"])
def test_cell_plan_is_rebuilt_when_its_key_changes(plan_counts, change):
    """A call that repeats the last plan's key at new addresses takes the
    plan; one that changes the uniforms (by value, even in the same array),
    the planes' strides or dims, or the grid builds a new plan, whose words
    are a fresh build's; the same values in a new array are the same
    key."""
    n, grid, cell = 9, (3, 3), (34, 18)
    rng = np.random.default_rng(90)
    planes, unis = _batch(rng, n, (32, 16), cell)
    first = frame.cell_plan(cell, grid, planes, Y420P, unis)
    again = frame.cell_plan(cell, grid, _batch(rng, n, (32, 16), cell)[0],
                            Y420P, unis)
    assert again is first and plan_counts() == (2, 1)
    planes, unis, grid = _changed(change, rng, n, _batch(rng, n, (32, 16),
                                                         cell)[0], unis, grid)
    plan = frame.cell_plan(cell, grid, planes, Y420P, unis)
    rebuilt = change != "equal uniforms"
    assert (plan is not first) == rebuilt
    assert plan_counts() == (1, int(rebuilt))
    size = (grid[0] * cell[0], grid[1] * cell[1])
    outs = composite.clear_planes(Y420P, size, CPU)
    got = frame.cell_params(cell, grid, planes, Y420P, unis, outs)
    want = _fresh_params(cell, grid, planes, unis, outs)
    assert all(g.tobytes() == w.tobytes() for g, w in zip(got, want))
    assert plan_counts() == (1, 0)


def _run_emulated(launches, planes, outs, cell, cols):
    """The kernel's launch semantics on CPU tensors, read from the params
    alone: a launch's band starts at its target pointers (offsets into
    ``outs``) and is cleared unless chained; each source row's frame is
    found from its plane pointers and frame strides, and the source is
    composited alone onto its frame's cell of the band, which must hold
    its boxes, changing no pixel outside them."""
    tw, th = cell
    cell_hw = ((th, tw), (th // 2, tw // 2), (th // 2, tw // 2))
    bases = [p.data_ptr() for p in planes]
    steps = [p.stride(0) for p in planes]
    for words in launches:
        params = words.view(frame._PARAMS).reshape(())
        head = params["head"]
        assert (int(head["cell_w"]), int(head["cell_h"])) == cell
        offs = [int(a) - o.data_ptr() for a, o in zip(head["out"], outs)]
        r0 = offs[0] // (outs[0].stride(0) * th)
        assert offs == [r0 * h * o.stride(0) for o, (h, _w) in zip(outs,
                                                                  cell_hw)]
        band_rows = int(head["h"]) // th
        assert int(head["w"]) == outs[0].shape[1]
        band = [o[r0 * h:(r0 + band_rows) * h] for o, (h, _w) in zip(outs,
                                                                    cell_hw)]
        if not int(head["chained"]):
            for t, fill in zip(band, (0, 128, 128)):
                t.fill_(fill)
        for row in params["src"][:int(head["n"])]:
            at = [int(q) - b for q, b in zip(row["plane"], bases)]
            i = at[0] // steps[0]
            assert at == [i * st for st in steps]
            r, c = divmod(i, cols)
            r -= r0
            cells = [t[r * h:(r + 1) * h, c * w:(c + 1) * w]
                     for t, (h, w) in zip(band, cell_hw)]
            new = composite.apply_composite(cells, Y420P,
                                            [p[i] for p in planes], Y420P,
                                            row["u"])
            for t, nw, box, (h, w) in zip(cells, new, (row["box"][0],
                                                      row["box"][1],
                                                      row["box"][1]),
                                          cell_hw):
                y0, y1, x0, x1 = (int(v) for v in box)
                y0, y1, x0, x1 = y0 - r * h, y1 - r * h, x0 - c * w, x1 - c * w
                assert 0 <= y0 <= y1 <= h and 0 <= x0 <= x1 <= w
                outside = torch.ones_like(t, dtype=torch.bool)
                outside[y0:y1, x0:x1] = False
                assert torch.equal(nw[outside], t[outside])
                t.copy_(nw)


@pytest.mark.parametrize("n,cols,rows", [(9, 3, 3), (40, 7, 6), (60, 8, 8),
                                         (70, 40, 2), (5, 1, 5), (100, 12, 9)],
                         ids=lambda v: str(v))
def test_cell_launches_on_an_emulated_kernel_give_the_plain_canvas(n, cols,
                                                                   rows):
    """The host side of the canvas launch, end to end: the params of every
    launch, run as the kernel runs a launch onto a target that starts as
    garbage (``torch.empty`` on the card), give the plain version's canvas
    bit for bit, blank cells and chained bands included."""
    cell = (34, 18)
    rng = np.random.default_rng(50 + n)
    planes, unis = _batch(rng, n, (64, 36), cell)
    size = (cols * cell[0], rows * cell[1])
    outs = [torch.from_numpy(_u8(rng, *t.shape))
            for t in composite.clear_planes(Y420P, size, CPU)]
    launches = frame.cell_params(cell, (cols, rows), planes, Y420P, unis, outs)
    _run_emulated(launches, planes, outs, cell, cols)
    want = frame.composite_cells_cuda(cell, planes, Y420P, unis,
                                      grid=(cols, rows))
    assert all(torch.equal(g, w) for g, w in zip(outs, want))


def test_cell_grid_must_hold_the_batch():
    planes, unis = _batch(np.random.default_rng(6), 7, (32, 16), (34, 18))
    for grid in ((3, 2), (0, 8), (7, 0)):
        with pytest.raises(ValueError, match="holds fewer"):
            frame.composite_cells_cuda((34, 18), planes, Y420P, unis,
                                       grid=grid)


# --- the plain version -------------------------------------------------------

@pytest.mark.parametrize("n", [1, 5, 33])
@pytest.mark.parametrize("cell", CELLS, ids=lambda c: "x".join(map(str, c)))
def test_cell_plain_version_equals_the_per_cell_fold(cell, n):
    planes, unis = _batch(np.random.default_rng(10 + n), n, (64, 36), cell)
    launches, calls = frame.launches, composite.calls
    got = frame.composite_cells_cuda(cell, planes, Y420P, unis)
    # CPU tensors: one plain composite per cell, no kernel launch
    assert (frame.launches, composite.calls) == (launches, calls + n)
    want = _per_cell_fold(cell, planes, unis)
    tw, th = cell
    assert [tuple(p.shape) for p in got] == [(n * th, tw),
                                             (n * th // 2, tw // 2),
                                             (n * th // 2, tw // 2)]
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    # and each cell is what a frame composite of that one source makes
    for i in (0, n - 1):
        one = frame.composite_frame_cuda(cell, [([p[i] for p in planes],
                                                 Y420P, unis[i])])
        for g, o, r in zip(got, one, (th, th // 2, th // 2)):
            assert torch.equal(g[i * r:(i + 1) * r], o)


@pytest.mark.parametrize("n,cols,rows", [(7, 3, 3), (60, 8, 8), (10, 4, 4),
                                         (12, 5, 3)], ids=lambda v: str(v))
def test_cell_plain_canvas_equals_the_assembled_per_cell_fold(n, cols, rows):
    """The plain canvas is the per-cell fold blanked and placed by the
    wall's own ``_blank_fix`` and ``_rows_assemble``, bit for bit, blank
    cells (luma 0, chroma 128) included."""
    cell = (34, 18)
    tw, th = cell
    planes, unis = _batch(np.random.default_rng(60 + n), n, (64, 36), cell)
    calls = composite.calls
    got = frame.composite_cells_cuda(cell, planes, Y420P, unis,
                                     grid=(cols, rows))
    assert composite.calls == calls + n
    wall = MixingWall(n_streams=n, stream_size=(64, 36),
                      canvas_size=(cols * tw, rows * th), grid=(cols, rows),
                      device="cpu")
    assert wall.tile == cell
    stack = _per_cell_fold(cell, planes, unis)
    want = [wall_mod._rows_assemble(wall._blank_fix(t.view(n, h, w), fill),
                                    rows, cols)
            for t, fill, (h, w) in zip(stack, wall_mod._FILL,
                                       ((th, tw), (th // 2, tw // 2),
                                        (th // 2, tw // 2)))]
    assert [tuple(g.shape) for g in got] == [tuple(w.shape) for w in want]
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_cell_launch_refuses_bad_batches(plan_counts):
    """Every bad batch raises what the full checks raise, after a good call
    of the same layout (so each meets the kept plan's check first); the
    kept plan stays the good one."""
    planes, unis = _batch(np.random.default_rng(6), 2, (32, 16), (34, 18))
    ys, us, vs = planes
    frame.composite_cells_cuda((34, 18), planes, Y420P, unis)
    kept = frame._recent
    assert kept is not None and plan_counts() == (1, 1)
    with pytest.raises(ValueError, match="even"):
        frame.composite_cells_cuda((33, 18), planes, Y420P, unis)
    with pytest.raises(ValueError, match="one batch"):
        frame.composite_cells_cuda((34, 18), [ys[:0], us[:0], vs[:0]], Y420P,
                                   unis[:0])
    with pytest.raises(ValueError, match="one batch"):
        frame.composite_cells_cuda((34, 18), [ys, us[:1], vs], Y420P, unis)
    with pytest.raises(ValueError, match="uniform rows"):
        frame.composite_cells_cuda((34, 18), planes, Y420P, unis[:1])
    with pytest.raises(ValueError, match="do not fit"):
        frame.composite_cells_cuda((34, 18), [ys, us, vs[:, :4].contiguous()],
                                   Y420P, unis)
    with pytest.raises(ValueError, match="contiguous"):
        frame.composite_cells_cuda((34, 18), [ys[:, :, ::2], us, vs], Y420P,
                                   unis)
    with pytest.raises(TypeError):
        frame.composite_cells_cuda((34, 18), [ys.float(), us, vs], Y420P,
                                   unis)
    assert frame._recent is kept and plan_counts() == (7, 0)
    # frames need not be adjacent: each frame's pointer steps by the frame
    # stride
    every_other = [p[::2] for p in _batch(np.random.default_rng(7), 4,
                                          (32, 16), (34, 18))[0]]
    rows = frame.cell_descriptors((34, 18), every_other, Y420P, unis)
    assert [list(r) for r in rows["plane"]] == [
        [p[i].data_ptr() for p in every_other] for i in range(2)]


# (name, streams, stream size, canvas)
WALLS = [("64 on 8x8", 64, (64, 36), (128, 96)),
         ("60 on 8x8", 60, (64, 36), (128, 96)),
         ("16 on 4x4", 16, (32, 18), (96, 56))]


def _inputs(seed, n, stream, samples):
    rng = np.random.default_rng(seed)
    ys, us, vs = _y420p(rng, *stream, n)
    audio = rng.integers(-30000, 30000, (n, samples * 2),
                         np.int64).astype(np.int16)
    gains = rng.choice(np.float32([0.25, 0.5, 1.0, 2.0]), n)
    return ys, us, vs, audio, gains


@pytest.mark.parametrize("wall_case", WALLS[:2], ids=lambda c: c[0])
@pytest.mark.parametrize("per_cell", [False, True],
                         ids=["default cells", "per-cell uniforms"])
def test_cell_plain_version_within_one_lsb_of_jax_wall(wall_case, per_cell):
    _name, n, stream, canvas = wall_case
    inputs = _inputs(n, n, stream, 8)
    wall = MixingWall(n_streams=n, stream_size=stream, canvas_size=canvas,
                      audio_samples=8, device="cpu")
    unis = (_cell_uniforms(n, stream, wall.tile, np.random.default_rng(n))
            if per_cell else wall.default_uniforms())
    calls = composite.calls
    ours = [o.numpy() for o in wall.step(*(wall.shard(a) for a in inputs),
                                         uniforms=unis)]
    assert composite.calls == calls + n
    jwall = JaxWall(make_mesh(jax.devices()[:8]), n_streams=n,
                    stream_size=stream, canvas_size=canvas, audio_samples=8)
    jargs = [jwall.shard(jnp.asarray(a)) for a in inputs]
    theirs = [np.asarray(o) for o in jwall.step(
        *jargs, uniforms=jwall.shard(jnp.asarray(unis)) if per_cell else None)]
    for a, b in zip(ours[:3], theirs[:3]):
        assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
        assert np.abs(a.astype(int) - b.astype(int)).max() <= TOL
    assert np.array_equal(ours[3], theirs[3])


# --- the routes on the card ----------------------------------------------------

@pytest.fixture
def recorder(monkeypatch):
    """The cell launch and the frame launch replaced by stand-ins that
    record each call and fold with ``composite.apply_composite`` (no plain-
    version call), each cell onto its place on the canvas of the call's
    grid; the plain version raises.  Returns the list of calls: ("cells",
    cell size, (planes, fmt, uniforms), grid) or ("frame", size,
    sources)."""
    seen = []

    def cells(cell_size, planes, fmt, uniforms, out_fmt=Y420P, *, grid=None):
        seen.append(("cells", tuple(cell_size), (list(planes), fmt,
                                                 np.asarray(uniforms)), grid))
        w, h = cell_size
        n = planes[0].shape[0]
        cols, rows = (1, n) if grid is None else grid
        cell_hw = ((h, w), (h // 2, w // 2), (h // 2, w // 2))
        if planes[0].device.type == "meta":
            return [torch.empty((rows * ch, cols * cw), dtype=torch.uint8,
                                device="meta") for ch, cw in cell_hw]
        canvas = composite.clear_planes(Y420P, (cols * w, rows * h), CPU)
        for i in range(n):
            r, c = divmod(i, cols)
            cell = [t[r * ch:(r + 1) * ch, c * cw:(c + 1) * cw]
                    for t, (ch, cw) in zip(canvas, cell_hw)]
            new = composite.apply_composite(cell, Y420P, [p[i] for p in planes],
                                            fmt, uniforms[i])
            for t, nw in zip(cell, new):
                t.copy_(nw)
        return canvas

    def one(size, sources, out_fmt=Y420P, *, device=None, target=None):
        seen.append(("frame", tuple(size), list(sources)))
        w, h = size
        return [torch.empty(s, dtype=torch.uint8, device="meta")
                for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2))]

    def plain(*args, **kwargs):
        raise AssertionError("the plain version ran on the card's route")

    monkeypatch.setattr(frame, "composite_cells_cuda", cells)
    monkeypatch.setattr(frame, "composite_frame_cuda", one)
    monkeypatch.setattr(composite, "composite_stack_torch", plain)
    return seen


@pytest.fixture
def card_wall(monkeypatch):
    """MixingWall on a ``cuda`` device in a process without a card; its
    inputs stay CPU tensors, handed to ``step`` directly."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)

    def make(n, stream, canvas):
        return MixingWall(n_streams=n, stream_size=stream, canvas_size=canvas,
                          audio_samples=8)
    return make


def _cpu_wall_per_cell(n, stream, canvas, inputs, unis):
    """The CPU wall's per-cell pixels, computed with the plain version kept
    aside at import."""
    wall = MixingWall(n_streams=n, stream_size=stream, canvas_size=canvas,
                      audio_samples=8, device="cpu")
    ys, us, vs = (torch.from_numpy(a) for a in inputs[:3])
    tw, th = wall.tile
    cells = [PLAIN(Y420P, (tw, th), [([ys[i], us[i], vs[i]], Y420P,
                                      unis[i])], CPU) for i in range(n)]
    tiles = [torch.stack(t) for t in zip(*cells)]
    return wall._assemble(tiles)


def _no_assembly(*args, **kwargs):
    raise AssertionError("the card's one-device route assembled tiles")


@pytest.mark.parametrize("wall_case", WALLS, ids=lambda c: c[0])
@pytest.mark.parametrize("per_cell", [False, True],
                         ids=["default cells", "per-cell uniforms"])
def test_card_wall_makes_one_cell_call_a_tick(recorder, card_wall, monkeypatch,
                                              wall_case, per_cell):
    _name, n, stream, canvas = wall_case
    wall = card_wall(n, stream, canvas)
    assert wall.device == torch.device("cuda", 0) and wall._plan is not None
    inputs = _inputs(20 + n, n, stream, 8)
    unis = (_cell_uniforms(n, stream, wall.tile, np.random.default_rng(n))
            if per_cell else None)
    products, calls = matscale.calls, composite.calls
    ys, us, vs, audio, gains = (torch.from_numpy(a) for a in inputs)
    # one card: straight onto the canvas, no assembly copy
    with monkeypatch.context() as m:
        m.setattr(wall_mod, "_rows_assemble", _no_assembly)
        m.setattr(MixingWall, "_blank_fix", _no_assembly)
        out = wall.step(ys, us, vs, audio, gains, uniforms=unis)
    assert (matscale.calls, composite.calls) == (products, calls)
    assert len(recorder) == 1
    kind, cell, (planes, fmt, got_unis), grid = recorder[0]
    assert (kind, cell, fmt, len(got_unis)) == ("cells", wall.tile, Y420P, n)
    assert grid == wall.grid_wh
    assert len(frame.launch_plan(n)) == math.ceil(n / CAP)
    want_unis = wall.default_uniforms() if unis is None else unis
    assert np.array_equal(got_unis, want_unis)
    assert all(torch.equal(p, a) for p, a in zip(planes, (ys, us, vs)))
    want = _cpu_wall_per_cell(n, stream, canvas, inputs, want_unis)
    assert all(torch.equal(g, w) for g, w in zip(out[:3], want))


@pytest.mark.parametrize("per_cell", [False, True],
                         ids=["default cells", "per-cell uniforms"])
def test_card_aligned_rank_writes_its_band_of_rows(recorder, card_wall,
                                                   monkeypatch, per_cell):
    """16 streams on a 4x4 wall over 4 ranks (aligned: a row of cells a
    rank): on the card each rank's one cell call puts its 4 streams
    straight onto its band of rows, which equals that band of the
    one-device CPU wall; no assembly, no video collective.  The audio is
    the rank's partial fold (the all_reduce stubbed to nothing)."""
    n, stream, canvas, world = 16, (32, 16), (64, 32), 4
    inputs = _inputs(70, n, stream, 8)
    unis = (_cell_uniforms(n, stream, (16, 8), np.random.default_rng(7))
            if per_cell else None)
    want = _cpu_wall_per_cell(n, stream, canvas, inputs, np.stack(
        [identity_uniforms(stream, (16, 8)).pack()] * n)
        if unis is None else unis)
    monkeypatch.setattr(wall_mod.dist, "get_world_size", lambda g: world)
    monkeypatch.setattr(wall_mod.dist, "all_reduce", lambda t, group: None)
    monkeypatch.setattr(wall_mod.dist, "all_gather", _no_assembly)
    monkeypatch.setattr(wall_mod, "_rows_assemble", _no_assembly)
    monkeypatch.setattr(MixingWall, "_blank_fix", _no_assembly)
    ys, us, vs, audio, gains = (torch.from_numpy(a) for a in inputs)
    for rank in range(world):
        monkeypatch.setattr(wall_mod.dist, "get_rank", lambda g, r=rank: r)
        wall = MixingWall(n_streams=n, stream_size=stream, canvas_size=canvas,
                          audio_samples=8, group=object())
        assert wall.aligned and wall.local == 4 and wall.tile == (16, 8)
        lo = slice(4 * rank, 4 * rank + 4)
        out = wall.step(ys[lo], us[lo], vs[lo], audio[lo], gains[lo],
                        uniforms=None if unis is None else unis[lo])
        assert recorder[-1][3] == (4, 1)
        if unis is None:
            assert np.array_equal(recorder[-1][2][2], wall.default_uniforms())
        for got, full, h in zip(out[:3], want, (8, 4, 4)):
            assert torch.equal(got, full[rank * h:(rank + 1) * h])
        part = np.clip(np.trunc((inputs[3][lo].astype(np.float64)
                                 * inputs[4][lo, None]).sum(0)), -32768, 32767)
        assert np.array_equal(out[3].numpy(), part)
    assert len(recorder) == world


def test_card_ladder_makes_one_launch_a_rung(recorder):
    """meta tensors stand in for CUDA tensors: the route follows the
    planes' device."""
    rungs = [(1280, 720), (854, 480), (640, 360)]
    src = [torch.empty(s, dtype=torch.uint8, device="meta")
           for s in ((1080, 1920), (540, 960), (540, 960))]
    products = matscale.calls
    for rung in rungs:
        plan = matscale.plan_scale(identity_uniforms((1920, 1080), rung), rung,
                                   (1080, 1920))
        out = matscale.scale_y420p(src, plan)
        kind, size, sources = recorder[-1]
        assert (kind, size, len(sources)) == ("frame", rung, 1)
        planes, fmt, uni = sources[0]
        assert fmt == Y420P and all(p is s for p, s in zip(planes, src))
        assert np.array_equal(uni.view(np.uint32),
                              plan.uniform.view(np.uint32))
        assert [tuple(o.shape) for o in out] == [
            (rung[1], rung[0]), (rung[1] // 2, rung[0] // 2),
            (rung[1] // 2, rung[0] // 2)]
    assert len(recorder) == len(rungs) and matscale.calls == products


def test_card_batch_scale_makes_one_cell_call(recorder):
    n = 40
    ys = torch.empty((n, 108, 192), dtype=torch.uint8, device="meta")
    cs = torch.empty((n, 54, 96), dtype=torch.uint8, device="meta")
    plan = matscale.plan_scale(identity_uniforms((192, 108), (48, 36)),
                               (48, 36), (108, 192))
    products = matscale.calls
    oy, ou, ov = matscale.scale_y420p_batch(ys, cs, cs, plan)
    assert [r[:2] for r in recorder] == [("cells", (48, 36))]
    planes, fmt, unis = recorder[0][2]
    assert recorder[0][3] is None
    assert fmt == Y420P and matscale.calls == products
    assert all(p is q for p, q in zip(planes, (ys, cs, cs)))
    assert unis.shape == (n, 29) and (unis == plan.uniform).all()
    assert (tuple(oy.shape), tuple(ou.shape), tuple(ov.shape)) == (
        (n, 36, 48), (n, 18, 24), (n, 18, 24))


def test_cpu_routes_keep_the_products():
    """On the CPU the ladder and the wall's default cells stay the products
    (counted), and the plan keeps the packed uniform it was built from."""
    rng = np.random.default_rng(8)
    uni = identity_uniforms((64, 36), (32, 18))
    plan = matscale.plan_scale(uni, (32, 18), (36, 64))
    assert plan.uniform.dtype == np.float32
    assert np.array_equal(plan.uniform, np.asarray(uni.pack(), np.float32))
    planes = [torch.from_numpy(p[0]) for p in _y420p(rng, 64, 36, 1)]
    products, launches, calls = matscale.calls, frame.launches, composite.calls
    matscale.scale_y420p(planes, plan)
    wall = MixingWall(n_streams=4, stream_size=(64, 36), canvas_size=(64, 36),
                      audio_samples=8, device="cpu")
    wall.step(*(wall.shard(a) for a in _inputs(9, 4, (64, 36), 8)))
    assert (matscale.calls, frame.launches, composite.calls) == (
        products + 2, launches, calls)
