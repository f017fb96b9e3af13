"""The frame kernel's cell launch (``ops/frame.py::composite_cells_cuda``)
and the routes that take it on the card, on the CPU.

* The launch data: the cell grid in the ``FrameParams`` header (still a
  64-byte header, 6208 bytes in all), and each source's boxes: its boxes on
  a cell-sized target shifted down to its own cell and clipped to it, on
  the luma and the chroma grid, at the wall's 240x136 tile and at a 34x18
  tile whose chroma cell (17x9) is odd both ways; every pixel a source
  changes lies inside its box; the box cache tells cell sizes apart.
* The plain version of the cell launch: bit for bit the per-cell fold (one
  frame composite per cell, stacked), and within 1 LSB of the JAX
  package's ``MixingWall`` on the 8-device CPU mesh of tests/conftest.py.
* The routes on the card, with the cell launch and the frame launch
  replaced by a recorder that folds with ``composite.apply_composite`` and
  the plain version replaced by a raiser: on a ``cuda`` wall both video
  paths make one cell call a tick (ceil(n / 32) launches) for 16, 60 and 64
  streams, no product call and no plain call, and give the CPU wall's
  per-cell pixels bit for bit; ``scale_y420p`` makes one frame-kernel call
  a rung and ``scale_y420p_batch`` one cell call.  The ladder's route is
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
from swiftvideo_tpu_torch.media import PixelFormat as PortPF
from swiftvideo_tpu_torch.ops import composite, frame, matscale
from swiftvideo_tpu_torch.ops.uniforms import identity_uniforms, rect_uniforms
from swiftvideo_tpu_torch.parallel import MixingWall

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
    # cell_w, pad (i32)
    n_at, h, w, fmt_code, chained = np.frombuffer(raw, "<i4", 5, 24)
    assert (n_at, h, w, fmt_code, chained) == (n, n * 136, 240, 0, 0)
    assert tuple(np.frombuffer(raw, "<i4", 2, 44)) == (n * 68, 120)
    assert tuple(np.frombuffer(raw, "<i4", 3, 52)) == (136, 240, 0)
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
    # no cell grid: both words stay 0, as every other launch packs them
    plain = frame.pack_params(size, Y420P, outs, rows, False).tobytes()
    assert not any(np.frombuffer(plain, "<i4", 3, 52))
    assert raw[:52] == plain[:52] and raw[64:] == plain[64:]
    text = frame.SOURCE.read_text()
    assert "int cell_h, cell_w;" in text and "int pad;" in text


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
    with pytest.raises(ValueError, match="y420p"):
        frame.composite_cells_cuda(cell, planes, Y420P, unis, out_fmt)


@pytest.mark.parametrize("cell,size", [((34, 18), (34, 27)),
                                       ((33, 18), (33, 36)),
                                       ((34, 18), (51, 36)),
                                       ((34, 18), (68, 36))],
                         ids=["rows do not divide", "odd cell",
                              "columns do not divide", "two columns"])
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


def test_cell_launch_refuses_bad_batches():
    planes, unis = _batch(np.random.default_rng(6), 2, (32, 16), (34, 18))
    ys, us, vs = planes
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
    version call); the plain version raises.  Returns the list of calls:
    ("cells", cell size, (planes, fmt, uniforms)) or ("frame", size,
    sources)."""
    seen = []

    def cells(cell_size, planes, fmt, uniforms, out_fmt=Y420P):
        seen.append(("cells", tuple(cell_size), (list(planes), fmt,
                                                 np.asarray(uniforms))))
        w, h = cell_size
        n = planes[0].shape[0]
        if planes[0].device.type == "meta":
            return [torch.empty(s, dtype=torch.uint8, device="meta")
                    for s in ((n * h, w), (n * h // 2, w // 2),
                              (n * h // 2, w // 2))]
        folds = []
        for i in range(n):
            out = composite.clear_planes(Y420P, cell_size, CPU)
            folds.append(composite.apply_composite(
                out, Y420P, [p[i] for p in planes], fmt, uniforms[i]))
        return [torch.cat(p) for p in zip(*folds)]

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


@pytest.mark.parametrize("wall_case", WALLS, ids=lambda c: c[0])
@pytest.mark.parametrize("per_cell", [False, True],
                         ids=["default cells", "per-cell uniforms"])
def test_card_wall_makes_one_cell_call_a_tick(recorder, card_wall, wall_case,
                                              per_cell):
    _name, n, stream, canvas = wall_case
    wall = card_wall(n, stream, canvas)
    assert wall.device == torch.device("cuda", 0) and wall._plan is not None
    inputs = _inputs(20 + n, n, stream, 8)
    unis = (_cell_uniforms(n, stream, wall.tile, np.random.default_rng(n))
            if per_cell else None)
    products, calls = matscale.calls, composite.calls
    ys, us, vs, audio, gains = (torch.from_numpy(a) for a in inputs)
    out = wall.step(ys, us, vs, audio, gains, uniforms=unis)
    assert (matscale.calls, composite.calls) == (products, calls)
    assert len(recorder) == 1
    kind, cell, (planes, fmt, got_unis) = recorder[0]
    assert (kind, cell, fmt, len(got_unis)) == ("cells", wall.tile, Y420P, n)
    assert len(frame.launch_plan(n)) == math.ceil(n / CAP)
    want_unis = wall.default_uniforms() if unis is None else unis
    assert np.array_equal(got_unis, want_unis)
    assert all(torch.equal(p, a) for p, a in zip(planes, (ys, us, vs)))
    want = _cpu_wall_per_cell(n, stream, canvas, inputs, want_unis)
    assert all(torch.equal(g, w) for g, w in zip(out[:3], want))


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
