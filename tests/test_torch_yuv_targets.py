"""Composites onto 4:2:2 and 4:4:4 targets (y422p, y444p, and the packed
yuvs / zvuy, which fold as y422p), on the CPU.

* The port's fold against the JAX package's ``composite_stack_device`` and
  ``golden.composite_stack`` on the same inputs from
  ``np.random.default_rng``, at 64x32 and at 642x362 (a 321-byte 4:2:2
  chroma row).  Tolerance: 1 LSB, the contract of the other targets.
* The frame kernel's launch data for these targets: each target's chroma
  grid in the ``FrameParams`` header, and the border boxes on that grid.
  Every pixel a source changes on a cleared target lies inside its box,
  on each of the three planar grids; the box cache tells a y420p and a
  y422p target of one size apart.
* The route on a ``cuda`` context, with the kernel's wrapper replaced by a
  recorder: every yuv target reaches it (packed ones as y422p, packed
  again afterwards), the plain version is never called, and a target the
  kernel does not write raises.
"""

import numpy as np
import pytest
import torch

from swiftvideo_tpu.media import PixelFormat as PF
from swiftvideo_tpu.ops import composite as jax_composite
from swiftvideo_tpu.ops import golden, rect_uniforms
from swiftvideo_tpu_torch import interop
from swiftvideo_tpu_torch.media import PixelFormat as PortPF
from swiftvideo_tpu_torch.media.pixel import (packed422_to_planar,
                                              plane_array_shape)
from swiftvideo_tpu_torch.ops import composite, frame, registry
from swiftvideo_tpu_torch.ops import uniforms as port_uniforms

TOL = 1
CPU = torch.device("cpu")
TARGETS = [PF.y422p, PF.y444p, PF.yuvs, PF.zvuy]
PLANAR = [PortPF.y420p, PortPF.y422p, PortPF.y444p]
SIZES = [(64, 32), (642, 362)]
# the plain version, for the expected results of the route tests (which
# replace it with a function that raises)
PLAIN = composite.composite_stack_torch


def _size_id(size):
    return "x".join(map(str, size))


def _u8(rng, *shape):
    return rng.integers(0, 256, shape, np.int64).astype(np.uint8)


def _sources(rng, size):
    """A y420p camera, a y422p camera with fill and a wider border, a
    rotated nv21 picture, a zvuy camera and an RGBA lower third with an
    alpha ramp, at quarter-pixel offsets (JAX package objects)."""
    w, h = size
    sw, sh = 32, 16
    rgba = _u8(rng, sh, 2 * sw, 4)
    rgba[..., 3] = np.linspace(0, 255, 2 * sw).astype(np.uint8)[None, :]
    return [
        ([_u8(rng, sh, sw), _u8(rng, sh // 2, sw // 2),
          _u8(rng, sh // 2, sw // 2)], PF.y420p,
         rect_uniforms((sw, sh), size, x=-3.25, y=1.5, w=w * 0.6,
                       h=h * 0.55, opacity=0.9)),
        ([_u8(rng, sh, sw), _u8(rng, sh, sw // 2), _u8(rng, sh, sw // 2)],
         PF.y422p, rect_uniforms(
             (sw, sh), size, x=w * 0.45 + 0.25, y=h * 0.3 + 0.5, w=w * 0.5,
             h=h * 0.6, opacity=0.8, fill_color=(0.2, 0.6, 0.3, 0.7),
             border=(w * 0.45 - 3, h * 0.3 - 2, w * 0.5 + 6, h * 0.6 + 4))),
        ([_u8(rng, sh, sw), _u8(rng, sh // 2, sw // 2, 2)], PF.nv21,
         rect_uniforms((sw, sh), size, x=w * 0.2, y=h * 0.25, w=w * 0.35,
                       h=h * 0.4, rotation=0.4, opacity=0.7)),
        ([_u8(rng, sh, sw, 2)], PF.zvuy,
         rect_uniforms((sw, sh), size, x=w * 0.1 + 0.75, y=h * 0.6 + 0.25,
                       w=w * 0.3, h=h * 0.35, opacity=0.85)),
        ([rgba], PF.RGBA, rect_uniforms((2 * sw, sh), size, x=0.25,
                                        y=h * 0.8, w=w, h=h * 0.15)),
    ]


def _err(ours, theirs):
    assert len(ours) == len(theirs)
    errs = []
    for o, t in zip(ours, theirs):
        t = np.asarray(t)
        assert tuple(o.shape) == t.shape and o.dtype == torch.uint8
        errs.append(int(np.abs(o.numpy().astype(int) - t.astype(int)).max()))
    return max(errs)


@pytest.mark.parametrize("size", SIZES, ids=_size_id)
@pytest.mark.parametrize("out_fmt", TARGETS, ids=lambda f: f.value)
def test_fold_matches_jax_device_fold(out_fmt, size):
    """The port's fold (the plain version, the frame wrapper on CPU
    tensors, the registry on a cpu context) against the JAX device fold and
    golden, within 1 LSB; the three port routes agree bit for bit."""
    sources = _sources(np.random.default_rng(70 + size[0]), size)
    port_sources = interop.to_port_sources(sources, CPU)
    fmt = interop.pixel_format(out_fmt)
    ours = composite.composite_stack_torch(fmt, size, port_sources, CPU)
    assert [tuple(p.shape) for p in ours] == [
        plane_array_shape(fmt, size, i) for i in range(len(ours))]
    assert _err(ours, jax_composite.composite_stack_device(
        out_fmt, size, sources)) <= TOL
    assert _err(ours, golden.composite_stack(out_fmt, size, sources)) <= TOL
    routes = [registry.composite_frame(registry.make_compute_context("cpu"),
                                       fmt, size, port_sources)]
    if fmt in frame.KERNEL_TARGETS:
        routes.append(frame.composite_frame_cuda(
            size, composite.unpack_sources(port_sources), fmt))
    for got in routes:
        assert all(torch.equal(g, o) for g, o in zip(got, ours))
    # the scene is on screen, chroma included
    assert int(ours[0].float().std()) > 5
    if fmt in (PortPF.y422p, PortPF.y444p):
        assert int(ours[1].float().std()) > 5


# --- the launch data --------------------------------------------------------

@pytest.mark.parametrize("size", [(96, 64), (642, 362)], ids=_size_id)
def test_pack_params_carries_each_chroma_grid(size):
    rows = frame.descriptors(size, [], PortPF.y420p)
    w, h = size
    grids = {PortPF.y420p: (h // 2, w // 2), PortPF.y422p: (h, w // 2),
             PortPF.y444p: (h, w), PortPF.nv12: (h // 2, w // 2),
             PortPF.nv21: (h // 2, w // 2), PortPF.RGBA: (0, 0),
             PortPF.BGRA: (0, 0)}
    assert set(grids) == set(frame.KERNEL_TARGETS)
    for fmt, grid in grids.items():
        params = frame.pack_params(size, fmt, [], rows, False)
        assert params.nbytes == frame._PARAMS.itemsize == 6208
        head = params["head"]
        assert (int(head["ch"]), int(head["cw"])) == grid
        assert frame.chroma_grid(fmt, size) == grid
        assert (int(head["h"]), int(head["w"])) == (h, w)
        assert not head["pad"].any()
        assert int(head["out_fmt"]) == frame._OUT_CODES[fmt]
    assert {frame._OUT_CODES[f] for f in PLANAR} == {0}


def _rotated_source(rng, size):
    w, h = size
    # the rect turns about (x, y), which stays on screen
    x, y = rng.uniform(0.3 * w, 0.7 * w), rng.uniform(0.3 * h, 0.7 * h)
    uni = port_uniforms.rect_uniforms(
        (32, 16), size, x=x, y=y, w=rng.uniform(0.2 * w, w),
        h=rng.uniform(0.2 * h, h), rotation=rng.uniform(-3.2, 3.2),
        opacity=0.9, fill_color=(0.8, 0.1, 0.6, 0.9),
        border=(x - 5, y - 3, rng.uniform(0.3 * w, w),
                rng.uniform(0.3 * h, h)))
    planes = [torch.from_numpy(_u8(rng, 16, 32)),
              torch.from_numpy(_u8(rng, 8, 16)),
              torch.from_numpy(_u8(rng, 8, 16))]
    return planes, PortPF.y420p, uni


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("size", SIZES, ids=_size_id)
@pytest.mark.parametrize("out_fmt", PLANAR, ids=lambda f: f.value)
def test_border_boxes_cover_every_changed_pixel(out_fmt, size, seed):
    """Every pixel one source changes on a cleared target lies inside that
    source's box, on the luma grid and on the target's chroma grid: the
    kernel skips a source outside its box, so a box on the wrong grid would
    leave pixels as it found them."""
    src = _rotated_source(np.random.default_rng(90 + seed), size)
    out = composite.composite_stack_torch(out_fmt, size, [src], CPU)
    clear = composite.clear_planes(out_fmt, size, CPU)
    boxes = frame.descriptors(size, [src], out_fmt)["box"][0]
    changed = 0
    for plane, (got, base) in enumerate(zip(out, clear)):
        ys, xs = np.nonzero((got != base).numpy())
        y0, y1, x0, x1 = boxes[0 if plane == 0 else 1]
        assert (got.shape[0], got.shape[1]) == (
            (size[1], size[0]) if plane == 0
            else frame.chroma_grid(out_fmt, size))
        assert not ((ys < y0) | (ys >= y1) | (xs < x0) | (xs >= x1)).any()
        changed += len(ys)
    assert changed > 0


def test_box_cache_tells_chroma_grids_apart():
    """One border map on a y420p, then a y422p, then a y444p target of one
    size: the chroma boxes differ, each on its own grid (the cache is keyed
    by the grid, not by the size alone)."""
    size = (642, 362)
    uni = port_uniforms.rect_uniforms((32, 16), size, x=100.25, y=200.5,
                                      w=300, h=140).pack()[None]
    b420, b422, b444 = (frame.border_boxes(uni, size, f) for f in PLANAR)
    luma = b420[0, 0]
    assert np.array_equal(b422[0, 0], luma) and np.array_equal(b444[0, 0], luma)
    assert not np.array_equal(b420[0, 1], b422[0, 1])
    assert not np.array_equal(b422[0, 1], b444[0, 1])
    # 4:2:2 chroma keeps the luma rows and halves the columns; 4:4:4 is luma
    assert np.array_equal(b422[0, 1, :2], luma[:2])
    assert np.array_equal(b420[0, 1, 2:], b422[0, 1, 2:])
    assert np.array_equal(b444[0, 1], luma)
    assert b420[0, 1, 1] <= size[1] // 2 < b422[0, 1, 1]


# --- the route on the card --------------------------------------------------

@pytest.fixture
def recorder(monkeypatch):
    """``frame.composite_frame_cuda`` replaced by a stand-in for the kernel
    that records each call and folds with ``composite.apply_composite``
    (no plain-version call); the plain version itself raises."""
    seen = []

    def kernel(size, sources, out_fmt=PortPF.y420p, *, device=None,
               target=None):
        seen.append((out_fmt, [fmt for _p, fmt, _u in sources], device,
                     None if target is None else
                     [tuple(t.shape) for t in target]))
        if out_fmt not in frame.KERNEL_TARGETS:
            raise ValueError(f"frame kernel writes no {out_fmt} target")
        planes = (list(target) if target is not None
                  else composite.clear_planes(out_fmt, size, CPU))
        for planes_s, fmt, uni in sources:
            planes = composite.apply_composite(planes, out_fmt, planes_s, fmt,
                                               uni)
        return planes

    def plain(*args, **kwargs):
        raise AssertionError("the plain version ran on a cuda context")

    monkeypatch.setattr(frame, "composite_frame_cuda", kernel)
    monkeypatch.setattr(composite, "composite_stack_torch", plain)
    return seen


def _cuda_context():
    return registry.ComputeContext(device=torch.device("cuda", 0))


@pytest.fixture
def case():
    size = (64, 32)
    rng = np.random.default_rng(12)
    sources = interop.to_port_sources(_sources(rng, size), CPU)
    base = torch.from_numpy(_u8(rng, size[1], size[0], 2))
    want = {fmt: PLAIN(fmt, size, sources, CPU)
            for fmt in (PortPF.y422p, PortPF.y444p, PortPF.yuvs,
                        PortPF.zvuy)}
    on_base = {fmt: PLAIN(fmt, size, sources, CPU, target=[base])
               for fmt in (PortPF.yuvs, PortPF.zvuy)}
    return size, sources, base, want, on_base


@pytest.mark.parametrize("out_fmt", [PortPF.y422p, PortPF.y444p],
                         ids=lambda f: f.value)
def test_cuda_route_planar_targets_reach_the_kernel(recorder, case, out_fmt):
    size, sources, _base, want, _on_base = case
    calls = composite.calls
    got = registry.composite_frame(_cuda_context(), out_fmt, size, sources)
    assert len(recorder) == 1
    fmt, src_fmts, device, target = recorder[0]
    assert (fmt, device, target) == (out_fmt, torch.device("cuda", 0), None)
    # the packed camera arrives unpacked
    assert PortPF.zvuy not in src_fmts and PortPF.y422p in src_fmts
    assert all(torch.equal(g, w) for g, w in zip(got, want[out_fmt]))
    assert composite.calls == calls


@pytest.mark.parametrize("out_fmt", [PortPF.yuvs, PortPF.zvuy],
                         ids=lambda f: f.value)
def test_cuda_route_packed_targets_fold_as_y422p(recorder, case, out_fmt):
    size, sources, base, want, on_base = case
    calls = composite.calls
    ctx = _cuda_context()
    got = registry.composite_frame(ctx, out_fmt, size, sources)
    chained = registry.composite_frame(ctx, out_fmt, size, sources,
                                       target=[base])
    w, h = size
    assert [r[0] for r in recorder] == [PortPF.y422p, PortPF.y422p]
    assert recorder[0][3] is None
    # a given packed target is unpacked before the kernel reads it
    assert recorder[1][3] == [(h, w), (h, w // 2), (h, w // 2)]
    for ours, theirs in ((got, want[out_fmt]), (chained, on_base[out_fmt])):
        assert len(ours) == 1 and tuple(ours[0].shape) == (h, w, 2)
        assert torch.equal(ours[0], theirs[0])
    # the target's own pixels outside every source survive the round trip
    assert torch.equal(
        packed422_to_planar(chained[0], out_fmt, torch)[0][0, -1],
        packed422_to_planar(base, out_fmt, torch)[0][0, -1])
    assert composite.calls == calls


def test_cuda_route_refuses_other_targets(recorder, case):
    size, sources, _base, _want, _on_base = case
    calls = composite.calls
    with pytest.raises(ValueError, match="writes no"):
        registry.composite_frame(_cuda_context(), PortPF.shape, size, sources)
    assert composite.calls == calls
