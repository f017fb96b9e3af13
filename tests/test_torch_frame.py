"""The frame kernels' launch path (swiftvideo_tpu_torch/ops/frame.py), on
the CPU.

* The packed kernel parameters (a 64-byte header, then ``CAPACITY``
  192-byte ``SrcDesc`` rows) against ``descriptors()``'s fields, byte for
  byte, and against the layout ``csrc/frame_composite.cu`` declares.
* The launch plan for stacks of 0, 1, ``CAPACITY`` and more sources, and
  the chaining it relies on: the plain version of a stack's tail folded onto
  the plain version of its head equals the whole stack bit for bit, and the
  whole stack equals the JAX package's ``golden.composite_stack`` within
  1 LSB (the port's contract; they agree bit for bit in practice).
* The cached border boxes against the per-corner loop they came from.
* The claim the kernels' axis-aligned path rests on: for an axis-aligned
  source, the row side of the maps is the same at every pixel of a row, in
  float32 with golden's operation order.

Inputs come from ``np.random.default_rng``; the JAX package's objects reach
the port through ``swiftvideo_tpu_torch.interop``.
"""

import re

import numpy as np
import pytest
import torch

from swiftvideo_tpu.media import PixelFormat as PF
from swiftvideo_tpu.ops import golden
from swiftvideo_tpu.ops import rect_uniforms as jax_rect_uniforms
from swiftvideo_tpu_torch import interop
from swiftvideo_tpu_torch.media import PixelFormat as PortPF
from swiftvideo_tpu_torch.ops import composite, frame, nvcc
from swiftvideo_tpu_torch.ops import uniforms as port_uniforms
from swiftvideo_tpu_torch.utils import matrix as m4

CPU = torch.device("cpu")
CAP = frame.CAPACITY
TOL = 1  # against golden; 0 between plain-version stacks


def _u8(rng, *shape):
    return rng.integers(0, 256, shape, np.int64).astype(np.uint8)


def _planes(rng, fmt, w, h):
    if fmt == PF.y420p:
        return [_u8(rng, h, w), _u8(rng, h // 2, w // 2), _u8(rng, h // 2, w // 2)]
    if fmt in (PF.nv12, PF.nv21):
        return [_u8(rng, h, w), _u8(rng, h // 2, w // 2, 2)]
    return [_u8(rng, h, w, 4)]


def _mixed_stack(rng, n, size=(96, 64)):
    """n sources cycling through y420p, nv12, a rotated BGRA logo and an RGBA
    overlay with fill and a wider border, at scattered quarter-pixel
    offsets (JAX package objects)."""
    cw, ch = size
    srcs = []
    for s in range(n):
        kind = s % 4
        fmt = (PF.y420p, PF.nv12, PF.BGRA, PF.RGBA)[kind]
        sw, sh = (48, 32) if kind < 2 else (24, 16)
        x = (s * 13) % (cw - 20) - 8.25
        y = (s * 7) % (ch - 12) - 4.5
        w, h = 30.0 + s % 7, 20.0 + s % 5
        extra = {}
        if kind == 2:
            extra = dict(rotation=0.3 + 0.05 * s)
        if kind == 3:
            extra = dict(fill_color=(0.2, 0.5, 0.7, 0.6),
                         border=(x - 3, y - 2, w + 6, h + 4))
        planes = _planes(rng, fmt, sw, sh)
        if fmt in (PF.RGBA, PF.BGRA):
            planes[0][..., 3] = np.linspace(0, 255, sw).astype(np.uint8)[None, :]
        srcs.append((planes, fmt, jax_rect_uniforms(
            (sw, sh), size, x=x, y=y, w=w, h=h, opacity=0.55 + 0.01 * s,
            **extra)))
    return srcs


def _port(srcs):
    return interop.to_port_sources(srcs, CPU)


# --- packed parameters -----------------------------------------------------

def test_param_layout_matches_kernel_source():
    text = (nvcc.CSRC / "frame_composite.cu").read_text()
    assert int(re.search(r"constexpr int kCapacity = (\d+);", text).group(1)) == CAP
    assert "sizeof(FrameParams) == 64 + kCapacity * 192" in text
    assert "sizeof(SrcDesc) == 192" in text
    assert frame._PARAMS.itemsize == 64 + CAP * 192


@pytest.mark.parametrize("out_fmt", [PortPF.y420p, PortPF.nv12, PortPF.BGRA],
                         ids=lambda f: f.value)
@pytest.mark.parametrize("chained", [False, True])
def test_packed_params_match_descriptors(out_fmt, chained):
    rng = np.random.default_rng(21)
    size = (96, 64)
    srcs = _port(_mixed_stack(rng, 5, size))
    outs = composite.clear_planes(out_fmt, size, CPU)
    rows = frame.descriptors(size, srcs)
    raw = frame.pack_params(size, out_fmt, outs, rows, chained).tobytes()
    assert len(raw) == 64 + CAP * 192
    # header: out[3] (u64), n, h, w, out_fmt, chained, pad[5] (i32)
    out_ptrs = np.frombuffer(raw, "<u8", 3, 0)
    assert list(out_ptrs) == [t.data_ptr() for t in outs] + [0] * (3 - len(outs))
    n, h, w, fmt_code, ch = np.frombuffer(raw, "<i4", 5, 24)
    assert (n, h, w, ch) == (5, 64, 96, int(chained))
    assert fmt_code == frame._OUT_CODES[out_fmt]
    assert not any(np.frombuffer(raw, "<i4", 5, 44))
    # rows: SrcDesc at 64 + 192 i, field by field
    for i, (planes, fmt, uni) in enumerate(srcs):
        at = 64 + 192 * i
        ptrs = np.frombuffer(raw, "<u8", 3, at)
        assert list(ptrs) == list(rows["plane"][i])
        assert list(ptrs[:len(planes)]) == [t.data_ptr() for t in planes]
        assert np.frombuffer(raw, "<i4", 1, at + 24)[0] == rows["fmt"][i] \
            == frame._SRC_CODES[fmt]
        assert list(np.frombuffer(raw, "<i4", 4, at + 28)) == list(rows["dims"][i])
        box = np.frombuffer(raw, "<i4", 8, at + 44).reshape(2, 4)
        assert np.array_equal(box, rows["box"][i])
        u = np.frombuffer(raw, "<f4", 29, at + 76)
        assert np.array_equal(u.view(np.uint32), rows["u"][i].view(np.uint32))
        assert np.array_equal(u, np.asarray(uni, np.float32))
    assert not any(raw[64 + 192 * len(srcs):])


def test_pack_params_refuses_more_than_capacity():
    rows = np.zeros(CAP + 1, frame._DESC)
    with pytest.raises(ValueError, match="at most"):
        frame.pack_params((64, 32), PortPF.y420p, [], rows, False)


# --- launch plan and chaining ----------------------------------------------

@pytest.mark.parametrize("n", [0, 1, CAP, CAP + 3, 2 * CAP + 1])
def test_launch_plan(n):
    plan = frame.launch_plan(n)
    assert len(plan) == max(1, -(-n // CAP))
    assert plan[0][0] == 0 and plan[-1][1] == n
    for (a, b), (c, _d) in zip(plan, plan[1:]):
        assert b == c
    assert all(0 <= b - a <= CAP for a, b in plan)


@pytest.mark.parametrize("out_fmt", [PF.y420p, PF.nv12, PF.nv21, PF.RGBA,
                                     PF.BGRA], ids=lambda f: f.value)
def test_chained_split_equals_whole_stack(out_fmt):
    """A stack of CAPACITY + 3 mixed sources, folded launch by launch as the
    wrapper plans it, equals the whole stack; the whole stack equals golden."""
    size = (96, 64)
    jax_srcs = _mixed_stack(np.random.default_rng(22), CAP + 3, size)
    srcs = _port(jax_srcs)
    fmt = interop.pixel_format(out_fmt)
    whole = composite.composite_stack_torch(fmt, size, srcs, CPU)
    planes = None
    plan = frame.launch_plan(len(srcs))
    assert len(plan) == 2
    for a, b in plan:
        planes = composite.composite_stack_torch(fmt, size, srcs[a:b], CPU,
                                                 target=planes)
    for got, ref in zip(planes, whole):
        assert torch.equal(got, ref)
    ref = golden.composite_stack(out_fmt, size, jax_srcs)
    for got, want in zip(whole, ref):
        err = np.abs(got.numpy().astype(int) - np.asarray(want).astype(int))
        assert err.max() <= TOL
    # the scene is on screen
    assert int(whole[0].float().std()) > 5


def test_wrapper_long_stack_on_cpu_takes_plain_version():
    size = (96, 64)
    srcs = _port(_mixed_stack(np.random.default_rng(23), CAP + 3, size))
    launches, calls = frame.launches, composite.calls
    got = frame.composite_frame_cuda(size, srcs, PortPF.nv21)
    assert (frame.launches, composite.calls) == (launches, calls + 1)
    ref = composite.composite_stack_torch(PortPF.nv21, size, srcs, CPU)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))


# --- border boxes -----------------------------------------------------------

def _border_box_loop(p, gh, gw):
    """The per-source, per-grid, per-corner float64 loop the boxes came
    from."""
    a, b, c, d, tx, ty = np.asarray(p[12:18], np.float64)
    det = a * d - b * c
    if not np.isfinite(det) or abs(det) < 1e-30:
        return (0, gh, 0, gw)
    xs, ys = [], []
    for bx, by in ((0.0, 0.0), (1.0, 0.0), (0.0, 1.0), (1.0, 1.0)):
        nx = (d * (bx - tx) - b * (by - ty)) / det
        ny = (-c * (bx - tx) + a * (by - ty)) / det
        xs.append((nx + 1.0) / 2.0 * gw)
        ys.append((ny + 1.0) / 2.0 * gh)

    def span(lo, hi, n):
        return (int(max(0.0, min(float(n), np.floor(lo) - 2.0))),
                int(max(0.0, min(float(n), np.ceil(hi) + 3.0))))

    return span(min(ys), max(ys), gh) + span(min(xs), max(xs), gw)


@pytest.mark.parametrize("seed", range(3))
def test_border_boxes_equal_per_corner_loop(seed):
    rng = np.random.default_rng(40 + seed)
    unis = []
    for _ in range(12):
        x, y = rng.uniform(-80, 320), rng.uniform(-60, 180)
        unis.append(port_uniforms.rect_uniforms(
            (64, 32), (320, 180), x=x, y=y, w=rng.uniform(1, 300),
            h=rng.uniform(1, 200), rotation=rng.uniform(-3.2, 3.2),
            border=(x - 5, y - 3, rng.uniform(10, 320), rng.uniform(10, 180))
        ).pack())
    flat = np.zeros(29, np.float32)  # a degenerate border map: the whole grid
    u = np.stack(unis + [flat])
    boxes = frame.border_boxes(u, (320, 180))
    assert boxes.dtype == np.int32 and boxes.shape == (len(u), 2, 4)
    for g, (gh, gw) in enumerate(((180, 320), (90, 160))):
        for row, p in zip(boxes[:, g], u):
            assert tuple(row) == _border_box_loop(p, gh, gw)
    assert boxes[-1].tolist() == [[0, 180, 0, 320], [0, 90, 0, 160]]


# --- the separable map path -------------------------------------------------

def _ndc(n):
    """golden._grid_ndc in float32: i / n * 2 - 1."""
    return ((np.arange(n, dtype=np.float32) / np.float32(n)) * np.float32(2)
            - np.float32(1))


@pytest.mark.parametrize("seed", range(4))
def test_axis_aligned_row_side_is_the_same_along_a_row(seed):
    """The claim the kernels' axis-aligned path rests on: where u[1], u[2],
    u[7], u[8], u[13] and u[14] are exact zeros, the row side of every map
    (border y, element y, texture y, and u[7] times element y) comes out at
    every pixel of a row as it does at the row's first pixel, in float32
    with golden's operation order (up to the sign of a zero)."""
    rng = np.random.default_rng(60 + seed)
    gw, gh = 320, 180
    sw, sh = int(rng.integers(16, 1300)), int(rng.integers(16, 740))
    texture = (m4.translation(rng.uniform(-0.2, 0.2), rng.uniform(-0.2, 0.2))
               @ m4.scale(rng.uniform(0.5, 1.5), rng.uniform(0.5, 1.5)))
    x, y = rng.uniform(-50, 200), rng.uniform(-30, 120)
    w, h = rng.uniform(20, 300), rng.uniform(10, 170)
    u = port_uniforms.rect_uniforms(
        (sw, sh), (gw, gh), x=x, y=y, w=w, h=h, texture_matrix=texture,
        border=(x - 3.5, y - 2.25, w + 7, h + 4.5)).pack()
    assert u[1] == u[2] == u[7] == u[8] == u[13] == u[14] == 0.0
    assert np.all(np.abs(u[:18]) < 1e6)  # the kernel's finiteness test
    px, py = _ndc(gw)[None, :], _ndc(gh)[:, None]
    # per pixel, as golden and the kernel's per-pixel path compute them
    bd_y = u[14] * px + u[15] * py + u[17]
    tx_x = u[0] * px + u[1] * py + u[4]
    tx_y = u[2] * px + u[3] * py + u[5]
    uv_x = u[6] * tx_x + u[7] * tx_y + u[10]
    uv_y = u[8] * tx_x + u[9] * tx_y + u[11]
    assert bd_y.dtype == uv_y.dtype == np.float32
    # once per run, at the run's first pixel (frame_composite.cu run_rows)
    for x0 in range(0, gw, 4):
        run = slice(x0, x0 + 4)
        for full in (bd_y, tx_y, uv_y):
            assert np.array_equal(full[:, run],
                                  np.broadcast_to(full[:, x0:x0 + 1],
                                                  full[:, run].shape))
        u7ty = u[7] * tx_y[:, x0:x0 + 1]
        assert np.array_equal(uv_x[:, run], u[6] * tx_x[:, run] + u7ty + u[10])
    # the source is on the grid, so the claim was tested on live values
    assert ((bd_y >= 0) & (bd_y <= 1)).any() and ((uv_y >= 0) & (uv_y <= 1)).any()


def test_live_station_sources_are_axis_aligned():
    """The main path's cameras and lower third have exact zeros where the
    kernel tests for rotation, so it takes the row side once per run."""
    for x, y, w, h, src in [(0, 0, 960, 540, (1920, 1080)),
                            (960, 540, 960, 540, (1920, 1080)),
                            (0, 824, 1920, 216, (1920, 216))]:
        u = port_uniforms.rect_uniforms(src, (1920, 1080), x=x, y=y, w=w,
                                        h=h, opacity=0.9).pack()
        assert u[1] == u[2] == u[7] == u[8] == u[13] == u[14] == 0.0
        model = m4.ortho(1920, 1080) @ m4.translation(x, y, 1) @ m4.scale(w, h)
        inv = m4.inverse(model)
        assert inv[0, 1] == inv[1, 0] == 0.0
