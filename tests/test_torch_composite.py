"""The port's composite against the JAX package, on the CPU.

The plain torch version (swiftvideo_tpu_torch/ops/composite.py) against
``golden.composite_stack``, and the frame wrapper (ops/frame.py, which
takes the plain version for CPU tensors) against the Pallas frame kernel in
interpret mode.  Inputs come from ``np.random.default_rng`` and are built
as the JAX package's objects; they reach the port through
``swiftvideo_tpu_torch.interop``, since the two packages' pixel formats and
samples are distinct types.  Tolerance: at most 1 LSB max abs error per
plane.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swiftvideo_tpu.media import PixelFormat, create_picture_sample
from swiftvideo_tpu.ops import golden
from swiftvideo_tpu.ops import make_compute_context as jax_context
from swiftvideo_tpu.ops import rect_uniforms as jax_rect_uniforms
from swiftvideo_tpu.ops import registry as jax_registry
from swiftvideo_tpu.ops.pallas_frame import composite_frame_pallas
from swiftvideo_tpu.utils import matrix as m4
from swiftvideo_tpu_torch import interop
from swiftvideo_tpu_torch.media import PixelFormat as PortPF
from swiftvideo_tpu_torch.ops import composite, frame, registry
from swiftvideo_tpu_torch.ops import uniforms as port_uniforms

W, H = 320, 180
OV_H = 40
TOL = 1
CPU = torch.device("cpu")
PF = PixelFormat


def _planes(rng, fmt, w, h):
    def u8(*shape):
        return rng.integers(0, 256, shape, np.int64).astype(np.uint8)
    if fmt == PF.y420p:
        return [u8(h, w), u8(h // 2, w // 2), u8(h // 2, w // 2)]
    if fmt in (PF.nv12, PF.nv21):
        return [u8(h, w), u8(h // 2, w // 2, 2)]
    return [u8(h, w, 4)]


def _overlay(rng, fmt=PF.RGBA, y=H - OV_H - 6.0):
    rgba = _planes(rng, fmt, W, OV_H)
    rgba[0][..., 3] = np.linspace(0, 255, W).astype(np.uint8)[None, :]
    return (rgba, fmt, jax_rect_uniforms((W, OV_H), (W, H), x=0.25, y=y,
                                         w=W, h=OV_H))


def _quadrants(rng, fmt):
    """Four full-size sources scaled 2:1 into the quadrants (the live
    station's shape), one with a fill and a wider border."""
    srcs = []
    for s in range(4):
        extra = {}
        if s == 1:
            extra = dict(fill_color=(0.1, 0.6, 0.3, 0.7),
                         border=(W / 2 - 4, -3, W / 2 + 8, H / 2 + 6))
        srcs.append((_planes(rng, fmt, W, H), fmt, jax_rect_uniforms(
            (W, H), (W, H), x=(s % 2) * W / 2, y=(s // 2) * H / 2, w=W / 2,
            h=H / 2, opacity=0.9, **extra)))
    return srcs


def _odd_geometry(rng):
    """A rotated y420p source with border and fill, a fractional
    vertical-scale nv12 source and a rotated BGRA overlay."""
    return [
        (_planes(rng, PF.y420p, W, H), PF.y420p, jax_rect_uniforms(
            (W, H), (W, H), x=60, y=30, w=150, h=90, rotation=0.35,
            opacity=0.8, fill_color=(0.9, 0.2, 0.1, 0.6),
            border=(54, 24, 162, 102))),
        (_planes(rng, PF.nv12, W, 120), PF.nv12, jax_rect_uniforms(
            (W, 120), (W, H), x=100.5, y=20.25, w=200, h=137.5,
            opacity=0.7)),
        (_planes(rng, PF.BGRA, 96, 48), PF.BGRA, jax_rect_uniforms(
            (96, 48), (W, H), x=180, y=100, w=110, h=60, rotation=-0.5,
            fill_color=(0.2, 0.2, 0.9, 0.5), border=(176, 96, 118, 68))),
    ]


def _check(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        g = np.asarray(g)
        assert g.shape == r.shape and g.dtype == np.uint8
        err = np.abs(g.astype(int) - np.asarray(r).astype(int)).max()
        assert err <= TOL, err


def _plain(out_fmt, srcs):
    return composite.composite_stack_torch(
        interop.pixel_format(out_fmt), (W, H),
        interop.to_port_sources(srcs, CPU), CPU)


def _golden(out_fmt, srcs):
    return golden.composite_stack(out_fmt, (W, H), srcs)


def _fmt_id(fmt):
    return fmt.value


@pytest.mark.parametrize("src_fmt", [PF.y420p, PF.nv12, PF.nv21, PF.RGBA,
                                     PF.BGRA], ids=_fmt_id)
@pytest.mark.parametrize("out_fmt", [PF.y420p, PF.nv12, PF.nv21, PF.RGBA],
                         ids=_fmt_id)
def test_plain_matches_golden(out_fmt, src_fmt):
    rng = np.random.default_rng(100 + list(PF).index(src_fmt))
    srcs = _quadrants(rng, src_fmt) + [_overlay(rng)]
    _check(_plain(out_fmt, srcs), _golden(out_fmt, srcs))


@pytest.mark.parametrize("out_fmt", [PF.y420p, PF.nv12, PF.nv21, PF.RGBA,
                                     PF.BGRA], ids=_fmt_id)
def test_plain_rotated_and_fractional_scale(out_fmt):
    srcs = _odd_geometry(np.random.default_rng(7))
    _check(_plain(out_fmt, srcs), _golden(out_fmt, srcs))


def test_plain_exact_integer_seams():
    """Element edges on exact pixel rows and columns: the plain version
    does golden's float32 operations in golden's order, so seam pixels
    land on the same side (bit-exact, not only within 1 LSB)."""
    rng = np.random.default_rng(8)
    srcs = _quadrants(rng, PF.y420p) + [_overlay(rng, y=130.0)]
    for got, ref in zip(_plain(PF.nv12, srcs), _golden(PF.nv12, srcs)):
        assert np.array_equal(got.numpy(), ref)


# Stacks composite_frame_pallas accepts (y420p and RGBA/BGRA sources);
# overlays sit at quarter-pixel offsets, where the TPU kernel's seam
# arithmetic agrees with golden.
_PALLAS_CASES = {
    "quadrants-y420p": (PF.y420p, lambda r: _quadrants(r, PF.y420p)),
    "quadrants+rgba-nv12": (PF.nv12, lambda r: _quadrants(r, PF.y420p)
                            + [_overlay(r, y=130.25)]),
    "bgra-nv21": (PF.nv21, lambda r: [_overlay(r, PF.BGRA, y=60.25)]),
}


@pytest.mark.parametrize("case", sorted(_PALLAS_CASES))
def test_frame_wrapper_matches_pallas_interpret(case):
    out_fmt, make = _PALLAS_CASES[case]
    srcs = make(np.random.default_rng(11))
    jax_srcs = [([jnp.asarray(p) for p in planes], fmt, uni)
                for planes, fmt, uni in srcs]
    ref = composite_frame_pallas((W, H), jax_srcs, interpret=True,
                                 out_fmt=out_fmt)
    launches = frame.launches
    got = frame.composite_frame_cuda((W, H), interop.to_port_sources(
        jax_srcs, CPU), interop.pixel_format(out_fmt))
    assert frame.launches == launches  # CPU tensors take the plain version
    _check(got, [np.asarray(r) for r in ref])


_UNIFORMS = {
    "identity": lambda mod: mod.identity_uniforms((64, 32), (W, H),
                                                  opacity=0.5),
    "rect": lambda mod: mod.rect_uniforms((W, H), (W, H), x=3.3, y=2.7,
                                          w=W / 2, h=H / 2, opacity=0.9,
                                          fill_color=(0.1, 0.2, 0.3, 0.5)),
    "rotated+border": lambda mod: mod.rect_uniforms(
        (96, 48), (W, H), x=180, y=100, w=110, h=60, rotation=-0.5,
        border=(176, 96, 118, 68)),
    "texture": lambda mod: mod.rect_uniforms(
        (W, H), (W, H), x=10, y=20, w=100, h=50,
        texture_matrix=m4.translation(0.1, 0.05) @ m4.scale(0.8, 0.9)),
}


@pytest.mark.parametrize("name", sorted(_UNIFORMS))
def test_uniform_pack_layout_matches_jax(name):
    from swiftvideo_tpu.ops import uniforms as jax_uniforms
    ours = _UNIFORMS[name](port_uniforms).pack()
    theirs = _UNIFORMS[name](jax_uniforms).pack()
    assert ours.dtype == theirs.dtype == np.float32
    assert ours.shape == (port_uniforms.UNIFORM_WIDTH,)
    assert np.array_equal(ours.view(np.uint32), theirs.view(np.uint32))
    back = port_uniforms.ImageUniforms.unpack(ours).pack()
    assert np.array_equal(back, ours)


@pytest.mark.parametrize("seed", range(4))
def test_border_box_covers_border_mask(seed):
    """The kernel skips a source outside its host-computed pixel box; the
    box must hold every pixel the exact border mask marks, on both grids."""
    rng = np.random.default_rng(seed)
    x, y = rng.uniform(-60, W), rng.uniform(-40, H)
    uni = port_uniforms.rect_uniforms(
        (W, H), (W, H), x=x, y=y, w=rng.uniform(1, W), h=rng.uniform(1, H),
        rotation=rng.uniform(-3.2, 3.2),
        border=(x - 5, y - 3, rng.uniform(10, W), rng.uniform(10, H)))
    planes = [torch.from_numpy(p) for p in _planes(rng, PF.y420p, W, H)]
    table = frame.descriptors((W, H), [(planes, PortPF.y420p, uni)])
    p = uni.pack()
    for g, (gh, gw) in enumerate(((H, W), (H // 2, W // 2))):
        border = composite._masks(p, gh, gw, CPU)[0].numpy()
        y0, y1, x0, x1 = table["box"][0, g]
        ys, xs = np.nonzero(border)
        outside = (ys < y0) | (ys >= y1) | (xs < x0) | (xs >= x1)
        assert not outside.any()


def test_descriptor_table():
    rng = np.random.default_rng(3)
    srcs = interop.to_port_sources(
        [_quadrants(rng, PF.y420p)[0], _odd_geometry(rng)[1],
         _overlay(rng, PF.BGRA)], CPU)
    table = frame.descriptors((W, H), srcs)
    assert table.dtype.itemsize == 192
    assert list(table["fmt"]) == [0, 1, 4]
    assert [tuple(d) for d in table["dims"]] == [
        (H, W, H // 2, W // 2), (120, W, 60, W // 2), (OV_H, W, OV_H, W)]
    for row, (planes, _fmt, uni) in zip(table, srcs):
        assert list(row["plane"][:len(planes)]) == [t.data_ptr()
                                                    for t in planes]
        assert np.array_equal(row["u"], uni)


def test_run_compute_kernel_matches_jax_registry():
    """applyComputeImage through the port's registry (plain route on the
    CPU) against the JAX registry's golden route; the samples reach the port
    through interop."""
    rng = np.random.default_rng(5)
    image = create_picture_sample((W // 2, H // 2), PF.y420p, asset_id="a",
                                  workspace_id="w")
    for p, v in zip(image.planes(), _planes(rng, PF.y420p, W // 2, H // 2)):
        p[:] = v
    model = m4.ortho(W, H) @ m4.translation(30.5, 20.25) @ m4.scale(200, 100)
    image = image.with_(matrix=model, opacity=0.8,
                        fill_color=np.array([0.2, 0.4, 0.6, 0.5], np.float32))
    target = create_picture_sample((W, H), PF.nv12, asset_id="t",
                                   workspace_id="w")
    for p, v in zip(target.planes(), _planes(rng, PF.nv12, W, H)):
        p[:] = v
    ctx = registry.make_compute_context("cpu")
    port_image = interop.picture_sample(image)
    port_target = interop.picture_sample(target)
    ours = registry.apply_compute_image(ctx, port_image, port_target)
    theirs = jax_registry.apply_compute_image(jax_context("golden"), image,
                                              target)
    _check(ours.planes(), [np.asarray(p) for p in theirs.planes()])
    cleared = registry.run_compute_kernel(
        ctx, [], port_target, registry.ComputeKernel.clear(PortPF.nv12))
    assert int(cleared.planes()[0].max()) == 0
    assert set(np.unique(cleared.planes()[1].numpy())) == {128}
    with pytest.raises(registry.ComputeError, match="not yet ported"):
        registry.run_compute_kernel(
            ctx, [port_image, port_image], port_target,
            registry.default_compute_kernel_from_string(
                "me_fullsearch_pyramid"))
