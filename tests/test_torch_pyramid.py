"""The port's two-stage motion search against the JAX package's, on the CPU.

``swiftvideo_tpu_torch.ops.motion.me_fullsearch_pyramid`` (CPU tensors take
the plain versions: ``me_coarse_torch`` and ``refine_torch``) against the
JAX ``me_fullsearch_pyramid`` and its coarse program ``_me_mxu_program``.
The pyramid is not exhaustive, so it is held to the JAX pyramid on whole
frames, edge blocks included, and to the oracles only where the JAX tests
hold the JAX pyramid to them (interior blocks of an even shift, smooth
content under an odd shift).  Frames come from ``np.random.default_rng``.
Tolerance: none; MV maps are equal byte for byte.

Geometries: 96x128 and 144x192 with search 64 (d_lo = -24) and search 62
(d_lo = -23: at the left edge the coarse dx grid holds odd tx only, while
the clamped window starts at tx = 0), and 96x112 (7 block columns, which no
group size divides: the coarse stage is the stride-1 grid).
"""

import numpy as np
import pytest
import torch

from swiftvideo_tpu.ops import motion as jax_motion
from swiftvideo_tpu.ops.registry import \
    default_compute_kernel_from_string as jax_kernel_name
from swiftvideo_tpu_torch.media import (BufferType, PixelFormat,
                                        create_picture_sample)
from swiftvideo_tpu_torch.ops import make_compute_context, motion, registry


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _noise(h, w, seed, shift=(3, -5), amp=24):
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 255, (h, w), np.uint8)
    cur = np.clip(ref.astype(int) + rng.integers(-amp, amp + 1, ref.shape),
                  0, 255).astype(np.uint8)
    return np.roll(cur, shift, axis=(0, 1)), ref


def _smooth(h, w, shift=(5, 3)):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    ref = ((np.sin(yy / 9.0) + np.cos(xx / 7.0) + 2.0) * 60.0).astype(np.uint8)
    return np.roll(ref, shift, axis=(0, 1)), ref


def _port(cur, ref, search=64, refine=2, metric="ssd"):
    launches = motion.launches
    out = motion.me_fullsearch_pyramid(_t(cur), _t(ref), 16, search, refine,
                                       metric)
    assert motion.launches == launches  # CPU tensors take the plain versions
    assert out.dtype == torch.uint8 and out.device.type == "cpu"
    return out.numpy()


def _jax(cur, ref, search=64, refine=2, metric="ssd"):
    return np.asarray(jax_motion.me_fullsearch_pyramid(cur, ref, 16, search,
                                                       refine, metric))


def test_even_shift_matches_golden_and_jax():
    """Twin of the JAX even-shift test: interior blocks equal the oracles
    for both refine metrics, and every block equals the JAX pyramid."""
    rng = np.random.default_rng(33)
    ref = rng.integers(0, 255, (96, 128), np.uint8)
    cur = np.roll(ref, (6, 4), axis=(0, 1))
    for metric, gold in (("ssd", jax_motion.me_ssd_golden),
                         ("sad", jax_motion.me_fullsearch_golden)):
        ours = _port(cur, ref, metric=metric)
        assert np.array_equal(ours, _jax(cur, ref, metric=metric))
        assert np.array_equal(ours[1:-1, 1:-1],
                              gold(cur, ref, 16, 64)[1:-1, 1:-1])


def test_odd_shift_smooth_content_matches_golden_and_jax():
    cur, ref = _smooth(96, 128)
    ours = _port(cur, ref)
    assert np.array_equal(ours, _jax(cur, ref))
    assert np.array_equal(ours[1:-1, 1:-1], jax_motion.me_ssd_golden(
        cur, ref, 16, 64)[1:-1, 1:-1])


@pytest.mark.parametrize("refine", [1, 2])
@pytest.mark.parametrize("metric", motion.METRICS)
@pytest.mark.parametrize("geom", [(96, 128, 64), (96, 128, 62),
                                  (144, 192, 64), (144, 192, 62)],
                         ids=lambda g: "x".join(map(str, g)))
def test_whole_frame_equals_jax_pyramid(geom, metric, refine):
    """Every block, edges included, on noise under an odd shift (where the
    coarse pick and the refine window both matter)."""
    h, w, search = geom
    cur, ref = _noise(h, w, h + w + search)
    assert np.array_equal(_port(cur, ref, search, refine, metric),
                          _jax(cur, ref, search, refine, metric))


@pytest.mark.parametrize("metric", motion.METRICS)
@pytest.mark.parametrize("content", ["noise", "smooth"])
def test_width_no_group_size_divides_equals_jax(content, metric):
    """112 columns are 7 blocks: the coarse stage searches the stride-1
    grid (the JAX package's dense exhaustive program)."""
    assert motion.coarse_stride(112) == 1 and motion.coarse_stride(128) == 2
    cur, ref = (_noise(96, 112, 7) if content == "noise"
                else _smooth(96, 112))
    assert np.array_equal(_port(cur, ref, metric=metric),
                          _jax(cur, ref, metric=metric))


@pytest.mark.parametrize("geom", [(96, 128, 64), (144, 192, 62),
                                  (96, 112, 64), (80, 96, 30)],
                         ids=lambda g: "x".join(map(str, g)))
def test_coarse_stage_equals_jax_program(geom):
    """The raw coarse vectors, before the refine can hide a difference."""
    h, w, search = geom
    cur, ref = _noise(h, w, h * w + search, amp=40)
    wb = w // 16
    gs = next((g for g in (8, 6, 5, 4, 3, 2) if wb % g == 0), 0)
    program = jax_motion._me_mxu_program(h, w, 16, search, grouped=bool(gs),
                                         raw=True, stride=2 if gs else 1)
    jx, jy = (np.asarray(a) for a in program(cur, ref))
    raw = motion.me_coarse(_t(cur), _t(ref), 16, search,
                           motion.coarse_stride(w))
    assert raw.dtype == torch.int32 and raw.shape == (h // 16, wb, 2)
    assert np.array_equal(raw[..., 0].numpy(), jx)
    assert np.array_equal(raw[..., 1].numpy(), jy)


@pytest.mark.parametrize("search", [30, 60, 62, 64])
def test_pyramid_mv_table_equals_jax_emit(search):
    """The u8 channel the refine emits, ``tables``' (the one table of every
    route), is the JAX ``_mv_rgba``'s (float32) for every clamped
    component.  At search 30 and 60 it differs from the float64 rounding of
    the oracles."""
    import jax.numpy as jnp
    max_mv = search // 2
    m = jnp.arange(-max_mv, max_mv + 1, dtype=jnp.float32)
    want = np.asarray(jax_motion._mv_rgba(m, m, search, jnp))[:, 0]
    got = motion.tables(16, search)[3]
    assert np.array_equal(got, want)
    f64 = np.clip(np.rint((np.arange(-max_mv, max_mv + 1) / max_mv * 0.5
                           + 0.5) * 255.0), 0, 255).astype(np.uint8)
    assert (search in (30, 60)) == (not np.array_equal(got, f64))


def test_fallback_geometries_equal_jax():
    """Twin of the JAX fallback test: an odd height takes the exhaustive
    search, and a degenerate window (search <= block) the zero map."""
    rng = np.random.default_rng(5)
    ref = rng.integers(0, 255, (65, 96), np.uint8)
    cur = np.roll(ref, 2, axis=1)
    assert motion.pyramid_falls_back(65, 96, 16, 32, 2)
    ours = _port(cur, ref, 32)
    assert np.array_equal(ours, _jax(cur, ref, 32))
    assert np.array_equal(ours, motion.me_fullsearch_torch(
        _t(cur), _t(ref), 16, 32, "ssd").numpy())
    z = np.zeros((64, 64), np.uint8)
    zero = _port(z, z, 16)
    assert zero.shape == (4, 4, 4)
    assert np.array_equal(zero, _jax(z, z, 16))


def test_registry_runs_the_pyramid():
    """``me_fullsearch_pyramid`` is a named kernel in both packages, and the
    port's registry runs it (defaults 16 / 64 / refine 2 / ssd) where it
    used to raise."""
    name = "me_fullsearch_pyramid"
    assert jax_kernel_name(name).name == name
    kernel = registry.default_compute_kernel_from_string(name)
    assert kernel.name == name
    cur, ref = _noise(96, 128, 11)
    ctx = make_compute_context("cpu")

    def sample(plane):
        s = create_picture_sample((128, 96), PixelFormat.y420p,
                                  asset_id="cam", workspace_id="w")
        return s.with_(img=s.img.with_buffers(
            [_t(plane)] + list(s.planes()[1:]), BufferType.cpu))

    target = create_picture_sample((8, 6), PixelFormat.RGBA, asset_id="mv",
                                   workspace_id="w")
    out = registry.run_compute_kernel(ctx, [sample(cur), sample(ref)],
                                      target, kernel)
    assert out.pixel_format() == PixelFormat.RGBA
    assert np.array_equal(np.asarray(out.planes()[0]), _jax(cur, ref))
