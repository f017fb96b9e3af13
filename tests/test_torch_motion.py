"""The port's motion search against the JAX package's, on the CPU.

``swiftvideo_tpu_torch.ops.motion`` (the plain version, which the wrapper
takes for CPU tensors) against the scalar oracles ``me_fullsearch_golden``
and ``me_ssd_golden``, the JAX device paths ``me_fullsearch_device`` and
one interpret-mode case each of the Pallas kernels.  Frames come from
``np.random.default_rng``.  Tolerance: none; the search contract is exact
(the same candidate wins, so the MV maps are equal byte for byte).
"""

import numpy as np
import pytest
import torch

from swiftvideo_tpu.media import PixelFormat as JaxPF
from swiftvideo_tpu.media import create_picture_sample
from swiftvideo_tpu.ops import make_compute_context as jax_context
from swiftvideo_tpu.ops import motion as jax_motion
from swiftvideo_tpu.ops import registry as jax_registry
from swiftvideo_tpu_torch import interop
from swiftvideo_tpu_torch.media import BufferType, PixelFormat
from swiftvideo_tpu_torch.ops import motion, registry

GOLDEN = {"sad": jax_motion.me_fullsearch_golden,
          "ssd": jax_motion.me_ssd_golden}
GEOMS = [(96, 128, 64), (128, 256, 64), (120, 128, 32), (48, 80, 64)]


def _frames(h, w, seed):
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 255, (h, w), np.uint8)
    cur = np.clip(ref.astype(int) + rng.integers(-12, 12, ref.shape), 0,
                  255).astype(np.uint8)
    return cur, ref


def _port(cur, ref, search, metric):
    launches = motion.launches
    out = motion.me_fullsearch(torch.from_numpy(cur), torch.from_numpy(ref), 16,
                               search, metric)
    assert motion.launches == launches  # CPU tensors take the plain version
    assert out.dtype == torch.uint8 and out.device.type == "cpu"
    return out.numpy()


@pytest.mark.parametrize("metric", motion.METRICS)
@pytest.mark.parametrize("geom", GEOMS, ids=lambda g: "x".join(map(str, g)))
def test_plain_matches_golden_and_jax_device(geom, metric):
    """Clamped windows at every edge, the right-edge column's shorter x
    window and a bottom strip whose last rows are read but never searched
    (120 rows: 7 block rows and 8 rows more)."""
    h, w, search = geom
    cur, ref = _frames(h, w, h + w + search)
    ours = _port(cur, ref, search, metric)
    assert ours.shape == (h // 16, w // 16, 4)
    assert np.array_equal(ours, GOLDEN[metric](cur, ref, 16, search))
    if metric == "sad" and h % 16:
        # the JAX SAD scan reshapes the whole frame into blocks, so it
        # takes only whole block rows; its package sends such frames to
        # the Pallas kernel, held against the oracle above
        return
    dev = jax_motion.me_fullsearch_device(cur, ref, 16, search, metric=metric)
    assert np.array_equal(ours, np.asarray(dev))


def test_sad_matches_pallas_interpret():
    cur, ref = _frames(96, 128, 5)
    pal = jax_motion.me_fullsearch_pallas(cur, ref, 16, 64, interpret=True)
    assert pal is not None
    assert np.array_equal(_port(cur, ref, 64, "sad"), np.asarray(pal))


def test_ssd_matches_pallas_interpret():
    cur, ref = _frames(96, 128, 6)
    pal = jax_motion.me_fullsearch_ssd_pallas(cur, ref, 16, 64, interpret=True)
    assert np.array_equal(_port(cur, ref, 64, "ssd"), np.asarray(pal))


def test_tables_match_the_jax_kernels():
    """Cost tables built on the host in float64 and rounded once to float32,
    bit for bit the JAX kernels' tables; the u8 MV channel as the oracle
    rounds it."""
    d_lo, cost2, axis, mv_u8 = motion.tables(16, 64)
    geom = jax_motion._pallas_geometry(96, 256, 16, 64)
    assert d_lo == geom["d_lo"]
    assert np.array_equal(cost2.view(np.uint32), geom["cost"].view(np.uint32))
    dvals = (d_lo + np.arange(len(axis))).astype(np.float64)
    want = jax_motion._axis_cost(-dvals).astype(np.float32)
    assert np.array_equal(axis.view(np.uint32), want.view(np.uint32))
    for mv in range(-32, 33):
        want = int(np.rint((mv / 32 * 0.5 + 0.5) * 255.0))
        assert mv_u8[mv + 32] == want


@pytest.mark.parametrize("metric", motion.METRICS)
def test_translation_recovered(metric):
    rng = np.random.default_rng(9)
    ref = rng.integers(0, 255, (128, 128), np.uint8)
    cur = np.roll(ref, (6, -5), axis=(0, 1))
    out = _port(cur, ref, 64, metric)
    inner = out[2:6, 2:6]
    assert np.all(inner[..., 0] == round((-5 / 32 * 0.5 + 0.5) * 255))
    assert np.all(inner[..., 2] == round((6 / 32 * 0.5 + 0.5) * 255))
    assert np.all(inner[..., 1] == 128) and np.all(inner[..., 3] == 255)


def test_empty_window_gives_zero_vectors():
    cur, ref = _frames(64, 64, 3)
    for metric in motion.METRICS:
        out = _port(cur, ref, 16, metric)
        assert np.array_equal(out, GOLDEN[metric](cur, ref, 16, 16))
        assert np.all(out[..., 0] == 128) and np.all(out[..., 2] == 128)


@pytest.mark.parametrize("name", ["me_fullsearch", "me_fullsearch_ssd"])
def test_registry_route_matches_jax_registry(name):
    cur, ref = _frames(96, 128, 12)
    samples = []
    for plane in (cur, ref):
        s = create_picture_sample((128, 96), JaxPF.y420p, asset_id="cam",
                                  workspace_id="w")
        s.planes()[0][:] = plane
        samples.append(s)
    target = create_picture_sample((8, 6), JaxPF.RGBA, asset_id="mv",
                                   workspace_id="w")
    theirs = jax_registry.run_compute_kernel(
        jax_context("jax"), samples, target,
        jax_registry.default_compute_kernel_from_string(name))
    ours = registry.run_compute_kernel(
        registry.make_compute_context("cpu"),
        [interop.picture_sample(s) for s in samples],
        interop.picture_sample(target),
        registry.default_compute_kernel_from_string(name))
    assert ours.pixel_format() is PixelFormat.RGBA
    assert ours.buffer_type() is BufferType.cpu
    assert ours.size() == (8, 6) and ours.asset_id() == "mv"
    assert np.array_equal(ours.planes()[0].numpy(),
                          np.asarray(theirs.planes()[0]))


def test_registry_refuses_the_pyramid_and_a_missing_reference():
    pic = interop.picture_sample(create_picture_sample(
        (64, 64), JaxPF.y420p, asset_id="cam", workspace_id="w"))
    ctx = registry.make_compute_context("cpu")
    with pytest.raises(registry.ComputeError, match="not yet ported"):
        registry.run_compute_kernel(
            ctx, [pic, pic], pic,
            registry.default_compute_kernel_from_string("me_fullsearch_pyramid"))
    with pytest.raises(registry.ComputeError, match="badInputData"):
        registry.run_compute_kernel(
            ctx, [pic], pic,
            registry.default_compute_kernel_from_string("me_fullsearch"))


_U8 = torch.zeros(64, 64, dtype=torch.uint8)


@pytest.mark.parametrize("name,args,error", [
    ("numpy frames", (np.zeros((64, 64), np.uint8), _U8), TypeError),
    ("int16 frames", (_U8.to(torch.int16), _U8.to(torch.int16)), TypeError),
    ("rgba frames", (torch.zeros(64, 64, 4, dtype=torch.uint8),) * 2,
     TypeError),
    ("shapes differ", (_U8, torch.zeros(64, 48, dtype=torch.uint8)),
     ValueError),
    ("unknown metric", (_U8, _U8, 16, 64, "satd"), ValueError),
    ("inexact ssd block", (_U8, _U8, 32, 64, "ssd"), ValueError),
])
def test_wrapper_rejects_inputs_it_does_not_take(name, args, error):
    launches = motion.launches
    with pytest.raises(error):
        motion.me_fullsearch(*args)
    assert motion.launches == launches
