"""The port's one-device mixing wall (parallel/wall.py) against the JAX
package's ``MixingWall`` on the 8-device CPU mesh of tests/conftest.py.
Tolerance: <= 1 LSB for wall pixels (both sides sample within 1 LSB of
golden: float32 products on the plan path, golden's arithmetic on the
per-cell path); exact for the mixed audio, whose gains are powers of two so
that every float32 sum is exact in any order.  Layouts follow
tests/test_wall.py: square aligned, 6x8 rectangular aligned, stream counts
that take the gather path on the mesh, per-cell uniforms."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swiftvideo_tpu.ops.uniforms import (identity_uniforms as jax_identity,
                                         rect_uniforms as jax_rect)
from swiftvideo_tpu.parallel import MixingWall as JaxWall, make_mesh
from swiftvideo_tpu_torch.ops import composite, frame, registry
from swiftvideo_tpu_torch.parallel import MixingWall

TOL = 1


def _inputs(seed, n, sw, sh, samples):
    rng = np.random.default_rng(seed)
    ys = rng.integers(0, 256, (n, sh, sw), np.int64).astype(np.uint8)
    us = rng.integers(0, 256, (n, sh // 2, sw // 2), np.int64).astype(np.uint8)
    vs = rng.integers(0, 256, (n, sh // 2, sw // 2), np.int64).astype(np.uint8)
    audio = rng.integers(-30000, 30000, (n, samples * 2),
                         np.int64).astype(np.int16)
    gains = rng.choice(np.float32([0.25, 0.5, 1.0, 2.0]), n)
    return ys, us, vs, audio, gains


def _jax_wall(n, stream, canvas, grid, samples, inputs, uniforms=None):
    devices = jax.devices()[:8]
    assert len(devices) == 8, "tests/conftest.py gives an 8-device CPU mesh"
    wall = JaxWall(make_mesh(devices), n_streams=n, stream_size=stream,
                   canvas_size=canvas, grid=grid, audio_samples=samples)
    ys, us, vs, audio, gains = (wall.shard(jnp.asarray(a)) for a in inputs)
    uni = None if uniforms is None else wall.shard(jnp.asarray(uniforms))
    out = wall.step(ys, us, vs, audio, gains, uniforms=uni)
    return wall, [np.asarray(o) for o in out]


def _port_wall(n, stream, canvas, grid, samples, inputs, uniforms=None):
    wall = MixingWall(n_streams=n, stream_size=stream, canvas_size=canvas,
                      grid=grid, audio_samples=samples, device="cpu")
    ys, us, vs, audio, gains = (wall.shard(a) for a in inputs)
    out = wall.step(ys, us, vs, audio, gains, uniforms=uniforms)
    return wall, [o.numpy() for o in out]


def _assert_walls_agree(ours, theirs):
    for a, b in zip(ours[:3], theirs[:3]):
        assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
        assert np.abs(a.astype(int) - b.astype(int)).max() <= TOL
    assert ours[3].dtype == theirs[3].dtype == np.int16
    assert np.array_equal(ours[3], theirs[3])


# (name, streams, stream size, canvas, grid, port aligned, JAX aligned)
LAYOUTS = [
    ("64 square", 64, (64, 36), (128, 96), None, True, True),
    ("48 as 6x8", 48, (32, 16), (96, 64), (6, 8), True, True),
    ("20 on 5x4", 20, (32, 16), (80, 32), None, True, False),
    ("18 on 5x4", 18, (32, 16), (80, 32), None, False, False),
    ("60 on 8x8", 60, (64, 36), (128, 96), None, False, False),
]


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda c: c[0])
def test_plan_path_matches_jax(layout):
    _name, n, stream, canvas, grid, port_aligned, jax_aligned = layout
    inputs = _inputs(n, n, *stream, 24)
    calls = composite.calls
    ours_wall, ours = _port_wall(n, stream, canvas, grid, 24, inputs)
    theirs_wall, theirs = _jax_wall(n, stream, canvas, grid, 24, inputs)
    assert composite.calls == calls          # the products, no composite
    assert ours_wall.aligned == port_aligned
    assert theirs_wall.aligned == jax_aligned
    assert ours_wall.grid_wh == theirs_wall.grid_wh
    assert ours_wall.tile == theirs_wall.tile
    assert ours_wall._plan is not None
    _assert_walls_agree(ours, theirs)
    # excess cells are blank: luma 0, chroma 128
    gw, gh = ours_wall.grid_wh
    tw, th = ours_wall.tile
    for cell in range(n, gw * gh):
        r, c = divmod(cell, gw)
        assert not ours[0][r * th:(r + 1) * th, c * tw:(c + 1) * tw].any()
        for plane in ours[1:3]:
            assert (plane[r * th // 2:(r + 1) * th // 2,
                          c * tw // 2:(c + 1) * tw // 2] == 128).all()


def _cell_uniforms(n, stream, tile, rng):
    """Per-cell uniforms: identity, half opacity, an aspect inset with a
    fill colour and a border (edges at quarter pixels, clear of exact-
    integer seams), an offset rect."""
    tw, th = tile
    kinds = [
        lambda: jax_identity(stream, tile),
        lambda: jax_identity(stream, tile, opacity=0.5),
        lambda: jax_rect(stream, tile, x=1.25, y=2.25, w=tw - 2.5,
                         h=th - 4.5, fill_color=(0.9, 0.2, 0.1, 0.6),
                         border=(0.25, 0.25, tw - 0.5, th - 0.5)),
        lambda: jax_rect(stream, tile, x=3.25, y=-1.75, w=tw * 0.75,
                         h=th * 1.25, opacity=0.8),
    ]
    # stream 0 at half opacity, the rest drawn from every kind
    picks = [1] + [int(k) for k in rng.integers(0, len(kinds), n - 1)]
    return np.stack([kinds[k]().pack() for k in picks])


@pytest.mark.parametrize("layout", [LAYOUTS[0], LAYOUTS[3]],
                         ids=lambda c: c[0])
def test_per_cell_uniforms_match_jax(layout):
    _name, n, stream, canvas, grid, _port_aligned, _jax_aligned = layout
    inputs = _inputs(100 + n, n, *stream, 8)
    tile = MixingWall(n_streams=n, stream_size=stream, canvas_size=canvas,
                      grid=grid, device="cpu").tile
    unis = _cell_uniforms(n, stream, tile, np.random.default_rng(n))
    launches, calls = frame.launches, composite.calls
    _, ours = _port_wall(n, stream, canvas, grid, 8, inputs, uniforms=unis)
    # CPU tensors: one plain composite per stream, no kernel launch
    assert frame.launches == launches
    assert composite.calls == calls + n
    _, theirs = _jax_wall(n, stream, canvas, grid, 8, inputs, uniforms=unis)
    _assert_walls_agree(ours, theirs)


def test_default_uniforms_without_a_plan_take_the_per_cell_path():
    """An odd stream size leaves no plan: default uniforms composite each
    cell, as the JAX wall does."""
    n, stream, canvas = 16, (33, 18), (64, 32)
    inputs = _inputs(7, n, 32, 18, 8)
    inputs = (np.pad(inputs[0], ((0, 0), (0, 0), (0, 1)), mode="edge"),
              ) + inputs[1:]
    wall = MixingWall(n_streams=n, stream_size=stream, canvas_size=canvas,
                      device="cpu")
    assert wall._plan is None
    calls = composite.calls
    ours = [o.numpy() for o in wall.step(*(wall.shard(a) for a in inputs))]
    assert composite.calls == calls + n
    _, theirs = _jax_wall(n, stream, canvas, None, 8, inputs)
    _assert_walls_agree(ours, theirs)


def test_audio_truncates_and_saturates():
    wall = MixingWall(n_streams=64, stream_size=(16, 16),
                      canvas_size=(64, 64), audio_samples=8, device="cpu")
    ys = wall.shard(np.zeros((64, 16, 16), np.uint8))
    cs = wall.shard(np.full((64, 8, 8), 128, np.uint8))
    loud = wall.step(ys, cs, cs, wall.shard(np.full((64, 16), 30000,
                                                    np.int16)))[3]
    assert loud.tolist() == [32767] * 16
    low = wall.step(ys, cs, cs, wall.shard(np.full((64, 16), -30000,
                                                   np.int16)))[3]
    assert low.tolist() == [-32768] * 16
    # trunc toward zero before the clamp
    quiet = wall.step(ys, cs, cs, wall.shard(np.full((64, 16), -3, np.int16)),
                      gains=wall.shard(np.full(64, 0.25, np.float32)))[3]
    assert quiet.tolist() == [-48] * 16
    assert torch.equal(wall.default_gains(), torch.ones(64))


def test_default_gains_and_uniforms_are_kept_per_wall(monkeypatch):
    """A tick without gains or uniforms rebuilds neither: the gains are
    made once on the wall's device, the identity uniforms once on the host;
    what ``default_gains`` / ``default_uniforms`` hand out are copies the
    caller may change."""
    n, stream, canvas = 18, (32, 16), (80, 32)
    wall = MixingWall(n_streams=n, stream_size=stream, canvas_size=canvas,
                      audio_samples=8, device="cpu")
    ys, us, vs, audio, _gains = (wall.shard(a)
                                 for a in _inputs(3, n, *stream, 8))
    first = wall.step(ys, us, vs, audio)
    kept_gains, kept_unis = wall._gains, wall._unis

    def rebuilt(*args, **kwargs):
        raise AssertionError("a default was rebuilt in the tick")

    monkeypatch.setattr(wall, "shard", rebuilt)
    second = wall.step(ys, us, vs, audio)
    assert wall._gains is kept_gains and wall._unis is kept_unis
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    assert not kept_unis.flags.writeable
    gains, unis = wall.default_gains(), wall.default_uniforms()
    assert torch.equal(gains, kept_gains) and np.array_equal(unis, kept_unis)
    gains[0], unis[0] = 5.0, 0.0
    assert float(wall._gains[0]) == 1.0 and wall._unis[0, 0] != 0.0
    # the same audio as gains of ones given by hand
    explicit = wall.step(ys, us, vs, audio, torch.ones(n))
    assert torch.equal(explicit[3], first[3])


@pytest.mark.parametrize("kwargs", [
    dict(n_streams=48, stream_size=(32, 16), canvas_size=(96, 64),
         grid=(4, 4)),                                  # grid too small
    dict(n_streams=16, stream_size=(32, 16), canvas_size=(68, 36)),  # odd tile
    dict(n_streams=16, stream_size=(32, 16), canvas_size=(66, 32)),  # indivisible
], ids=["grid too small", "odd tiles", "canvas does not divide"])
def test_wall_rejects_bad_layouts_like_jax(kwargs):
    with pytest.raises(ValueError):
        MixingWall(device="cpu", **kwargs)
    with pytest.raises(ValueError):
        JaxWall(make_mesh(jax.devices()[:8]), **kwargs)


def test_wall_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(registry.ComputeError, match="deviceNotAvailable"):
        MixingWall(n_streams=4, stream_size=(32, 16), canvas_size=(64, 32))
