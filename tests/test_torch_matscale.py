"""The port's matmul scaler (ops/matscale.py) against golden and the JAX
package's ``matscale`` on the CPU.  Tolerance: <= 1 LSB for pixels (the
contract of both packages: float32 products against golden's bilinear
sample, quantized half to even); plan geometry and hat matrices bit-equal
(the plan is host numpy in both packages)."""

import numpy as np
import pytest
import torch

from swiftvideo_tpu.media.pixel import PixelFormat as JPF
from swiftvideo_tpu.ops import golden, matscale as jax_matscale
from swiftvideo_tpu.ops.pallas_frame import _plane_params_np as jax_params
from swiftvideo_tpu.ops.uniforms import (identity_uniforms as jax_identity,
                                         rect_uniforms as jax_rect)
from swiftvideo_tpu_torch.ops import fp32, matscale
from swiftvideo_tpu_torch.ops.uniforms import identity_uniforms, rect_uniforms

TOL = 1

GEOMETRIES = [
    ((1080, 1920), (720, 1280)),   # ladder 2:3 vertical
    ((1080, 1920), (480, 854)),    # ladder 4:9 vertical
    ((1080, 1920), (360, 640)),    # integer 3:1
    ((1080, 1920), (136, 240)),    # wall tile: 135:17 vertical, 8:1 horiz
    ((720, 1280), (1080, 1920)),   # upscale
    ((256, 256), (256, 256)),      # identity
]


def _rand_y420p(rng, h, w):
    return [rng.integers(0, 256, (h, w), np.int64).astype(np.uint8),
            rng.integers(0, 256, (h // 2, w // 2), np.int64).astype(np.uint8),
            rng.integers(0, 256, (h // 2, w // 2), np.int64).astype(np.uint8)]


def _golden(planes, in_size, out_size):
    return golden.composite_stack(JPF.y420p, out_size, [
        (planes, JPF.y420p, jax_identity(in_size, out_size))])


def _max_err(a, b):
    return max(int(np.abs(np.asarray(x).astype(int)
                          - np.asarray(y).astype(int)).max())
               for x, y in zip(a, b))


@pytest.mark.parametrize("in_hw,out_hw", GEOMETRIES)
def test_scale_matches_golden_and_jax(in_hw, out_hw):
    rng = np.random.default_rng(42)
    (ih, iw), (oh, ow) = in_hw, out_hw
    planes = _rand_y420p(rng, ih, iw)
    plan = matscale.plan_scale(identity_uniforms((iw, ih), (ow, oh)),
                               (ow, oh), (ih, iw))
    assert plan is not None
    out = matscale.scale_y420p([torch.from_numpy(p) for p in planes], plan)
    assert [tuple(o.shape) for o in out] == [(oh, ow), (oh // 2, ow // 2),
                                             (oh // 2, ow // 2)]
    assert all(o.dtype == torch.uint8 for o in out)
    ours = [o.numpy() for o in out]
    assert _max_err(ours, _golden(planes, (iw, ih), (ow, oh))) <= TOL
    jplan = jax_matscale.plan_scale(jax_identity((iw, ih), (ow, oh)),
                                    (ow, oh), (ih, iw))
    assert _max_err(ours, jax_matscale.scale_y420p(planes, jplan)) <= TOL


def test_scale_batch_matches_golden_and_jax():
    rng = np.random.default_rng(0)
    n = 3
    ys = np.stack([_rand_y420p(rng, 108, 192)[0] for _ in range(n)])
    us = rng.integers(0, 256, (n, 54, 96), np.int64).astype(np.uint8)
    vs = rng.integers(0, 256, (n, 54, 96), np.int64).astype(np.uint8)
    plan = matscale.plan_scale(identity_uniforms((192, 108), (48, 36)),
                               (48, 36), (108, 192))
    oy, ou, ov = matscale.scale_y420p_batch(
        torch.from_numpy(ys), torch.from_numpy(us), torch.from_numpy(vs), plan)
    assert tuple(oy.shape) == (n, 36, 48) and tuple(ou.shape) == (n, 18, 24)
    jplan = jax_matscale.plan_scale(jax_identity((192, 108), (48, 36)),
                                    (48, 36), (108, 192))
    jy, ju, jv = jax_matscale.scale_y420p_batch(ys, us, vs, jplan)
    assert _max_err([oy, ou, ov], [jy, ju, jv]) <= TOL
    for i in range(n):
        ref = _golden([ys[i], us[i], vs[i]], (192, 108), (48, 36))
        assert _max_err([oy[i], ou[i], ov[i]], ref) <= TOL
        one = matscale.scale_y420p([torch.from_numpy(p[i])
                                    for p in (ys, us, vs)], plan)
        assert all(torch.equal(a, b[i]) for a, b in zip(one, (oy, ou, ov)))


# (name, port uniforms, JAX uniforms, out size, in (h, w))
PLAN_CASES = [
    ("identity upscale", identity_uniforms((64, 64), (128, 128)),
     jax_identity((64, 64), (128, 128)), (128, 128), (64, 64)),
    ("wall tile", identity_uniforms((1920, 1080), (240, 136)),
     jax_identity((1920, 1080), (240, 136)), (240, 136), (1080, 1920)),
    ("partial-canvas rect", rect_uniforms((64, 64), (128, 128), x=0, y=0,
                                          w=64, h=64),
     jax_rect((64, 64), (128, 128), x=0, y=0, w=64, h=64), (128, 128),
     (64, 64)),
    ("opacity 0.5", identity_uniforms((64, 64), (128, 128), opacity=0.5),
     jax_identity((64, 64), (128, 128), opacity=0.5), (128, 128), (64, 64)),
    ("rotated", rect_uniforms((64, 64), (128, 128), x=0, y=0, w=128, h=128,
                              rotation=0.3),
     jax_rect((64, 64), (128, 128), x=0, y=0, w=128, h=128, rotation=0.3),
     (128, 128), (64, 64)),
    ("odd output", identity_uniforms((64, 64), (127, 128)),
     jax_identity((64, 64), (127, 128)), (127, 128), (64, 64)),
    ("odd input", identity_uniforms((63, 64), (128, 128)),
     jax_identity((63, 64), (128, 128)), (128, 128), (64, 63)),
    ("full-cover rect", rect_uniforms((32, 16), (96, 64), x=0, y=0, w=96,
                                      h=64),
     jax_rect((32, 16), (96, 64), x=0, y=0, w=96, h=64), (96, 64), (16, 32)),
]


@pytest.mark.parametrize("case", PLAN_CASES, ids=lambda c: c[0])
def test_plan_is_none_exactly_where_jax_is(case):
    _name, uni, juni, out_size, in_hw = case
    ours = matscale.plan_scale(uni, out_size, in_hw)
    theirs = jax_matscale.plan_scale(juni, out_size, in_hw)
    assert (ours is None) == (theirs is None)
    if ours is not None:
        for a, b in zip((ours.vy, ours.hy, ours.vc, ours.hc),
                        (theirs.vy, theirs.hy, theirs.vc, theirs.hc)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        assert ours.out_size == theirs.out_size


@pytest.mark.parametrize("seed", range(4))
def test_plane_params_and_hat_matrix_bit_equal_jax(seed):
    rng = np.random.default_rng(seed)
    uni = rect_uniforms((int(rng.integers(16, 400)), int(rng.integers(16, 400))),
                        (640, 360), x=float(rng.uniform(-50, 300)),
                        y=float(rng.uniform(-50, 200)),
                        w=float(rng.uniform(10, 700)),
                        h=float(rng.uniform(10, 400)),
                        opacity=float(rng.uniform(0.1, 1.0)))
    p = uni.pack()
    for h_out, w_out, h_in, w_in in ((360, 640, 1080, 1920),
                                     (180, 320, 540, 960), (37, 91, 13, 7)):
        a = matscale._plane_params_np(p, h_out, w_out, h_in, w_in)
        b = jax_params(p, h_out, w_out, h_in, w_in)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for n_out, n_in in ((720, 1080), (136, 1080), (1080, 720), (7, 3)):
        a_, b_ = float(rng.uniform(0.1, 3.0)), float(rng.uniform(-2.0, 2.0))
        for t in (False, True):
            assert np.array_equal(matscale.hat_matrix(n_out, n_in, a_, b_, t),
                                  jax_matscale.hat_matrix(n_out, n_in, a_, b_,
                                                          t))


def test_plan_copies_matrices_once_per_device():
    plan = matscale.plan_scale(identity_uniforms((64, 32), (32, 16)),
                               (32, 16), (32, 64))
    first = plan.on(torch.device("cpu"))
    assert plan.on(torch.device("cpu")) is first
    assert [tuple(m.shape) for m in first] == [(16, 32), (64, 32), (8, 16),
                                                (32, 16)]
    assert all(m.dtype == torch.float32 and m.is_contiguous() for m in first)


def test_scale_rejects_planes_that_do_not_fit():
    plan = matscale.plan_scale(identity_uniforms((64, 32), (32, 16)),
                               (32, 16), (32, 64))
    y = torch.zeros(32, 64, dtype=torch.uint8)
    c = torch.zeros(16, 32, dtype=torch.uint8)
    with pytest.raises(ValueError):
        matscale.scale_y420p([torch.zeros(30, 64, dtype=torch.uint8), c, c],
                             plan)
    with pytest.raises(TypeError):
        matscale.scale_y420p([y.float(), c, c], plan)


@pytest.mark.parametrize("switch", ["precision high", "precision medium",
                                    "allow_tf32"])
def test_scale_raises_when_tf32_switches_are_on(switch):
    """The <= 1 LSB contract needs full float32: a reduced-precision switch
    makes the call raise rather than lose it."""
    plan = matscale.plan_scale(identity_uniforms((64, 32), (32, 16)),
                               (32, 16), (32, 64))
    planes = [torch.zeros(32, 64, dtype=torch.uint8),
              torch.zeros(16, 32, dtype=torch.uint8),
              torch.zeros(16, 32, dtype=torch.uint8)]
    before = torch.get_float32_matmul_precision()
    try:
        if switch == "allow_tf32":
            torch.backends.cuda.matmul.allow_tf32 = True
        else:
            torch.set_float32_matmul_precision(switch.split()[1])
        with pytest.raises(RuntimeError, match="full float32"):
            matscale.scale_y420p(planes, plan)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision(before)
    fp32.check_fp32_matmul()
    assert len(matscale.scale_y420p(planes, plan)) == 3
