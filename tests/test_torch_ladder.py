"""The rendition ladder (``matscale.scale_ladder``) on the CPU.

* On CPU tensors the ladder is ``scale_y420p_batch`` rung by rung (the
  products), in plan order.
* The products lie within 1 LSB of the benchmark's plain reference
  (``svbench/reference/ladder.py``: each frame composited alone with the
  full-cell placement onto a cleared canvas of the rung's size).  The 1 LSB
  is the products' stated contract (ops/matscale.py): ``V @ X @ H`` sums
  the same four taps with the same weights as golden's bilinear sample, but
  in another order, so a value within a few float32 ulps of a half rounds
  the other way.
* The cell wrapper's plain fold (``frame.composite_cells_cuda`` on CPU
  tensors with the plans' uniforms), the card's route in plain torch,
  equals that reference at 0 LSB.
* The card's route, with ``meta`` tensors standing in for CUDA ones (the
  route follows the planes' device): one ``composite_cells_cuda`` call a
  rung with the plan's uniforms, and no product.

Sizes: 96x54 frames to 64x36, 48x28 and 26x14 (its chroma cell 13x7, odd
in both directions).  Inputs from ``np.random.default_rng``.
"""

import numpy as np
import pytest
import torch

from svbench.reference import ladder as ref_ladder
from swiftvideo_tpu_torch.media import PixelFormat as PF
from swiftvideo_tpu_torch.ops import frame, matscale
from swiftvideo_tpu_torch.ops.uniforms import identity_uniforms

SIZE = (96, 54)
RUNGS = [(64, 36), (48, 28), (26, 14)]
N = 4


def _batch(seed, n=N, size=SIZE):
    rng = np.random.default_rng(seed)
    w, h = size

    def u8(*shape):
        return torch.from_numpy(rng.integers(0, 256, shape, np.int64)
                                .astype(np.uint8))
    return u8(n, h, w), u8(n, h // 2, w // 2), u8(n, h // 2, w // 2)


def _plans(size=SIZE, rungs=RUNGS):
    return [matscale.plan_scale(identity_uniforms(size, r), r, size[::-1])
            for r in rungs]


def test_cpu_ladder_is_the_batch_scale_rung_by_rung():
    ys, us, vs = _batch(1)
    plans = _plans()
    calls = matscale.calls
    got = matscale.scale_ladder(ys, us, vs, plans)
    assert matscale.calls == calls + len(RUNGS)
    assert len(got) == len(RUNGS)
    for rung, plan, planes in zip(RUNGS, plans, got):
        want = matscale.scale_y420p_batch(ys, us, vs, plan)
        w, h = rung
        assert [tuple(p.shape) for p in planes] == [
            (N, h, w), (N, h // 2, w // 2), (N, h // 2, w // 2)]
        assert all(torch.equal(g, e) for g, e in zip(planes, want))


def test_cpu_ladder_within_one_lsb_of_the_reference():
    ys, us, vs = _batch(2)
    got = matscale.scale_ladder(ys, us, vs, _plans())
    worst = 0
    for rung, planes in zip(RUNGS, got):
        for c in range(N):
            want = ref_ladder.rung((ys[c], us[c], vs[c]), rung)
            for g, e in zip(planes, want):
                assert g[c].shape == e.shape
                worst = max(worst, int((g[c].int() - e.int()).abs().max()))
    assert worst <= 1


def test_plain_fold_equals_the_reference_exactly():
    ys, us, vs = _batch(3)
    for rung, plan in zip(RUNGS, _plans()):
        unis = np.broadcast_to(plan.uniform, (N, plan.uniform.shape[0]))
        w, h = rung
        canvas = frame.composite_cells_cuda(rung, [ys, us, vs], PF.y420p,
                                            unis)
        assert [tuple(p.shape) for p in canvas] == [
            (N * h, w), (N * (h // 2), w // 2), (N * (h // 2), w // 2)]
        for c in range(N):
            want = ref_ladder.rung((ys[c], us[c], vs[c]), rung)
            for plane, e in zip(canvas, want):
                ch = e.shape[0]
                assert torch.equal(plane[c * ch:(c + 1) * ch], e)


@pytest.mark.parametrize("rungs", [RUNGS, [(1280, 720), (960, 540),
                                           (768, 432), (640, 360),
                                           (416, 234)]],
                         ids=["tiny", "hls"])
def test_card_ladder_makes_one_cell_call_a_rung(monkeypatch, rungs):
    """meta tensors stand in for CUDA tensors: one cell call a rung, in
    plan order, with the rung's cell size, the batch's planes and the
    plan's uniform for every frame; no product."""
    size = (96, 54) if rungs is RUNGS else (1920, 1080)
    w, h = size
    seen = []

    def cells(cell_size, planes, fmt, uniforms, *, grid=None):
        seen.append((tuple(cell_size), list(planes), fmt,
                     np.asarray(uniforms), grid))
        cw, ch = cell_size
        n = planes[0].shape[0]
        return [torch.empty(s, dtype=torch.uint8, device="meta")
                for s in ((n * ch, cw), (n * (ch // 2), cw // 2),
                          (n * (ch // 2), cw // 2))]
    monkeypatch.setattr(frame, "composite_cells_cuda", cells)
    n = 16
    ys = torch.empty((n, h, w), dtype=torch.uint8, device="meta")
    us, vs = (torch.empty((n, h // 2, w // 2), dtype=torch.uint8,
                          device="meta") for _ in range(2))
    plans = _plans(size, rungs)
    calls = matscale.calls
    got = matscale.scale_ladder(ys, us, vs, plans)
    assert matscale.calls == calls
    assert [s[0] for s in seen] == [tuple(r) for r in rungs]
    for (cell, planes, fmt, unis, grid), plan, out in zip(seen, plans, got):
        assert fmt == PF.y420p and grid is None
        assert all(p is q for p, q in zip(planes, (ys, us, vs)))
        assert unis.shape == (n, 29)
        assert np.array_equal(unis.view(np.uint32),
                              np.broadcast_to(plan.uniform.view(np.uint32),
                                              (n, 29)))
        cw, ch = cell
        assert [tuple(p.shape) for p in out] == [
            (n, ch, cw), (n, ch // 2, cw // 2), (n, ch // 2, cw // 2)]
