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
  route follows the planes' device): one ``composite_ladder_cuda`` call
  for the whole ladder with every rung's size and uniform in plan order,
  and no product.
* The ladder's kept plan (``frame.LadderPlan``): its words are the rungs'
  ``CellPlan`` words, in launch order (the widest rung last), with each
  rung's targets moved to its 512-byte-aligned block of three flat
  canvases, its parameters are the rungs'
  ``cell_params`` onto the blocks' views, a repeated ladder at new
  addresses takes the kept plan, a changed uniform, stride or rung order
  builds another, and a bad batch raises what the per-rung path raises.
  ``composite_ladder_cuda`` runs on the card alone: CPU tensors raise
  (the card tests hold its rungs against the fold and the reference).

Sizes: 96x54 frames to 64x36, 48x28 and 26x14 (its chroma cell 13x7, odd
in both directions); for the plans, also 1920x1080 frames to the five HLS
rungs.  Inputs from ``np.random.default_rng``.
"""

import numpy as np
import pytest
import torch

from svbench.reference import ladder as ref_ladder
from swiftvideo_tpu_torch.core import spans
from swiftvideo_tpu_torch.media import PixelFormat as PF
from swiftvideo_tpu_torch.ops import frame, matscale
from swiftvideo_tpu_torch.ops.uniforms import identity_uniforms

SIZE = (96, 54)
RUNGS = [(64, 36), (48, 28), (26, 14)]
N = 4
HD = (1920, 1080)
HLS = [(1280, 720), (960, 540), (768, 432), (640, 360), (416, 234)]


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


@pytest.mark.parametrize("rungs", [RUNGS, HLS], ids=["tiny", "hls"])
def test_card_ladder_makes_one_ladder_call(monkeypatch, rungs):
    """meta tensors stand in for CUDA tensors: one ladder call for every
    rung, with the batch's planes and each rung's size and plan uniform in
    plan order; no product and no per-rung cell call.  The views it
    returns (the ladder plan's, on meta canvases) come back as the rungs,
    each shaped as the batch scale shapes it."""
    size = SIZE if rungs is RUNGS else HD
    w, h = size
    seen = []

    def ladder(planes, fmt, steps):
        seen.append((list(planes), fmt, list(steps)))
        plan = frame.ladder_plan(planes, fmt, steps)
        flats = [torch.empty(s, dtype=torch.uint8, device="meta")
                 for s in plan.sizes]
        return [tuple(f.as_strided(*v) for f, v in zip(flats, views))
                for views in plan.views]

    def cells(*_a, **_k):
        raise AssertionError("a per-rung cell call")
    monkeypatch.setattr(frame, "composite_ladder_cuda", ladder)
    monkeypatch.setattr(frame, "composite_cells_cuda", cells)
    n = 16
    ys = torch.empty((n, h, w), dtype=torch.uint8, device="meta")
    us, vs = (torch.empty((n, h // 2, w // 2), dtype=torch.uint8,
                          device="meta") for _ in range(2))
    plans = _plans(size, rungs)
    calls = matscale.calls
    got = matscale.scale_ladder(ys, us, vs, plans)
    assert matscale.calls == calls
    assert len(seen) == 1
    planes, fmt, steps = seen[0]
    assert fmt == PF.y420p
    assert len(planes) == 3 and all(p is q for p, q in zip(planes,
                                                           (ys, us, vs)))
    assert [tuple(s) for s, _ in steps] == [tuple(r) for r in rungs]
    for (_s, u), plan in zip(steps, plans):
        assert np.array_equal(np.asarray(u).view(np.uint32),
                              plan.uniform.view(np.uint32))
    assert len(got) == len(rungs)
    for (cw, ch), out in zip(rungs, got):
        assert [tuple(p.shape) for p in out] == [
            (n, ch, cw), (n, ch // 2, cw // 2), (n, ch // 2, cw // 2)]


# --- the ladder's kept plan -------------------------------------------------

LADDERS = {"tiny": (SIZE, RUNGS), "hls": (HD, HLS)}


def _empty_batch(size, n=3):
    """A batch of n frames of ``size`` (only the planes' shapes, strides
    and addresses matter to a plan)."""
    w, h = size
    return [torch.empty(s, dtype=torch.uint8) for s in
            ((n, h, w), (n, h // 2, w // 2), (n, h // 2, w // 2))]


def _steps(plans):
    return [(p.out_size, p.uniform) for p in plans]


def _counts(rec):
    return tuple(rec.counters.get(f"frame.cell_plan_{k}", 0)
                 for k in ("lookups", "fast", "misses"))


@pytest.mark.parametrize("name", list(LADDERS))
def test_ladder_words_are_the_rungs_cell_plans_moved(name):
    """Rung k's FrameParams in the ladder's table, in launch order, are its
    own cell plan's, word for word, but for the targets: each of its three
    moved by the rung's block offset, every offset on 512 bytes."""
    size, rungs = LADDERS[name]
    planes = _empty_batch(size)
    plans = _plans(size, rungs)
    ladder = frame.ladder_plan(planes, PF.y420p, _steps(plans))
    assert len(ladder.offsets) == len(rungs)
    assert sorted(ladder.order) == list(range(len(rungs)))
    at = 0
    for k in ladder.order:
        plan, offsets = plans[k], ladder.offsets[k]
        assert all(o % frame.LADDER_ALIGN == 0 for o in offsets)
        unis = np.broadcast_to(plan.uniform, (3, 29))
        cell = frame.cell_plan(plan.out_size, None, planes, PF.y420p, unis)
        want = cell.table.copy()
        want["head"]["out"] += np.array(offsets, np.uint64)
        got = ladder.table[at:at + len(want)]
        assert got.tobytes() == want.tobytes()
        at += len(want)
    assert at == len(ladder.table) == len(ladder.words)
    assert not ladder.table.flags.writeable
    assert ladder.ptr == ladder.table.ctypes.data


@pytest.mark.parametrize("sizes,order", [
    (HLS, [1, 2, 3, 4, 0]), (RUNGS, [1, 2, 0]), (HLS[::-1], [3, 2, 1, 0, 4]),
    ([(64, 36), (64, 18), (32, 18), (48, 28)], [3, 2, 0, 1]),
    ([(26, 14)], [0])], ids=["hls", "tiny", "hls-reversed", "ties", "one"])
def test_ladder_launch_order_puts_the_widest_last(sizes, order):
    """The launch table's rungs by cell width, widest first, but the
    widest width's rungs last (in rung order among themselves), so the
    row kernel merges the others with their nearest widths."""
    assert frame.launch_order(sizes) == order


@pytest.mark.parametrize("name", list(LADDERS))
def test_ladder_params_are_the_rungs_cell_params(name):
    """The words a ladder launches onto three flat canvases are each rung's
    ``cell_params`` onto its blocks' views of them."""
    size, rungs = LADDERS[name]
    planes = _empty_batch(size)
    plans = _plans(size, rungs)
    ladder = frame.ladder_plan(planes, PF.y420p, _steps(plans))
    flats = [torch.empty(s, dtype=torch.uint8) for s in ladder.sizes]
    words = ladder.params(flats, planes)
    at = 0
    for k in ladder.order:
        plan, views = plans[k], ladder.views[k]
        outs = [f.as_strided(*v) for f, v in zip(flats, views)]
        want = frame.cell_params(plan.out_size, None, planes, PF.y420p,
                                 np.broadcast_to(plan.uniform, (3, 29)), outs)
        assert np.array_equal(words[at:at + len(want)], np.stack(want))
        at += len(want)
    assert at == len(words)


@pytest.mark.parametrize("name", list(LADDERS))
def test_ladder_canvases_are_the_aligned_blocks(name):
    """Each flat canvas is the sum of its rungs' blocks, each block rounded
    up to 512 bytes; rung k's view of plane j starts at its block and has
    the rung's shape."""
    size, rungs = LADDERS[name]
    n = 3
    ladder = frame.ladder_plan(_empty_batch(size, n), PF.y420p,
                               _steps(_plans(size, rungs)))
    blocks = [[w * h * n, (w // 2) * (h // 2) * n, (w // 2) * (h // 2) * n]
              for w, h in rungs]
    align = frame.LADDER_ALIGN
    assert ladder.sizes == tuple(
        sum(-(-b[j] // align) * align for b in blocks) for j in range(3))
    for (w, h), views, offsets in zip(rungs, ladder.views, ladder.offsets):
        shapes = [(n, h, w), (n, h // 2, w // 2), (n, h // 2, w // 2)]
        for (shape, stride, at), want, off, size_j in zip(
                views, shapes, offsets, ladder.sizes):
            assert shape == want and at == off
            assert stride == (want[1] * want[2], want[2], 1)
            assert at + n * want[1] * want[2] <= size_j


@pytest.mark.parametrize("name", list(LADDERS))
def test_ladder_repeated_at_new_addresses_takes_the_kept_plan(
        monkeypatch, name):
    """A second ladder of new planes of the same shapes at new addresses
    is answered by the kept plan after its short check: one lookup, one
    fast, no build."""
    monkeypatch.setattr(frame, "_recent_ladder", None)
    size, rungs = LADDERS[name]
    plans = _plans(size, rungs)
    first = _empty_batch(size)
    kept = frame.ladder_plan(first, PF.y420p, _steps(plans))
    again = _empty_batch(size)
    assert again[0].data_ptr() != first[0].data_ptr()
    spans.start()
    try:
        plan = frame.ladder_plan(again, PF.y420p, _steps(plans))
    finally:
        rec = spans.stop()
    assert plan is kept
    assert _counts(rec) == (1, 1, 0)


def _other_strides(planes):
    """The batch with 64 bytes between its frames: each frame still
    contiguous, the planes' strides another layout's."""
    out = []
    for p in planes:
        n, h, w = p.shape
        out.append(torch.zeros(n * (h * w + 64), dtype=torch.uint8)
                   .as_strided((n, h, w), (h * w + 64, w, 1)))
    return out


@pytest.mark.parametrize("change", ["uniform", "strides", "order"])
@pytest.mark.parametrize("name", list(LADDERS))
def test_ladder_changed_by_value_builds_another_plan(monkeypatch, name,
                                                     change):
    """A ladder that differs from the kept one in a uniform's value, its
    planes' strides or its rungs' order is not answered by the kept plan:
    it is checked in full and builds the plan of its key."""
    monkeypatch.setattr(frame, "_recent_ladder", None)
    frame._ladder.cache_clear()
    size, rungs = LADDERS[name]
    plans = _plans(size, rungs)
    planes = _empty_batch(size)
    kept = frame.ladder_plan(planes, PF.y420p, _steps(plans))
    steps = _steps(plans)
    if change == "uniform":
        u = plans[-1].uniform.copy()
        u[22] = np.float32(0.5)
        steps[-1] = (plans[-1].out_size, u)
    elif change == "strides":
        planes = _other_strides(planes)
    else:
        steps = steps[::-1]
    spans.start()
    try:
        plan = frame.ladder_plan(planes, PF.y420p, steps)
    finally:
        rec = spans.stop()
    assert plan is not kept and frame._recent_ladder is plan
    assert _counts(rec) == (1, 0, 1)
    assert [r for r, _ in plan.rungs] == [tuple(s) for s, _ in steps]
    assert [p.strides for p in plan.plans] == [
        tuple(t.stride() for t in planes)] * len(steps)


def _bad_batches():
    ys, us, vs = _batch(7, n=2)
    return {
        "frame counts": [ys, us[:1], vs],
        "empty": [ys[:0], us[:0], vs[:0]],
        "not contiguous": [ys[:, :, ::2], us, vs],
        "not u8": [ys.float(), us, vs],
        "chroma shapes": [ys, us, vs[:, :4].contiguous()],
    }


@pytest.mark.parametrize("bad", list(_bad_batches()))
def test_ladder_refuses_what_the_rung_path_refuses(monkeypatch, bad):
    """A batch the cell wrapper refuses is refused by the ladder with the
    same error, the kept plan or not."""
    planes = _bad_batches()[bad]
    plans = _plans()
    monkeypatch.setattr(frame, "_recent_ladder", None)
    frame.ladder_plan(list(_batch(7, n=2)), PF.y420p, _steps(plans))
    with pytest.raises(Exception) as rung:
        frame.cell_plan(plans[0].out_size, None, planes, PF.y420p,
                        np.broadcast_to(plans[0].uniform, (2, 29)))
    with pytest.raises(type(rung.value)) as ladder:
        frame.ladder_plan(planes, PF.y420p, _steps(plans))
    assert str(ladder.value) == str(rung.value)


def test_ladder_refuses_odd_rungs_and_uniform_batches():
    planes = list(_batch(8, n=2))
    plans = _plans()
    with pytest.raises(ValueError, match="even, positive"):
        frame.ladder_plan(planes, PF.y420p, [((25, 14), plans[2].uniform)])
    with pytest.raises(ValueError, match="uniform rows"):
        frame.ladder_plan(planes, PF.y420p,
                          [(plans[0].out_size,
                            np.broadcast_to(plans[0].uniform, (2, 29)))])
    with pytest.raises(ValueError, match="at least one rung"):
        frame.ladder_plan(planes, PF.y420p, [])


def test_cpu_ladder_call_is_refused():
    """``composite_ladder_cuda`` runs on the card alone: CPU tensors are
    refused after the lookup, as the cell wrapper refuses a device it has
    no kernel for, and ``scale_ladder`` sends them to the products."""
    ys, us, vs = _batch(9)
    plans = _plans()
    with pytest.raises(ValueError, match="runs on cuda, not cpu"):
        frame.composite_ladder_cuda([ys, us, vs], PF.y420p, _steps(plans))
    got = matscale.scale_ladder(ys, us, vs, plans)
    for plan, planes in zip(plans, got):
        for g, c in zip(planes, matscale.scale_y420p_batch(ys, us, vs, plan)):
            assert torch.equal(g, c)
