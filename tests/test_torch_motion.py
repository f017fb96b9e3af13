"""The port's motion search against the JAX package's, on the CPU.

``swiftvideo_tpu_torch.ops.motion`` (the plain version, which the wrapper
takes for CPU tensors) against the scalar oracles ``me_fullsearch_golden``
and ``me_ssd_golden``, the JAX device paths ``me_fullsearch_device`` and
one interpret-mode case each of the Pallas kernels.  Frames come from
``np.random.default_rng``.  Tolerance: none; the search contract is exact
(the same candidate wins, so the MV maps are equal byte for byte).
"""

import re

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


# ---- the kernels' plan and the SSD kernel's tensor-core decomposition ----

def _bounds(o, search, size):
    """Candidate range [lo, hi) of a block at origin o, as kernels.metal's
    searchExtent and scan conditions define it (written out again here)."""
    left = min(max(o + 8 - search // 2, 0), size)
    right = min(max(left + search, 0), size)
    return left, right - 16


def _covered(n_x, n_y, owners):
    """Count, over the chunks of an (n_x, n_y) window, how often each
    candidate is scored: ``owners`` lists the chunk-relative (x, y) that the
    threads of one CUDA block score in one chunk."""
    seen = np.zeros((max(n_x, 0), max(n_y, 0)), np.int64)
    for cy0 in motion.chunk_origins(n_y):
        for cx0 in motion.chunk_origins(n_x):
            for x, y in owners:
                if cx0 + x < n_x and cy0 + y < n_y:
                    seen[cx0 + x, cy0 + y] += 1
    return seen


def _sad_owners():
    return [(x, y) for tid in range(motion.THREADS)
            for x, ys in [motion.sad_thread_candidates(tid)] for y in ys]


def _ssd_owners():
    return [(x, y) for warp in range(motion.THREADS // 32)
            for lane in range(32)
            for _i, _q, x, y in motion.ssd_lane_candidates(warp, lane)]


PLAN_GEOMS = [(96, 128), (120, 200), (50, 94), (1080, 1918)]


@pytest.mark.parametrize("owners", [_sad_owners, _ssd_owners],
                         ids=["sad_register_blocking", "ssd_mma_tiles"])
@pytest.mark.parametrize("search", [16, 32, 64, 128])
def test_plan_covers_each_candidate_once(owners, search):
    """Every (macroblock, candidate) pair of the clamped windows is scored
    exactly once, at the frame edges too: the plan's windows, the chunks
    and the candidates each thread (SAD) or lane accumulator (SSD) owns."""
    owned = owners()
    assert len(owned) == len(set(owned)) == motion.CHUNK ** 2
    for h, w in PLAN_GEOMS:
        pl = motion.plan(h, w, search)
        assert pl.shape == ((h // 16) * (w // 16), len(motion.PLAN_FIELDS))
        d_lo = 8 - search // 2
        want = []
        for by in range(h // 16):
            for bx in range(w // 16):
                xlo, xhi = _bounds(16 * bx, search, w)
                ylo, yhi = _bounds(16 * by, search, h)
                want.append((16 * bx, 16 * by, xlo, ylo, max(xhi - xlo, 0),
                             max(yhi - ylo, 0), xlo - 16 * bx - d_lo,
                             ylo - 16 * by - d_lo))
        assert np.array_equal(pl, np.array(want, np.int32))
        for n_x, n_y in {(int(r[4]), int(r[5])) for r in pl}:
            assert np.all(_covered(n_x, n_y, owned) == 1), (h, w, n_x, n_y)


@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("search", [16, 20, 32, 64, 128])
def test_groups_partition_block_rows_and_fit_their_window(group, search):
    """Each CUDA block's macroblocks are consecutive in one block row, every
    macroblock is in exactly one group, and each member's chunk of
    candidates (its own window, from the chunk origin) lies inside the
    group's staged columns: offset u = xlo - xlo(first) in [0, 16 (G - 1)],
    so u + x < union_columns(G) for every chunk column x < CHUNK."""
    assert set(motion.GROUP.values()) <= {1, 2, 4}
    for h, w in PLAN_GEOMS:
        pl = motion.plan(h, w, search)
        gr = motion.groups(h, w, group)
        wb = w // 16
        members = [first + k for first, count in gr for k in range(count)]
        assert members == list(range(len(pl)))
        for first, count in gr:
            assert 1 <= count <= group and first % wb + count <= wb
            xlo0 = pl[first, 2]
            for k in range(count):
                u = pl[first + k, 2] - xlo0
                assert 0 <= u <= 16 * (group - 1)
                assert u + motion.CHUNK <= motion.union_columns(group)
                assert pl[first + k, 3] == pl[first, 3]  # one ylo, one n_y
                assert pl[first + k, 5] == pl[first, 5]


def test_geometry_mirrors_the_kernel_source():
    """``motion.GEOMETRY`` holds the values of the kernel source's constants
    of those names, in the order ``sv_motion_geometry`` reports them (which
    ``motion.build`` checks on the card)."""
    src = motion.SOURCE.read_text()
    consts = {k: int(v) for k, v in
              re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert {k: consts.get(k) for k in motion.GEOMETRY} == motion.GEOMETRY
    body = re.search(r"sv_motion_geometry\(.*?\{(.*?)\};", src, re.S).group(1)
    order = re.findall(r"k\w+", body.split("{", 1)[1])
    assert order == list(motion.GEOMETRY)
    assert motion.GEOMETRY["kPlanFields"] == motion.plan(32, 32, 16).shape[1]


def _shifted_copies(win):
    """[4, rows, 16] uint32: copy s, word k = bytes [4 k + s, 4 k + s + 4)
    of each window row, lowest byte first (zeros past the row)."""
    win = np.asarray(win, np.int64)
    padded = np.pad(win, ((0, 0), (0, 8)))
    out = np.zeros((4, win.shape[0], win.shape[1] // 4), np.int64)
    for s in range(4):
        for k in range(out.shape[2]):
            for e in range(4):
                out[s, :, k] |= padded[:, 4 * k + s + e] << (8 * e)
    return out


def _operand_a(win, warp, pair, u=0):
    """[..., 16, 32] Hankel slice A[m, 16 j + c] = win[Y + j][u + x0 + m +
    c] of window rows Y = y0 + 2 pair and Y + 1."""
    x0, y0 = motion.ssd_warp_tiles(warp)
    cols = u + x0 + torch.arange(16)[:, None] + torch.arange(16)[None, :]
    y = y0 + 2 * pair
    return torch.cat([win[..., y, :][..., cols], win[..., y + 1, :][..., cols]],
                     dim=-1)


def _operand_b(cur, kstep):
    """[..., 32, 8] band B[16 j + c, n] = cur[2 kstep + j - n][c], zero
    outside the block's 16 rows."""
    out = torch.zeros(cur.shape[:-2] + (32, 8), dtype=cur.dtype)
    for j in range(2):
        for n in range(8):
            r = 2 * kstep + j - n
            if 0 <= r < 16:
                out[..., 16 * j:16 * j + 16, n] = cur[..., r, :]
    return out


def _cross_by_tiles(cur, win):
    """[..., 48 (y), 48 (x)] sum c r of every candidate of a chunk, as the
    SSD kernel accumulates it: per warp, tile i and row pair, C_i += A @ B
    at K step pair - 4 i, in int32."""
    out = torch.zeros(win.shape[:-2] + (motion.CHUNK, motion.CHUNK),
                      dtype=torch.int32)
    for warp in range(motion.THREADS // 32):
        x0, y0 = motion.ssd_warp_tiles(warp)
        acc = [0, 0, 0]
        for pair in range(motion.SSD_PAIRS):
            a = _operand_a(win, warp, pair)
            for i in range(3):
                kstep = pair - 4 * i
                if 0 <= kstep < motion.SSD_KSTEPS:
                    acc[i] = acc[i] + a @ _operand_b(cur, kstep)
        for i in range(3):
            # C[m, n] is candidate (x0 + m, y0 + 8 i + n)
            out[..., y0 + 8 * i:y0 + 8 * i + 8, x0:x0 + 16] = \
                acc[i].transpose(-1, -2)
    return out


def _box_sq(win):
    """[..., 48 (y), 48 (x)] int32 sum r^2 over each candidate's 16 x 16
    box: row sums of 16 squares, then sums of 16 rows (running sums)."""
    sq = win * win
    c = torch.nn.functional.pad(sq.cumsum(-1), (1, 0))
    hs = c[..., 16:16 + motion.CHUNK] - c[..., :motion.CHUNK]
    r = torch.nn.functional.pad(hs.cumsum(-2), (0, 0, 1, 0))
    return (r[..., 16:16 + motion.CHUNK, :] - r[..., :motion.CHUNK, :]).to(
        torch.int32)


def _ssd_by_tiles(cur, ref, search):
    """The SSD search as the SSD kernel decomposes it (plan, chunks, the
    tensor-core cross term, the box sums, the same float32 score and
    (score, key) minimum), in plain torch: [H/16, W/16, 4] u8."""
    h, w = cur.shape
    pl = torch.from_numpy(motion.plan(h, w, search).astype(np.int64))
    ox, oy, xlo, ylo, n_x, n_y, di0, dj0 = pl.T
    _d_lo, _cost2, axis, mv_u8 = motion.tables(16, search)
    axis = torch.from_numpy(axis)
    pad = search + motion.CHUNK + 16
    refp = torch.nn.functional.pad(torch.from_numpy(ref).to(torch.int32),
                                   (0, pad, 0, pad))
    ar16 = torch.arange(16)
    curb = torch.from_numpy(cur).to(torch.int32)[
        (oy[:, None, None] + ar16[None, :, None]),
        (ox[:, None, None] + ar16[None, None, :])]
    best_s = torch.full((len(pl),), float("inf"))
    best_k = torch.full((len(pl),), 2 ** 31 - 1, dtype=torch.int64)
    ar = torch.arange(motion.CHUNK)
    arw = torch.arange(motion.CHUNK + 16)
    for cy0 in motion.chunk_origins(int(n_y.max())):
        for cx0 in motion.chunk_origins(int(n_x.max())):
            win = refp[(ylo + cy0)[:, None, None] + arw[None, :, None],
                       (xlo + cx0)[:, None, None] + arw[None, None, :]]
            partial = _box_sq(win) - 2 * _cross_by_tiles(curb, win)
            iy = cy0 + ar[None, :, None]
            ix = cx0 + ar[None, None, :]
            valid = (iy < n_y[:, None, None]) & (ix < n_x[:, None, None])
            score = ((partial.to(torch.float32) * np.float32(2.0 ** -4)
                      + axis[(dj0[:, None, None] + iy).clamp(0, len(axis) - 1)])
                     + axis[(di0[:, None, None] + ix).clamp(0, len(axis) - 1)])
            score = torch.where(valid, score, float("inf")).flatten(1)
            key = torch.where(valid, ix * n_y[:, None, None] + iy,
                              2 ** 31 - 1).flatten(1)
            s_min = score.min(dim=1).values
            k_min = torch.where(score == s_min[:, None], key,
                                2 ** 31 - 1).min(dim=1).values
            better = (s_min < best_s) | ((s_min == best_s) & (k_min < best_k))
            best_s = torch.where(better, s_min, best_s)
            best_k = torch.where(better, k_min, best_k)
    found = best_k != 2 ** 31 - 1
    ix = torch.where(found, best_k // n_y.clamp(min=1), 0)
    mvx = torch.where(found, ox - (xlo + ix), 0)
    mvy = torch.where(found, oy - (ylo + best_k - ix * n_y), 0)
    max_mv = search // 2
    lut = torch.from_numpy(mv_u8)
    r_ch = lut[mvx.clamp(-max_mv, max_mv) + max_mv]
    b_ch = lut[mvy.clamp(-max_mv, max_mv) + max_mv]
    out = torch.stack([r_ch, torch.full_like(r_ch, 128), b_ch,
                       torch.full_like(r_ch, 255)], dim=-1)
    return out.reshape(h // 16, w // 16, 4).numpy()


@pytest.mark.parametrize("geom", GEOMS + [(96, 96, 128)],
                         ids=lambda g: "x".join(map(str, g)))
def test_ssd_tensor_core_decomposition_matches_golden(geom):
    """The SSD kernel's decomposition in plain torch (Hankel window-row
    slices times the current block's band, int32 box sums of r^2, chunks
    of 48 x 48 candidates) picks the oracle's winner on every block."""
    h, w, search = geom
    cur, ref = _frames(h, w, h + w + search)
    assert np.array_equal(_ssd_by_tiles(cur, ref, search),
                          GOLDEN["ssd"](cur, ref, 16, search))


def test_ssd_tile_sums_equal_direct_sums():
    """The tiled cross term and the box sums against sum c r and sum r^2
    taken candidate by candidate, on one chunk; all-255 bytes give the
    largest sums (256 * 255^2), which int32 holds exactly."""
    rng = np.random.default_rng(4)
    for hi in (256, 255):
        win = torch.from_numpy(rng.integers(0, hi, (64, 64))).to(torch.int32)
        cur = torch.from_numpy(rng.integers(0, hi, (16, 16))).to(torch.int32)
        if hi == 255:
            win.fill_(255)
            cur.fill_(255)
        cross = _cross_by_tiles(cur, win)
        box = _box_sq(win)
        for y in range(motion.CHUNK):
            for x in range(motion.CHUNK):
                r = win[y:y + 16, x:x + 16]
                assert int(cross[y, x]) == int((cur * r).sum())
                assert int(box[y, x]) == int((r * r).sum())
        if hi == 255:
            assert int(cross.max()) == 256 * 255 ** 2 < 2 ** 31


def test_ssd_fragments_follow_the_mma_layout():
    """What each lane loads (``ssd_a_source`` from the shifted copies,
    ``ssd_b_source`` from the current block) is, element by element under
    the m16n8k32 fragment layout, the Hankel A and banded B above; and the
    accumulator each lane holds is the candidate ``ssd_lane_candidates``
    names.  Offsets u into a group's window of 4 macroblocks: 0, the
    interior step 16, and 5 and 47 (clamped windows at the frame edges
    need not start 4-aligned)."""
    rng = np.random.default_rng(8)
    union = motion.union_columns(4)
    win = rng.integers(0, 256, (64, union + 16))
    cur = rng.integers(0, 256, (16, 16))
    copies = _shifted_copies(win)
    tw, tc = torch.from_numpy(win), torch.from_numpy(cur)
    for u in (0, 5, 16, 47):
        for warp in range(motion.THREADS // 32):
            for pair in range(motion.SSD_PAIRS):
                a = _operand_a(tw, warp, pair, u)
                for lane in range(32):
                    for q in range(4):
                        s, row, word = motion.ssd_a_source(warp, lane, q,
                                                           pair, u)
                        # the kernel stages words below (union - 1) / 4 + 4
                        assert word < (union - 1) // 4 + 4
                        for e in range(4):
                            m, k = motion.mma_a_element(lane, q, e)
                            got = (int(copies[s, row, word]) >> (8 * e)) & 255
                            assert got == int(a[m, k])
    for kstep in range(motion.SSD_KSTEPS):
        b = _operand_b(tc, kstep)
        for lane in range(32):
            for reg in range(2):
                r = motion.ssd_b_source(lane, reg, kstep)
                for e in range(4):
                    k, n = motion.mma_b_element(lane, reg, e)
                    got = 0 if r is None else int(cur[r, 4 * (lane % 4) + e])
                    assert got == int(b[k, n])
    for warp in range(motion.THREADS // 32):
        x0, y0 = motion.ssd_warp_tiles(warp)
        for lane in range(32):
            for i, q, x, y in motion.ssd_lane_candidates(warp, lane):
                m, n = motion.mma_c_element(lane, q)
                assert (x, y) == (x0 + m, y0 + 8 * i + n)
