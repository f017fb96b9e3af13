"""The u8 vector emit of every motion route, and the two-stage search's
kernels as they decompose their work, on the CPU.

* The emit: every route of the port (the exhaustive search's plain version,
  which K4 and K5 share, and the refine) takes the u8 channel of a vector
  component from one float32 table, ``motion.tables``, as the JAX package's
  device routes do (``_mv_rgba``).  At searches 30, 48, 60 and 96 that table
  differs from the float64 oracles' rounding by one step for a few
  components; frames shifted onto those components hold the port to
  ``me_fullsearch_device`` there, and its decoded vectors to the oracles.
* ``_coarse_by_tiles``: ``motion_coarse_kernel``'s decomposition in plain
  torch and numpy (the group's staged rows from its first grid column, the
  per-macroblock parity, offset and band shift of ``motion.coarse_offsets``,
  the m16n8k32 tiles of every second window row against the current row's
  stride-2 band, sums of r^2 at grid positions from masked words, the
  lanes' candidates, the (score, tx, inner, ty) minimum), held against
  ``me_coarse_torch`` and the JAX coarse program.
* ``_refine_by_lanes``: ``motion_refine_kernel``'s packed-word scoring
  (four byte-shifted copies of the patch, each lane's quarter of the rows,
  byte-SIMD SAD and dot products, the quarters added), held against
  ``refine_torch``.

Frames come from ``np.random.default_rng``.  Tolerance: none; vectors and
MV maps are equal.
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
from swiftvideo_tpu_torch.ops import motion, registry

GOLDEN = {"sad": jax_motion.me_fullsearch_golden,
          "ssd": jax_motion.me_ssd_golden}
INT_MAX = 2 ** 31 - 1


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _shifted(h, w, shift, seed):
    """A random reference and the current frame that is the reference moved
    ``shift`` columns right (plus noise in [-6, 6]): a block whose window
    holds tx = ox - shift finds the vector (mvx, mvy) = (shift, 0)."""
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 256, (h, w), np.uint8)
    cur = np.roll(ref, shift, axis=1).astype(int)
    cur = np.clip(cur + rng.integers(-6, 7, cur.shape), 0, 255)
    return cur.astype(np.uint8), ref


def _noise(h, w, seed, shift=(3, -5), amp=40):
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 255, (h, w), np.uint8)
    cur = np.clip(ref.astype(int) + rng.integers(-amp, amp + 1, ref.shape),
                  0, 255).astype(np.uint8)
    return np.roll(cur, shift, axis=(0, 1)), ref


def _lattice(h, w, seed=5):
    """ref(x, y) = T[(x + y // 4) % 8, y % 16], periodic on the lattice of
    (4, -16) and (8, 0) but not (0, 16), and cur(x, y) = ref(x + 2, y - 8):
    the vectors (dx, dy) = (2, -8) and (-2, 8) tie exactly, score and cost,
    and the first in the scan (tx first) lies in grid row 16, the second
    M tile's, where the first tile holds the other."""
    table = np.random.default_rng(seed).integers(0, 256, (8, 16))
    yy, xx = np.mgrid[0:h + 8, 0:w + 2]
    big = table[(xx + yy // 4) % 8, yy % 16].astype(np.uint8)
    return big[:h, 2:w + 2], big[8:h + 8, :w]


def _decode(mv, table):
    """Vector components from a u8 channel through ``table`` (m ->
    u8 at m + max_mv; injective at these searches)."""
    max_mv = (len(table) - 1) // 2
    inv = {int(v): m - max_mv for m, v in enumerate(table)}
    assert len(inv) == len(table)
    return np.vectorize(inv.__getitem__)(mv[..., [0, 2]])


# ---- the u8 vector emit --------------------------------------------------

def _golden_table(search):
    max_mv = search // 2
    m = np.arange(-max_mv, max_mv + 1, dtype=np.float64)
    return np.clip(np.rint((m / max_mv * 0.5 + 0.5) * 255.0), 0,
                   255).astype(np.uint8)


# (search, shift): the vector component m = shift is one whose channels
# differ.  At 30 the interior windows reach |m| <= 7 only, so the left
# blocks' clamped windows (tx from 0) carry the case at m = -10.
EMIT_CASES = [(30, -10), (48, 16), (60, 20), (96, 32)]


@pytest.mark.parametrize("metric", motion.METRICS)
@pytest.mark.parametrize("search,shift", EMIT_CASES,
                         ids=lambda v: str(v))
def test_exhaustive_emit_equals_jax_device_route(search, shift, metric):
    """The shift lands the winners on a component whose float32 and
    float64 channels differ; the port equals ``me_fullsearch_device``
    there, byte for byte, and its decoded vectors equal the oracle's."""
    cur, ref = _shifted(96, 128, shift, search + shift)
    ours = motion.me_fullsearch(_t(cur), _t(ref), 16, search, metric).numpy()
    dev = np.asarray(jax_motion.me_fullsearch_device(cur, ref, 16, search,
                                                     metric=metric))
    assert np.array_equal(ours, dev)
    gold = GOLDEN[metric](cur, ref, 16, search)
    assert (ours != gold).any(), "the frame misses the differing entries"
    table = motion.tables(16, search)[3]
    assert np.array_equal(_decode(ours, table),
                          _decode(gold, _golden_table(search)))
    assert np.array_equal(ours[..., [1, 3]], gold[..., [1, 3]])


@pytest.mark.parametrize("search", [s for s, _ in EMIT_CASES] + [32, 62, 64])
def test_one_table_is_the_jax_emit(search):
    """``tables``' u8 channel is the JAX ``_mv_rgba`` of every clamped
    component (float32), and the only one the port has: the refine and
    the exhaustive routes read it.  It differs from the float64 oracles'
    at 30, 48, 60 and 96, not at 32, 62 or 64."""
    import jax.numpy as jnp
    max_mv = search // 2
    m = jnp.arange(-max_mv, max_mv + 1, dtype=jnp.float32)
    want = np.asarray(jax_motion._mv_rgba(m, m, search, jnp))[:, 0]
    got = motion.tables(16, search)[3]
    assert np.array_equal(got, want)
    assert (search in (30, 48, 60, 96)) == (not np.array_equal(
        got, _golden_table(search)))
    assert not hasattr(motion, "pyramid_mv_u8")


@pytest.mark.parametrize("name", ["me_fullsearch", "me_fullsearch_ssd"])
@pytest.mark.parametrize("shift", [16, 20])
def test_registry_routes_equal_jax_registry_on_shifted_frames(name, shift):
    """The registry runs its default search (64) on the shifted frames of
    the emit cases, both packages alike."""
    cur, ref = _shifted(96, 128, shift, 48 + shift)
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
    assert np.array_equal(ours.planes()[0].numpy(),
                          np.asarray(theirs.planes()[0]))


# ---- the coarse kernel's decomposition -------------------------------------

def _words(rows):
    """[rows, n] int64 bytes -> [rows, n // 4] little-endian words."""
    b = rows.reshape(rows.shape[0], -1, 4)
    return b[..., 0] | b[..., 1] << 8 | b[..., 2] << 16 | b[..., 3] << 24


def _dp4a_sq(v):
    return sum(((v >> (8 * e)) & 255) ** 2 for e in range(4))


def _grid_box_sums(words, group):
    """[GRID_CHUNK (grid rows), union grid columns] sums of r^2 as the
    kernel sums them: for each column pair v, row sums of 16 squares from
    byte 4 v (words v .. v + 3) and 4 v + 2 (the high half of word v, words
    v + 1 .. v + 3, the low half of word v + 4), then 16 rows from every
    second row."""
    n_u = motion.coarse_union_grid(group)
    hr = np.zeros((words.shape[0], n_u), np.int64)
    for v in range(n_u // 2):
        w = words[:, v:v + 5]
        mid = sum(_dp4a_sq(w[:, q]) for q in (1, 2, 3))
        hr[:, 2 * v] = _dp4a_sq(w[:, 0]) + mid
        hr[:, 2 * v + 1] = (_dp4a_sq(w[:, 0] & 0xFFFF0000)
                            + _dp4a_sq(w[:, 4] & 0x0000FFFF) + mid)
    c = np.concatenate([np.zeros((1, n_u), np.int64), hr.cumsum(0)])
    return np.stack([c[2 * n + 16] - c[2 * n]
                     for n in range(motion.GRID_CHUNK)])


def _band(cur_row, delta):
    """[32, 8] B[c', n] = cur_row[c' - 2 n - delta], zero outside."""
    out = np.zeros((32, 8), np.int64)
    for n in range(8):
        for c in range(16):
            out[c + 2 * n + delta, n] = cur_row[c]
    return out


def _coarse_by_tiles(cur, ref, search):
    """The coarse stage on the stride-2 grid as motion_coarse_kernel
    decomposes it: [H/16, W/16, 2] int32 raw vectors."""
    h, w = cur.shape
    group = motion.GROUP["ssd"]
    pl = motion.plan(h, w, search)
    axis = motion.tables(16, search)[2]
    n_words = motion.coarse_row_words(group)
    pad = search + 4 * n_words + 64
    refp = np.zeros((h + pad, w + pad), np.int64)
    refp[:h, :w] = ref
    out = np.zeros((len(pl), 2), np.int32)
    for first, count in motion.groups(h, w, group):
        e0, nyg, nxg_max, rows = motion.coarse_offsets(pl, first, count)
        xlo0, ylo = int(pl[first, 2]), int(pl[first, 3])
        best = [(np.inf, INT_MAX, np.inf, INT_MAX)] * count
        for cgy0 in range(0, nyg, motion.GRID_CHUNK):
            for cgx0 in range(0, nxg_max, motion.GRID_CHUNK):
                wy0, wb = ylo + 2 * cgy0, xlo0 + 2 * cgx0 + e0
                win = refp[wy0:wy0 + motion.CHUNK + 16, wb:wb + 4 * n_words]
                sq = _grid_box_sums(_words(win), group)
                for k, (e, nxg, a, delta, word) in enumerate(rows):
                    ox, oy, _xlo, _ylo, _nx, _ny, di0, dj0 = (
                        int(v) for v in pl[first + k])
                    cb = cur[oy:oy + 16, ox:ox + 16].astype(np.int64)
                    bands = [_band(cb[r], delta) for r in range(16)]
                    gx_n, gy_n = nxg - cgx0, nyg - cgy0
                    for mt in (0, 1):
                        if gx_n <= 0 or (mt == 1 and gy_n <= 16):
                            continue
                        acc = []
                        for j in range(3):
                            c = np.zeros((16, 8), np.int64)
                            for r in range(16):
                                ys = 2 * (8 * mt + np.arange(16)) + r
                                xs = 4 * word + 16 * j + np.arange(32)
                                c += win[ys][:, xs] @ bands[r]
                            acc.append(c)
                        for lane in range(32):
                            for j, q, gy, gx in motion.coarse_lane_candidates(
                                    mt, lane):
                                if not (gx < gx_n and gy < gy_n):
                                    continue
                                m, n = motion.mma_c_element(lane, q)
                                u = (a >> 1) + gx
                                partial = int(sq[gy, u]) - 2 * int(acc[j][m, n])
                                ix = e + 2 * (cgx0 + gx)
                                iy = 2 * (cgy0 + gy)
                                inner = (np.float32(partial) * np.float32(0.0625)
                                         + axis[dj0 + iy])
                                score = inner + axis[di0 + ix]
                                best[k] = min(best[k], (score, ix, inner, iy))
        for k in range(count):
            _s, ix, _i, iy = best[k]
            if ix != INT_MAX:
                ox, oy, xlo, ylo_k = (int(v) for v in pl[first + k, :4])
                out[first + k] = (ox - (xlo + ix), oy - (ylo_k + iy))
    return out.reshape(h // 16, w // 16, 2)


def _jax_coarse(cur, ref, search):
    h, w = cur.shape
    program = jax_motion._me_mxu_program(h, w, 16, search, grouped=True,
                                         raw=True, stride=2)
    return np.stack([np.asarray(a) for a in program(cur, ref)], axis=-1)


COARSE_FRAMES = {
    "noise": lambda h, w, s: _noise(h, w, h * w + s),
    "smooth": lambda h, w, s: _noise(h, w, s, shift=(5, 3), amp=2),
    "lattice ties": lambda h, w, s: _lattice(h, w),
}


@pytest.mark.parametrize("content", list(COARSE_FRAMES))
@pytest.mark.parametrize("geom", [(96, 128, 64), (144, 192, 62),
                                  (96, 192, 60)],
                         ids=lambda g: "x".join(map(str, g)))
def test_coarse_decomposition_equals_plain_and_jax(geom, content):
    """96 x 128 at 64: the top two and the bottom block rows and the left
    blocks clamp; search 62 puts the left-clamped blocks' grid on odd window
    columns (d_lo = -23) and 60 gives them a band shift of 2 bytes.  Every
    block equals ``me_coarse_torch`` and the JAX grouped program."""
    h, w, search = geom
    cur, ref = COARSE_FRAMES[content](h, w, search)
    ours = _coarse_by_tiles(cur, ref, search)
    plain = motion.me_coarse_torch(_t(cur), _t(ref), 16, search, 2).numpy()
    assert np.array_equal(ours, plain)
    assert np.array_equal(ours, _jax_coarse(cur, ref, search))


@pytest.mark.parametrize("geom", [(96, 128, 30), (96, 160, 44)],
                         ids=lambda g: "x".join(map(str, g)))
def test_coarse_decomposition_small_windows(geom):
    """Searches 30 and 44: windows of 7 and 14 grid columns, one N tile or
    two, and the second M tile idle.  (Windows of several chunks, search
    128, take thousands of whole-frame steps in the plain version; the
    chunks' index maps are covered below, the kernel on the card.)"""
    h, w, search = geom
    cur, ref = _noise(h, w, h + w + search)
    assert np.array_equal(_coarse_by_tiles(cur, ref, search),
                          motion.me_coarse_torch(_t(cur), _t(ref), 16, search,
                                                 2).numpy())


PLAN_GEOMS = [(96, 128), (120, 200), (1080, 1920), (2160, 3840), (144, 192)]


@pytest.mark.parametrize("search", [16, 30, 44, 60, 62, 64, 128])
def test_coarse_lanes_cover_each_grid_candidate_once(search):
    """Over the chunks, the two warps of a macroblock and their lanes'
    candidates score every grid candidate of every clamped window once and
    nothing else; the offsets stay inside the staged row."""
    group = motion.GROUP["ssd"]
    owned = [(gy, gx) for mt in (0, 1) for lane in range(32)
             for _j, _q, gy, gx in motion.coarse_lane_candidates(mt, lane)]
    assert sorted(owned) == [(y, x) for y in range(motion.GRID_CHUNK)
                             for x in range(motion.GRID_CHUNK)]
    n_words = motion.coarse_row_words(group)
    d_lo = 8 - search // 2
    seen = set()  # the candidate sets, by what they depend on
    for h, w in PLAN_GEOMS:
        pl = motion.plan(h, w, search)
        for first, count in motion.groups(h, w, group):
            e0, nyg, nxg_max, rows = motion.coarse_offsets(pl, first, count)
            for k, (e, nxg, a, delta, word) in enumerate(rows):
                ox, _oy, xlo, _ylo, n_x, n_y, _di0, _dj0 = pl[first + k]
                assert 0 <= a <= 16 * (group - 1) and a % 2 == 0
                assert delta in (0, 2) and word + 15 < n_words
                # its last grid column's box sum reads 5 words from that
                # column's word, inside the union's grid columns
                u = (a >> 1) + motion.GRID_CHUNK - 1
                assert u < motion.coarse_union_grid(group)
                assert (u >> 1) + 4 < n_words
                seen.add((int(n_x), int(n_y), int(xlo - ox - d_lo) & 1, e,
                          nxg, nyg, nxg_max))
    for n_x, n_y, parity, e, nxg, nyg, nxg_max in seen:
        want = {(ix, iy) for ix in range(n_x) if (ix + parity) % 2 == 0
                for iy in range(0, n_y, 2)}
        got = {(e + 2 * (cgx0 + gx), 2 * (cgy0 + gy))
               for cgy0 in range(0, nyg, motion.GRID_CHUNK)
               for cgx0 in range(0, nxg_max, motion.GRID_CHUNK)
               for gy, gx in owned if cgx0 + gx < nxg and cgy0 + gy < nyg}
        assert got == want, (search, n_x, n_y, parity)


def test_coarse_fragments_follow_the_mma_layout():
    """What each lane loads (``coarse_a_source`` from the staged words,
    ``coarse_b_source`` from the padded current rows) is, element by element under
    the m16n8k32 fragment layout, the tiles ``_coarse_by_tiles`` multiplies:
    A[m, c'] = win[2 (8 mt + m) + r][4 word + 16 j + c'] and B[c', n] =
    cur[r][c' - 2 n - delta], for both band shifts and every first word a
    group's macroblock can have."""
    rng = np.random.default_rng(8)
    n_words = motion.coarse_row_words(motion.GROUP["ssd"])
    win = rng.integers(0, 256, (motion.CHUNK + 16, 4 * n_words))
    words = _words(win)
    cur = rng.integers(0, 256, (16, 16))
    for word in range(0, n_words - 15):
        for mt in (0, 1):
            for r in (0, 7, 15):
                for j in range(3):
                    ys = 2 * (8 * mt + np.arange(16)) + r
                    a = win[ys][:, 4 * word + 16 * j + np.arange(32)]
                    for lane in range(32):
                        for q in range(4):
                            row, wd = motion.coarse_a_source(lane, q, r, j, mt,
                                                             word)
                            for e in range(4):
                                m, k = motion.mma_a_element(lane, q, e)
                                assert (int(words[row, wd]) >> (8 * e)) & 255 \
                                    == a[m, k]
    # the padded current rows: word w of plane s = row bytes [4 w + 2 s -
    # 16, 4 w + 2 s - 12), zero outside the row
    padded = np.zeros((16, 16 + 16 + 20), np.int64)
    padded[:, 16:32] = cur
    planes = np.stack([_words(padded[:, 2 * s:2 * s + 4 * motion.COARSE_CUR_WORDS])
                       for s in (0, 1)])
    for delta in (0, 2):
        for r in range(16):
            b = _band(cur[r], delta)
            for lane in range(32):
                for reg in range(2):
                    plane, wd = motion.coarse_b_source(lane, reg, delta)
                    assert 0 <= wd < motion.COARSE_CUR_WORDS
                    for e in range(4):
                        k, n = motion.mma_b_element(lane, reg, e)
                        assert (int(planes[plane, r, wd]) >> (8 * e)) & 255 \
                            == b[k, n]


# ---- the refine kernel's packed-word scoring --------------------------------

def _refine_by_lanes(cur, ref, raw, search, refine, metric):
    """The refine stage as motion_refine_kernel scores it: the patch's rows
    as words from its first column, four byte-shifted copies, lane 4 c + q taking rows
    4 q .. 4 q + 3 of candidate 8 i + c in round i (vabsdiff4, or dp4a for
    r^2 and c r), the quarters' sums added, the float32 score, the (score,
    s) minimum.  [H/16, W/16, 4] u8."""
    h, w = cur.shape
    hb, wb = h // 16, w // 16
    win, n_off = 16 + 2 * refine, 2 * refine + 1
    n_s = n_off * n_off
    kw = ((n_off - 1) >> 2) + 4
    pl = motion.plan(h, w, search)
    _d_lo, cost2, axis, lut = motion.tables(16, search)
    n_d = len(axis)
    flat = np.zeros(h * w + 64, np.int64)
    flat[:h * w] = ref.reshape(-1)
    rw = 4 * ((kw + 4) >> 2)   # words of a staged patch row
    out = np.zeros((hb * wb, 4), np.uint8)
    max_mv = search // 2
    for mb, (ox, oy, xlo, ylo, n_x, n_y, di0, dj0) in enumerate(pl.tolist()):
        gy0 = min(max(oy - int(raw[mb // wb, mb % wb, 1]) - refine, 0), h - win)
        gx0 = min(max(ox - int(raw[mb // wb, mb % wb, 0]) - refine, 0), w - win)
        copies = np.zeros((4, win, kw), np.int64)
        for r in range(win):
            a = (gy0 + r) * w + gx0
            row = _words(flat[a:a + 4 * rw][None])[0]   # from the patch's column
            for c in range(kw):
                pair = row[c] | row[c + 1] << 32
                for sh in range(4):
                    copies[sh, r, c] = (pair >> (8 * sh)) & 0xFFFFFFFF
        cw = _words(cur[oy:oy + 16, ox:ox + 16].astype(np.int64))
        best = (np.inf, INT_MAX)
        for rnd in range((n_s + 7) // 8):
            parts = {}
            for lane in range(32):
                s, rows = motion.refine_lane_candidate(lane, rnd, refine)
                ddx, ddy = divmod(s, n_off)
                ty, tx = gy0 + ddy, gx0 + ddx
                if not (s < n_s and ylo <= ty < ylo + n_y
                        and xlo <= tx < xlo + n_x):
                    continue
                part = 0
                for row in rows:
                    for q in range(4):
                        v = int(copies[ddx & 3, ddy + row, (ddx >> 2) + q])
                        c = int(cw[row, q])
                        for e in range(4):
                            pv, cv = (v >> 8 * e) & 255, (c >> 8 * e) & 255
                            part += (abs(cv - pv) if metric == "sad"
                                     else pv * pv - 2 * cv * pv)
                parts[s] = parts.get(s, 0) + part
            for s, part in parts.items():
                ddx, ddy = divmod(s, n_off)
                ix, iy = gx0 + ddx - xlo + di0, gy0 + ddy - ylo + dj0
                if metric == "sad":
                    score = cost2[ix, iy] + np.float32(part) * np.float32(
                        256.0 / 255.0)
                else:
                    score = (np.float32(part) * np.float32(0.0625)
                             + axis[iy]) + axis[ix]
                best = min(best, (score, s))
        mv = (0, 0)
        if best[1] != INT_MAX:
            ddx, ddy = divmod(best[1], n_off)
            mv = (ox - (gx0 + ddx), oy - (gy0 + ddy))
        out[mb] = (lut[min(max(mv[0], -max_mv), max_mv) + max_mv], 128,
                   lut[min(max(mv[1], -max_mv), max_mv) + max_mv], 255)
    assert n_d == cost2.shape[0]
    return out.reshape(hb, wb, 4)


@pytest.mark.parametrize("refine", [1, 2])
@pytest.mark.parametrize("metric", motion.METRICS)
@pytest.mark.parametrize("geom", [(96, 128, 64), (96, 128, 60),
                                  (144, 192, 62)],
                         ids=lambda g: "x".join(map(str, g)))
def test_refine_lanes_equal_plain(geom, metric, refine):
    """Around the coarse vectors, and around vectors that push the patch
    against every frame edge (its clamp) and out of the window (left out,
    or the zero vector when no candidate is left)."""
    h, w, search = geom
    cur, ref = _noise(h, w, h + w + search + refine)
    raw = motion.me_coarse_torch(_t(cur), _t(ref), 16, search, 2)
    wild = torch.from_numpy(np.random.default_rng(refine).integers(
        -search, search + 1, raw.shape)).to(torch.int32)
    for vectors in (raw, wild):
        ours = _refine_by_lanes(cur, ref, vectors.numpy(), search, refine,
                                metric)
        plain = motion.refine_torch(_t(cur), _t(ref), vectors, 16, search,
                                    refine, metric).numpy()
        assert np.array_equal(ours, plain)
