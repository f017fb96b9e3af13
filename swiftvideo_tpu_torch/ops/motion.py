"""Motion estimation: full search over 16x16 blocks, SAD or SSD score.

Reference semantics: the Metal ``me_fullsearch`` kernel
(kernels.metal:130-267), as ported by ``swiftvideo_tpu/ops/motion.py``.
For each block of the current frame every candidate position in the
block's clamped search window of the reference frame is scored, the first
strict minimum in (tx outer, ty inner) scan order wins, and the winning
vector comes back as an RGBA map at block resolution:
``(mv.x / (search/2) * 0.5 + 0.5, 0.5, mv.y / (search/2) * 0.5 + 0.5, 1)``.

Two scores, both exact over integers:

* ``sad``: ``f32(cost2(mv) + f32(f32(SAD) * 256/255))``, SAD the exact
  integer sum of |cur - ref| (the reference-parity metric);
* ``ssd``: ``f32(f32(f32(partial) * 2^-4 + cy(mv.y)) + cx(mv.x))`` with
  ``partial = sum(r^2) - 2 sum(c r)``, which differs from the block's SSD by
  the constant ``sum(c^2)`` (the JAX package's documented speed variant).

The MV-cost tables are built on the host in float64 and rounded to
float32, as the JAX package builds them; the kernel does not evaluate
``log2``.  Every route emits the u8 vector channel from one float32 table
(``tables``), as the JAX package's device routes emit it (``_mv_rgba``);
the float64 oracles round some components of searches 30, 48, 60, 96 and
others one step apart.  ``me_fullsearch`` launches a kernel of
``csrc/motion_search.cu`` for CUDA tensors (``motion_sad_kernel`` and
``motion_ssd_kernel`` replace the TPU kernels
``motion.py::_me_pallas_program`` and ``::_me_ssd_pallas_program``) and
takes the plain version for CPU tensors.  ``launches`` counts kernel
launches, ``route_launches`` the launches of each kernel; each launch is
made by ``nvcc.launch`` (``SIGNATURES`` declares the C entries), and while
the recorder (``core/spans.py``) is on its ctypes call is a
``motion.launch`` span.

``me_fullsearch_pyramid`` is the two-stage search of the JAX package's
``motion.py::me_fullsearch_pyramid``: a coarse SSD search over a stride-2
candidate grid (``motion_coarse_kernel`` on the card, which stages and
scores the grid alone, in place of the JAX package's ``_me_mxu_program``;
the stride-1 grid is ``motion_ssd_kernel``'s coarse mode), then an exact
re-score of the ``(2 refine + 1)^2`` candidates around each coarse pick with
the SSD or SAD score (``motion_refine_kernel`` on the card: the same stage
as torch ops, ``refine_torch``, took about 20 times the coarse launch's
device time on an H100, ``chip_smoke.py`` phase 17).  It is not exhaustive,
so it is held to the JAX pyramid, not to the oracles.

The kernels' host-side arithmetic lives here, where the CPU tests reach
it: ``plan`` (one row per macroblock: origin, clamped window, candidate
counts, cost-table offsets; the kernels read it), the chunking of a
window into ``CHUNK`` x ``CHUNK`` candidates, the candidates each SAD
thread and each SSD lane owns, the SSD kernel's tensor-core operand
layout (``mma_*`` and ``ssd_*_source``) and the coarse kernel's
(``coarse_*``).
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from . import nvcc

SOURCE = nvcc.CSRC / "motion_search.cu"
METRICS = ("sad", "ssd")
KERNELS = {"sad": "motion_sad_kernel", "ssd": "motion_ssd_kernel"}
# the pyramid's two launches, by their launch counts: the coarse stage on
# the stride-2 grid (motion_coarse_kernel<4>) or, when no group size divides
# the block columns, on the stride-1 grid (motion_ssd_kernel<4, true>), and
# the refine kernel
COARSE_KERNEL = "motion_coarse_kernel"
DENSE_COARSE_KERNEL = "motion_ssd_kernel (coarse)"
COARSE_KERNELS = {2: COARSE_KERNEL, 1: DENSE_COARSE_KERNEL}
REFINE_KERNEL = "motion_refine_kernel"
# the pyramid's coarse stage: the first of these that divides the block
# columns makes it the stride-2 grid, none the stride-1 (exhaustive) grid
PYRAMID_GROUPS = (8, 6, 5, 4, 3, 2)
KERNEL_BLOCK = 16     # the kernels' macroblock edge
# the kernels' geometry (csrc/motion_search.cu, the k* constants of
# GEOMETRY; build() checks the library's against it)
CHUNK = 48            # candidates per axis of one staged window chunk
THREADS = 192         # threads of a CUDA block
SAD_RUN = 12          # candidate rows of one SAD thread
SSD_WARP_ROWS = 24    # candidate rows of one SSD warp: 3 tiles of 8
SSD_PAIRS = (SSD_WARP_ROWS + KERNEL_BLOCK) // 2  # window row pairs it reads
SSD_KSTEPS = 12       # row pairs (k = 32 steps) of one tile's K
GRID_CHUNK = 24       # grid candidates per axis of a coarse-kernel chunk
COARSE_CUR_WORDS = 12  # words of a zero-padded current row (coarse kernel)
PLAN_FIELDS = ("ox", "oy", "xlo", "ylo", "n_x", "n_y", "di0", "dj0")
# macroblocks of one block row that a CUDA block searches together, sharing
# one staged window (kSadGroup and kSsdGroup of the kernels)
GROUP = {"sad": 2, "ssd": 4}
# the kernels' constants, by name, in the order sv_motion_geometry reports
GEOMETRY = {"kBlock": KERNEL_BLOCK, "kChunk": CHUNK, "kThreads": THREADS,
            "kSadRun": SAD_RUN, "kYHalf": SSD_WARP_ROWS,
            "kKSteps": SSD_KSTEPS, "kPlanFields": len(PLAN_FIELDS),
            "kSadGroup": GROUP["sad"], "kSsdGroup": GROUP["ssd"],
            "kGridChunk": GRID_CHUNK, "kCurWords": COARSE_CUR_WORDS}

# kernel launches since import, in all and by kernel name; plain integers so
# a run can show that its searches went through the kernels
launches = 0
route_launches = {name: 0 for name in (*KERNELS.values(), COARSE_KERNEL,
                                        DENSE_COARSE_KERNEL, REFINE_KERNEL)}
_LAMBDA = 4.0
_QPEX = 4.0
_SAD_SCALE = np.float32(256.0 / 255.0)   # integer SAD -> UNORM*256 units
_SSD_SCALE = np.float32(2.0 ** -4)       # integer partial -> score units


def _comp(v):
    """One axis of deltaCost2 (kernels.metal:138-145), float64."""
    v = np.asarray(v, np.float64)
    return _LAMBDA * (np.log2(np.abs(v) + 1.0) * 2.0 + 0.718 + (v != 0)) + 0.5


def search_bounds(o, block: int, search: int, size: int):
    """Candidate t range [lo, hi) of blocks at origins ``o``
    (kernels.metal searchExtent + scan conditions)."""
    left = np.clip(np.asarray(o) + block // 2 - search // 2, 0, size)
    right = np.clip(left + search, 0, size)
    return left, right - block


@lru_cache(maxsize=16)
def tables(block: int, search: int) -> Tuple[int, np.ndarray, np.ndarray,
                                             np.ndarray]:
    """(d_lo, cost2 [n_d, n_d], axis [n_d], mv_u8 [2*max_mv + 1]).

    Global displacements d = t - o run over [d_lo, search - block - 1];
    tables are indexed by d - d_lo.  ``cost2[i, j]`` is the SAD score's
    deltaCost2 of mv = (-d_i, -d_j); ``axis[i]`` is the SSD score's
    per-axis half (its cx and cy).  ``mv_u8[m + max_mv]`` is the u8
    channel of a clamped vector component m, half-to-even rint in float32
    as the JAX package's device routes compute it (``_mv_rgba``); the
    float64 oracles differ by one step for some components (at searches
    30, 48, 60 and 96 among others)."""
    d_lo = block // 2 - search // 2
    n_d = max(search - block - d_lo, 1)
    comp = _comp(-(d_lo + np.arange(n_d, dtype=np.float64)))
    cost2 = (_QPEX * (comp[:, None] + comp[None, :])).astype(np.float32)
    axis = (_QPEX * comp).astype(np.float32)
    max_mv = search // 2
    m = np.arange(-max_mv, max_mv + 1).astype(np.float32)
    n = m / np.float32(max_mv) * np.float32(0.5) + np.float32(0.5)
    mv_u8 = np.clip(np.rint(n * np.float32(255.0)), 0, 255).astype(np.uint8)
    return d_lo, cost2, axis, mv_u8


@lru_cache(maxsize=16)
def plan(h: int, w: int, search: int, block: int = KERNEL_BLOCK) -> np.ndarray:
    """[h // block * (w // block), 8] int32, one row per macroblock in
    row-major order (``PLAN_FIELDS``): its origin (ox, oy), its clamped
    window's first candidate (xlo, ylo), the candidate counts (n_x, n_y;
    0 for an empty window) and the cost-table indices of its first
    candidate, di0 = xlo - ox - d_lo and dj0 = ylo - oy - d_lo.  A CUDA
    block reads its row; candidate (ix, iy) has key ix * n_y + iy."""
    hb, wb = h // block, w // block
    d_lo = block // 2 - search // 2
    ox = np.arange(wb) * block
    oy = np.arange(hb) * block
    xlo, xhi = search_bounds(ox, block, search, w)
    ylo, yhi = search_bounds(oy, block, search, h)
    cols = [ox[None, :], oy[:, None], xlo[None, :], ylo[:, None],
            np.maximum(xhi - xlo, 0)[None, :], np.maximum(yhi - ylo, 0)[:, None],
            (xlo - ox - d_lo)[None, :], (ylo - oy - d_lo)[:, None]]
    out = np.stack([np.broadcast_to(c, (hb, wb)) for c in cols], axis=-1)
    return np.ascontiguousarray(out.reshape(-1, len(PLAN_FIELDS)), np.int32)


@lru_cache(maxsize=16)
def groups(h: int, w: int, group: int, block: int = KERNEL_BLOCK) -> np.ndarray:
    """[n_groups, 2] int32 (first macroblock, count): runs of at most
    ``group`` consecutive macroblocks of one block row, one CUDA block
    each.  Their windows start at most ``block`` columns apart (a clamped
    window moves by at most its block's step), so one chunk of each lies
    in ``union_columns(group)`` columns of the group's window, from the
    first macroblock's ``xlo`` plus the chunk's origin."""
    hb, wb = h // block, w // block
    firsts = np.arange(0, wb, group)
    row = np.stack([firsts, np.minimum(group, wb - firsts)], axis=-1)
    out = np.concatenate([row + [by * wb, 0] for by in range(hb)]) if hb else \
        np.zeros((0, 2), np.int64)
    return np.ascontiguousarray(out, np.int32)


def union_columns(group: int) -> int:
    """Candidate columns of a group's staged chunk."""
    return CHUNK + KERNEL_BLOCK * (group - 1)


def chunk_origins(n: int) -> range:
    """First candidate index of each chunk along an axis of ``n``
    candidates: a kernel stages and searches one CHUNK x CHUNK chunk of its
    window at a time."""
    return range(0, n, CHUNK)


def sad_thread_candidates(tid: int) -> Tuple[int, range]:
    """(column, rows) of the candidates of a chunk that SAD thread ``tid``
    scores: one column and a run of SAD_RUN rows."""
    return tid % CHUNK, range(tid // CHUNK * SAD_RUN,
                              (tid // CHUNK + 1) * SAD_RUN)


# mma.sync m16n8k32 u8 fragments (PTX ISA, "Matrix fragments for
# mma.m16n8k32"): lane = 4 g + t.  A (16 x 32, row-major): register q holds
# row g + 8 (q & 1), columns 16 (q >> 1) + 4 t + [0, 4), byte e the lowest
# first.  B (32 x 8, column-major): register b holds rows 16 b + 4 t +
# [0, 4) of column g.  C (16 x 8, s32): register q is row g + 8 (q >> 1),
# column 2 t + (q & 1).
def mma_a_element(lane: int, q: int, e: int) -> Tuple[int, int]:
    return lane // 4 + 8 * (q & 1), 16 * (q >> 1) + 4 * (lane % 4) + e


def mma_b_element(lane: int, b: int, e: int) -> Tuple[int, int]:
    return 16 * b + 4 * (lane % 4) + e, lane // 4


def mma_c_element(lane: int, q: int) -> Tuple[int, int]:
    return lane // 4 + 8 * (q >> 1), 2 * (lane % 4) + (q & 1)


def ssd_warp_tiles(warp: int) -> Tuple[int, int]:
    """(first candidate column, first candidate row) of SSD warp ``warp``
    in its chunk: 16 columns (mma M) by SSD_WARP_ROWS rows (3 tiles of 8,
    mma N)."""
    return 16 * (warp % (CHUNK // 16)), SSD_WARP_ROWS * (warp // (CHUNK // 16))


def ssd_lane_candidates(warp: int, lane: int):
    """[(tile, register, x, y)]: the chunk candidates whose cross term
    accumulator (tile, register) of ``lane`` in SSD warp ``warp`` holds."""
    x0, y0 = ssd_warp_tiles(warp)
    out = []
    for i in range(SSD_WARP_ROWS // 8):
        for q in range(4):
            m, n = mma_c_element(lane, q)
            out.append((i, q, x0 + m, y0 + 8 * i + n))
    return out


def ssd_a_source(warp: int, lane: int, q: int, pair: int,
                 u: int = 0) -> Tuple[int, int, int]:
    """(copy, window row, word) that A register ``q`` of ``lane`` loads at
    row pair ``pair``, for a macroblock whose chunk starts ``u`` columns
    into its group's window: copy s holds each window row shifted left by
    s bytes, so word k of copy s is bytes [4 k + s, 4 k + s + 4).  The
    fragment is the Hankel slice A[m, 16 j + c] = win[Y + j][u + x0 + m + c]
    of rows Y = y0 + 2 pair and Y + 1."""
    x0, y0 = ssd_warp_tiles(warp)
    g, t = lane // 4, lane % 4
    start = u + x0 + g + 8 * (q & 1) + 4 * t   # the byte of element e = 0
    return start % 4, y0 + 2 * pair + (q >> 1), start // 4


def ssd_b_source(lane: int, b: int, kstep: int):
    """The current block's row whose word ``lane % 4`` B register ``b`` of
    ``lane`` holds at K step ``kstep``, or None for a zero: the band
    B[16 j + c, n] = cur[2 kstep + j - n][c], inside the block's 16 rows."""
    r = 2 * kstep + b - lane // 4
    return r if 0 <= r < KERNEL_BLOCK else None


# The coarse kernel (motion_coarse_kernel<G>) scores the stride-2 grid alone.
# Grid column m of a macroblock is its window candidate ix = e + 2 m (e =
# di0 & 1, so that tx - ox - d_lo is even), grid row n is iy = 2 n.  A chunk
# is GRID_CHUNK x GRID_CHUNK grid candidates; each staged row holds
# coarse_row_words(G) words from the group's first grid column.  Two warps a
# macroblock: M tile mt holds grid rows 8 mt + [0, 16), N tile j grid
# columns 8 j + [0, 8), and K step r is current row r against 32 staged
# bytes.
def coarse_union_grid(group: int) -> int:
    """Grid columns of a group's chunk: its macroblocks' first grid columns
    lie at most 8 (group - 1) grid columns apart."""
    return GRID_CHUNK + 8 * (group - 1)


def coarse_row_words(group: int) -> int:
    """Words of a staged row that an A fragment or a box sum may read."""
    return 4 * (group - 1) + 16


def coarse_offsets(pl: np.ndarray, first: int, count: int):
    """The coarse kernel's arithmetic for the group of plan rows ``first``
    .. ``first + count - 1``: (e0, nyg, nxg_max, rows), one row (e, nxg, a,
    delta, word) per macroblock: e the parity of its grid's ix, nxg its
    grid columns, a the byte of its first grid column in the staged row
    (even; the row starts at the first macroblock's), delta = a & 3 the
    shift of its B band and word = a >> 2 its first A word.  nyg: the
    group's grid rows (one ylo and n_y for the group)."""
    rows = [tuple(int(v) for v in pl[first + k]) for k in range(count)]
    xlo0, n_y, di00 = rows[0][2], rows[0][5], rows[0][6]
    e0 = di00 & 1
    out = []
    for _ox, _oy, xlo, _ylo, n_x, _n_y, di0, _dj0 in rows:
        e = di0 & 1
        a = xlo - xlo0 + e - e0
        out.append((e, (n_x - e + 1) >> 1, a, a & 3, a >> 2))
    return e0, (n_y + 1) >> 1, max(r[1] for r in out), out


def coarse_a_source(lane: int, q: int, r: int, j: int, mt: int,
                    word: int) -> Tuple[int, int]:
    """(staged row, word) that A register ``q`` of ``lane`` loads for N tile
    ``j`` at K step ``r`` in M tile ``mt``, for a macroblock whose first A
    word is ``word``: A[m, c'] = win[2 (8 mt + m) + r][4 word + 16 j + c']."""
    g, t = lane // 4, lane % 4
    return (2 * (8 * mt + g + 8 * (q & 1)) + r,
            word + 4 * j + 4 * (q >> 1) + t)


def coarse_b_source(lane: int, b: int, delta: int) -> Tuple[int, int]:
    """(plane, word) of the padded current row that B register ``b`` of
    ``lane`` is: B[c', n] = cur[r][c' - 2 n - delta] for c' = 16 b + 4
    (lane % 4) + e and n = lane // 4 starts at row byte o = 16 b + 4 (lane
    % 4) - 2 (lane // 4) - delta, and word w of plane s holds row bytes
    [4 w + 2 s - 16, 4 w + 2 s - 12), zero outside the row."""
    o = 16 * b + 4 * (lane % 4) - 2 * (lane // 4) - delta
    return (o >> 1) & 1, (o + 16) >> 2


def coarse_lane_candidates(mt: int, lane: int):
    """[(tile j, register q, grid row, grid column)]: the chunk candidates
    whose cross term accumulator (j, q) of ``lane`` holds in M tile ``mt``
    and which its warp scores (tile 1 leaves grid rows 8 .. 15 to tile 0)."""
    out = []
    for j in range(3):
        for q in range(4):
            if mt == 1 and q < 2:
                continue
            m, n = mma_c_element(lane, q)
            out.append((j, q, 8 * mt + m, 8 * j + n))
    return out


def refine_lane_candidate(lane: int, rnd: int, refine: int):
    """(candidate s, rows) that ``lane`` of the refine kernel scores in
    round ``rnd``: s = 8 rnd + lane // 4 in tx-major order (ddx = s //
    (2 refine + 1)), rows 4 (lane % 4) .. + 3 of the block; s may pass the
    last candidate (then the lane scores nothing)."""
    return 8 * rnd + lane // 4, range(4 * (lane % 4), 4 * (lane % 4) + 4)


def _check(cur, ref, block: int, search: int, metric: str) -> torch.device:
    for t in (cur, ref):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"frames must be tensors, got {type(t)}")
        if t.dtype != torch.uint8 or t.dim() != 2:
            raise TypeError(f"frames must be [H, W] uint8, got {t.dtype} "
                            f"{tuple(t.shape)}")
    if cur.shape != ref.shape:
        raise ValueError(f"frame shapes differ: {tuple(cur.shape)} vs "
                         f"{tuple(ref.shape)}")
    if cur.device != ref.device:
        raise ValueError(f"frames on {cur.device} and {ref.device}")
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}")
    if block < 1 or search < 2:
        raise ValueError(f"block {block} / search {search}")
    if metric == "ssd" and block * block * 255 * 255 >= 2 ** 24:
        raise ValueError("the ssd score needs block <= 16 to stay exact in "
                         "float32")
    return cur.device


def _on_card(cur, ref, block: int, search: int, metric: str) -> bool:
    """True for CUDA frames (the kernels), False for CPU ones (the plain
    versions); raises for any other device."""
    dev = _check(cur, ref, block, search, metric)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"motion search runs on cuda, not {dev}")
    return dev.type == "cuda"


def _check_kernel_frames(cur, ref, block: int) -> None:
    if block != KERNEL_BLOCK:
        raise ValueError(f"the motion kernel takes {KERNEL_BLOCK}x"
                         f"{KERNEL_BLOCK} blocks, not {block}")
    if not (cur.is_contiguous() and ref.is_contiguous()):
        raise ValueError("frames must be contiguous")


def me_fullsearch_torch(cur: torch.Tensor, ref: torch.Tensor, block: int = 16,
                        search: int = 64, metric: str = "sad") -> torch.Tensor:
    """Plain version: one whole-frame step per global displacement (dx
    outer, dy inner), each block keeping its first strict minimum over the
    displacements inside its own clamped window.  The shape of the JAX
    package's XLA scan (``motion.py::_me_program``)."""
    dev = _check(cur, ref, block, search, metric)
    h, w = cur.shape
    hb, wb = h // block, w // block
    d_lo, cost2, axis, mv_u8 = tables(block, search)
    n_d = search - block - d_lo
    ox = np.arange(wb) * block
    oy = np.arange(hb) * block
    xlo, xhi = search_bounds(ox, block, search, w)
    ylo, yhi = search_bounds(oy, block, search, h)
    c = cur[:hb * block, :wb * block].to(torch.int32)
    pad = search
    refp = torch.nn.functional.pad(ref.to(torch.int32), (pad, pad, pad, pad))
    scale = torch.tensor(_SAD_SCALE if metric == "sad" else _SSD_SCALE,
                         device=dev)
    ds = d_lo + np.arange(max(n_d, 0))
    vx_all = torch.from_numpy((ox[None, :] + ds[:, None] >= xlo)
                              & (ox[None, :] + ds[:, None] < xhi)).to(dev)
    vy_all = torch.from_numpy((oy[None, :] + ds[:, None] >= ylo)
                              & (oy[None, :] + ds[:, None] < yhi)).to(dev)
    best = torch.full((hb, wb), float("inf"), dtype=torch.float32, device=dev)
    best_dx = torch.zeros((hb, wb), dtype=torch.int64, device=dev)
    best_dy = torch.zeros((hb, wb), dtype=torch.int64, device=dev)

    def block_sum(x):
        return x.reshape(hb, block, wb, block).sum(dim=(1, 3))

    for i, dx in enumerate(ds.tolist()):
        r_cols = refp[:, pad + dx:pad + dx + wb * block]
        for j, dy in enumerate(ds.tolist()):
            valid = vy_all[j][:, None] & vx_all[i][None, :]
            r = r_cols[pad + dy:pad + dy + hb * block]
            if metric == "sad":
                dist = block_sum((c - r).abs()).to(torch.float32)
                score = dist * scale + float(cost2[i, j])
            else:
                partial = block_sum(r * r) - 2 * block_sum(c * r)
                score = ((partial.to(torch.float32) * scale
                          + float(axis[j])) + float(axis[i]))
            better = valid & (score < best)
            best = torch.where(better, score, best)
            best_dx = torch.where(better, dx, best_dx)
            best_dy = torch.where(better, dy, best_dy)
    max_mv = search // 2
    lut = torch.from_numpy(mv_u8).to(dev)
    r_ch = lut[torch.clamp(-best_dx, -max_mv, max_mv) + max_mv]
    b_ch = lut[torch.clamp(-best_dy, -max_mv, max_mv) + max_mv]
    # G = rint(0.5 * 255) = 128 (half to even), A = 255
    return torch.stack([r_ch, torch.full_like(r_ch, 128), b_ch,
                        torch.full_like(r_ch, 255)], dim=-1)


_P, _I = ctypes.c_void_p, ctypes.c_int
# the C entries of motion_search.cu, {name: (restype, [argtypes])}
SIGNATURES = {
    "sv_motion_search": (_I, [_P, _P, _I, _I, _I, _I, _P, _P, _I, _I, _P, _P,
                              _P, _I, _P]),
    "sv_motion_coarse": (_I, [_P, _P, _I, _I, _I, _I, _P, _P, _I, _P, _P, _I,
                              _P]),
    "sv_motion_refine": (_I, [_P, _P, _I, _I, _I, _I, _I, _P, _I, _P, _I, _P,
                              _P, _P, _I, _P]),
    "sv_motion_geometry": (_I, [ctypes.POINTER(_I), _I]),
}


def _check_geometry(lib: ctypes.CDLL) -> None:
    buf = (_I * 32)()
    got = buf[:lib.sv_motion_geometry(buf, len(buf))]
    if got != list(GEOMETRY.values()):
        raise RuntimeError(f"motion_search.cu has the geometry {got}, "
                           f"ops/motion.py {GEOMETRY}")


def build() -> ctypes.CDLL:
    """Compile (once per source/flags digest) and load the kernel library;
    raises if its geometry is not this module's ``GEOMETRY``."""
    return nvcc.load(SOURCE, SIGNATURES, _check_geometry)


@lru_cache(maxsize=16)
def _device_tables(block: int, search: int, metric: str, device: torch.device):
    """(cost table, mv_u8) on ``device``: sad reads the 2-D cost2 table,
    ssd the per-axis one."""
    _d_lo, cost2, axis, mv_u8 = tables(block, search)
    cost = cost2.reshape(-1) if metric == "sad" else axis
    return tuple(torch.from_numpy(t).to(device) for t in (cost, mv_u8))


@lru_cache(maxsize=16)
def _device_plan(h: int, w: int, search: int, group: int,
                 device: torch.device):
    return (torch.from_numpy(plan(h, w, search)).to(device),
            torch.from_numpy(groups(h, w, group)).to(device))


def coarse_stride(w: int, block: int = 16) -> int:
    """The pyramid's coarse candidate stride for a ``w``-wide frame: 2 when
    a group size of ``PYRAMID_GROUPS`` divides the block columns (the JAX
    package's grouped program), else 1 (its dense exhaustive program)."""
    wb = w // block
    return 2 if any(wb % g == 0 for g in PYRAMID_GROUPS) else 1


def me_coarse_torch(cur: torch.Tensor, ref: torch.Tensor, block: int = 16,
                    search: int = 64, stride: int = 2) -> torch.Tensor:
    """Plain version of the pyramid's coarse stage (the JAX package's
    ``_me_mxu_program(..., raw=True, stride)``): [H // block, W // block,
    2] int32, the raw vector (mvx, mvy) = (ox - tx, oy - ty).

    Candidates: tx in the block's clamped window with tx - ox - d_lo a
    multiple of ``stride`` (a global grid), ty in the window with ty - ylo
    a multiple of ``stride`` (anchored at the clamped window).  The minimum
    is taken in two stages, as the JAX program reduces: over ty first by
    (inner, ty), inner = f32(partial) * 2^-4 + cy, then over tx by
    (inner + cx, tx).  A block with no candidate gets the zero vector."""
    dev = _check(cur, ref, block, search, "ssd")
    if stride not in (1, 2):
        raise ValueError(f"candidate stride {stride}")
    h, w = cur.shape
    hb, wb = h // block, w // block
    d_lo, _cost2, axis, _lut = tables(block, search)
    ds = d_lo + np.arange(axis.shape[0])
    ox = np.arange(wb) * block
    oy = np.arange(hb) * block
    xlo, xhi = search_bounds(ox, block, search, w)
    ylo, yhi = search_bounds(oy, block, search, h)
    tx = ox[None, :] + ds[:, None]
    ty = oy[None, :] + ds[:, None]
    okx = torch.from_numpy((tx >= xlo) & (tx < xhi)
                           & ((ds[:, None] - d_lo) % stride == 0)).to(dev)
    oky = torch.from_numpy((ty >= ylo) & (ty < yhi)
                           & ((ty - ylo) % stride == 0)).to(dev)
    c = cur[:hb * block, :wb * block].to(torch.int32)
    pad = search
    refp = torch.nn.functional.pad(ref.to(torch.int32), (pad, pad, pad, pad))
    scale = torch.tensor(_SSD_SCALE, device=dev)
    inf = float("inf")
    best = torch.full((hb, wb), inf, dtype=torch.float32, device=dev)
    best_dx = torch.zeros((hb, wb), dtype=torch.int64, device=dev)
    best_dy = torch.zeros((hb, wb), dtype=torch.int64, device=dev)

    def block_sum(x):
        return x.reshape(hb, block, wb, block).sum(dim=(1, 3))

    rows = [j for j in range(len(ds)) if bool(oky[j].any())]
    for i, dx in enumerate(ds.tolist()):
        if not bool(okx[i].any()):
            continue
        r_cols = refp[:, pad + dx:pad + dx + wb * block]
        m1 = torch.full((hb, wb), inf, dtype=torch.float32, device=dev)
        j1 = torch.zeros((hb, wb), dtype=torch.int64, device=dev)
        for j in rows:
            r = r_cols[pad + ds[j]:pad + ds[j] + hb * block]
            partial = block_sum(r * r) - 2 * block_sum(c * r)
            inner = partial.to(torch.float32) * scale + float(axis[j])
            better = oky[j][:, None] & (inner < m1)
            m1 = torch.where(better, inner, m1)
            j1 = torch.where(better, int(ds[j]), j1)
        score = m1 + float(axis[i])
        better = okx[i][None, :] & (score < best)
        best = torch.where(better, score, best)
        best_dx = torch.where(better, dx, best_dx)
        best_dy = torch.where(better, j1, best_dy)
    return torch.stack([-best_dx, -best_dy], dim=-1).to(torch.int32)


def refine_torch(cur: torch.Tensor, ref: torch.Tensor, raw: torch.Tensor,
                 block: int = 16, search: int = 64, refine: int = 2,
                 metric: str = "ssd") -> torch.Tensor:
    """The pyramid's refine stage (the JAX package's ``_me_refine_program``)
    as torch ops on the frames' device: each block's ``(2 refine + 1)^2``
    candidates around its coarse vector ``raw[by, bx]`` = (mvx, mvy), in a
    ``win`` x ``win``
    patch clamped into the frame, re-scored exactly with ``metric``; the
    first minimum in tx-major order wins, candidates outside the block's
    clamped window are left out, and a block with none gets the zero
    vector.  Returns the RGBA MV map."""
    dev = _check(cur, ref, block, search, metric)
    h, w = cur.shape
    hb, wb = h // block, w // block
    win = block + 2 * refine
    d_lo, cost2, axis, mv_u8 = tables(block, search)
    n_d = axis.shape[0]
    axis, cost2, mv_u8 = (torch.from_numpy(t).to(dev)
                          for t in (axis, cost2, mv_u8))
    n_off = 2 * refine + 1
    offs = torch.tensor([(ddx, ddy) for ddx in range(n_off)
                         for ddy in range(n_off)], device=dev)
    oy_np = np.arange(hb) * block
    ox_np = np.arange(wb) * block
    xlo, xhi = (torch.from_numpy(t).to(dev)[None, :, None] for t in
                search_bounds(ox_np, block, search, w))
    ylo, yhi = (torch.from_numpy(t).to(dev)[:, None, None] for t in
                search_bounds(oy_np, block, search, h))
    oy = torch.from_numpy(oy_np).to(dev)[:, None]
    ox = torch.from_numpy(ox_np).to(dev)[None, :]
    raw = raw.to(torch.int64)
    gy0 = torch.clamp(oy - raw[..., 1] - refine, 0, h - win)
    gx0 = torch.clamp(ox - raw[..., 0] - refine, 0, w - win)
    iw = torch.arange(win, device=dev)
    patch = ref[(gy0[..., None] + iw)[..., :, None],
                (gx0[..., None] + iw)[..., None, :]].to(torch.int32)
    cb = (cur[:hb * block, :wb * block].to(torch.int32)
          .reshape(hb, block, wb, block).permute(0, 2, 1, 3))
    ty = gy0[..., None] + offs[:, 1]                     # [hb, wb, n_s]
    tx = gx0[..., None] + offs[:, 0]
    valid = (ty >= ylo) & (ty < yhi) & (tx >= xlo) & (tx < xhi)
    dyi = oy[..., None] - ty
    dxi = ox[..., None] - tx
    # cost-table indices of d = t - o (every candidate that counts lies in
    # the block's window, so in the tables' range)
    iy = torch.clamp(-dyi - d_lo, 0, n_d - 1)
    ix = torch.clamp(-dxi - d_lo, 0, n_d - 1)
    terms = []
    for ddx, ddy in offs.tolist():
        rb = patch[:, :, ddy:ddy + block, ddx:ddx + block]
        if metric == "ssd":
            terms.append((rb * rb).sum(dim=(2, 3))
                         - 2 * (cb * rb).sum(dim=(2, 3)))
        else:
            terms.append((cb - rb).abs().sum(dim=(2, 3)))
    term = torch.stack(terms, dim=-1).to(torch.float32)
    if metric == "ssd":
        score = (term * torch.tensor(_SSD_SCALE, device=dev)
                 + axis[iy]) + axis[ix]
    else:
        score = cost2[ix, iy] + term * torch.tensor(_SAD_SCALE, device=dev)
    score = torch.where(valid, score, float("inf"))
    # the first minimum in tx-major order
    m = score.min(dim=-1).values
    km = torch.where(score == m[..., None],
                     torch.arange(score.shape[-1], device=dev),
                     score.shape[-1]).min(dim=-1).values
    ok = torch.isfinite(m)
    max_mv = search // 2
    out = []
    for d in (dxi, dyi):
        mv = torch.where(ok, d.gather(-1, km[..., None])[..., 0], 0)
        out.append(mv_u8[torch.clamp(mv, -max_mv, max_mv) + max_mv])
    # G = rint(0.5 * 255) = 128 (half to even), A = 255
    return torch.stack([out[0], torch.full_like(out[0], 128), out[1],
                        torch.full_like(out[0], 255)], dim=-1)


def pyramid_falls_back(h: int, w: int, block: int, search: int,
                       refine: int) -> bool:
    """Geometries the two-stage search cannot express (the JAX package's
    condition): they take the exhaustive search."""
    return bool(h % 2 or w % 2 or block % 2 or search % 2 or block < 8
                or search <= block or w % block or h < block + 2 * refine
                or w < block + 2 * refine)


def me_fullsearch_pyramid_torch(cur: torch.Tensor, ref: torch.Tensor,
                                block: int = 16, search: int = 64,
                                refine: int = 2,
                                metric: str = "ssd") -> torch.Tensor:
    """Plain version of ``me_fullsearch_pyramid``."""
    h, w = cur.shape
    if pyramid_falls_back(h, w, block, search, refine):
        return me_fullsearch_torch(cur, ref, block, search, metric)
    raw = me_coarse_torch(cur, ref, block, search, coarse_stride(w, block))
    return refine_torch(cur, ref, raw, block, search, refine, metric)


def me_fullsearch(cur: torch.Tensor, ref: torch.Tensor, block: int = 16,
                  search: int = 64, metric: str = "sad") -> torch.Tensor:
    """Full search of ``cur`` against ``ref`` ([H, W] u8 luma tensors on one
    device): [H // block, W // block, 4] u8 RGBA MV map on that device.
    The kernel on a CUDA device, the plain version on the CPU."""
    global launches
    if not _on_card(cur, ref, block, search, metric):
        return me_fullsearch_torch(cur, ref, block, search, metric)
    _check_kernel_frames(cur, ref, block)
    dev = cur.device
    h, w = cur.shape
    out = torch.empty((h // block, w // block, 4), dtype=torch.uint8,
                      device=dev)
    if out.numel() == 0:
        return out
    lib = build()
    cost, lut = _device_tables(block, search, metric, dev)
    pl, gr = _device_plan(h, w, search, GROUP[metric], dev)
    n_d = tables(block, search)[1].shape[0]
    nvcc.launch(lib.sv_motion_search, dev, cur.data_ptr(), ref.data_ptr(), h,
                w, search, METRICS.index(metric), pl.data_ptr(), gr.data_ptr(),
                gr.shape[0], n_d, cost.data_ptr(), lut.data_ptr(),
                out.data_ptr(), span="motion.launch")
    launches += 1
    route_launches[KERNELS[metric]] += 1
    return out


def me_coarse(cur: torch.Tensor, ref: torch.Tensor, block: int = 16,
              search: int = 64, stride: int = 2) -> torch.Tensor:
    """The pyramid's coarse stage: [H // block, W // block, 2] int32 raw
    vectors (mvx, mvy) on the frames' device.  On a CUDA device one launch:
    ``motion_coarse_kernel`` for stride 2, the SSD kernel's coarse mode for
    stride 1; ``me_coarse_torch`` on the CPU."""
    global launches
    if stride not in (1, 2):
        raise ValueError(f"candidate stride {stride}")
    if not _on_card(cur, ref, block, search, "ssd"):
        return me_coarse_torch(cur, ref, block, search, stride)
    _check_kernel_frames(cur, ref, block)
    dev = cur.device
    h, w = cur.shape
    raw = torch.empty((h // block, w // block, 2), dtype=torch.int32,
                      device=dev)
    if raw.numel() == 0:
        return raw
    lib = build()
    axis, _lut = _device_tables(block, search, "ssd", dev)
    pl, gr = _device_plan(h, w, search, GROUP["ssd"], dev)
    nvcc.launch(lib.sv_motion_coarse, dev, cur.data_ptr(), ref.data_ptr(), h,
                w, search, stride, pl.data_ptr(), gr.data_ptr(), gr.shape[0],
                axis.data_ptr(), raw.data_ptr(), span="motion.launch")
    launches += 1
    route_launches[COARSE_KERNELS[stride]] += 1
    return raw


def me_refine(cur: torch.Tensor, ref: torch.Tensor, raw: torch.Tensor,
              block: int = 16, search: int = 64, refine: int = 2,
              metric: str = "ssd") -> torch.Tensor:
    """The pyramid's refine stage around ``raw`` ([H // block, W // block,
    2] coarse vectors on the frames' device): the RGBA MV map.  The refine
    kernel on a CUDA device (one launch), ``refine_torch`` on the CPU."""
    global launches
    if not _on_card(cur, ref, block, search, metric):
        return refine_torch(cur, ref, raw, block, search, refine, metric)
    _check_kernel_frames(cur, ref, block)
    dev = cur.device
    h, w = cur.shape
    out = torch.empty((h // block, w // block, 4), dtype=torch.uint8,
                      device=dev)
    if out.numel() == 0:
        return out
    lib = build()
    cost, lut = _device_tables(block, search, metric, dev)
    pl, _gr = _device_plan(h, w, search, GROUP["ssd"], dev)
    n_d = tables(block, search)[2].shape[0]
    raw = raw.to(torch.int32).contiguous()
    nvcc.launch(lib.sv_motion_refine, dev, cur.data_ptr(), ref.data_ptr(), h,
                w, search, refine, METRICS.index(metric), pl.data_ptr(),
                pl.shape[0], raw.data_ptr(), n_d, cost.data_ptr(),
                lut.data_ptr(), out.data_ptr(), span="motion.launch")
    launches += 1
    route_launches[REFINE_KERNEL] += 1
    return out


def me_fullsearch_pyramid(cur: torch.Tensor, ref: torch.Tensor,
                          block: int = 16, search: int = 64, refine: int = 2,
                          metric: str = "ssd") -> torch.Tensor:
    """Two-stage motion search (the JAX package's ``me_fullsearch_pyramid``):
    the coarse SSD stage on the stride-2 grid (stride 1 when no group size
    divides the block columns), then the exact refine with ``metric``.
    Geometries it cannot express take ``me_fullsearch``.  On a CUDA device
    the coarse stage and the refine are one kernel launch each, the
    fallback one launch of K4 or K5; on the CPU, the plain versions.
    Returns the [H // block, W // block, 4] u8 RGBA MV map."""
    h, w = cur.shape
    if pyramid_falls_back(h, w, block, search, refine):
        return me_fullsearch(cur, ref, block, search, metric)
    raw = me_coarse(cur, ref, block, search, coarse_stride(w, block))
    return me_refine(cur, ref, raw, block, search, refine, metric)
