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
``log2``.  ``me_fullsearch`` launches a kernel of
``csrc/motion_search.cu`` for CUDA tensors (``motion_sad_kernel`` and
``motion_ssd_kernel`` replace the TPU kernels
``motion.py::_me_pallas_program`` and ``::_me_ssd_pallas_program``) and
takes the plain version for CPU tensors.  ``launches`` counts kernel
launches, ``route_launches`` the launches of each kernel.

The kernels' host-side arithmetic lives here, where the CPU tests reach
it: ``plan`` (one row per macroblock: origin, clamped window, candidate
counts, cost-table offsets; the kernels read it), the chunking of a
window into ``CHUNK`` x ``CHUNK`` candidates, the candidates each SAD
thread and each SSD lane owns, and the SSD kernel's tensor-core operand
layout (``mma_*`` and ``ssd_*_source``).
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
KERNEL_BLOCK = 16     # the kernels' macroblock edge
# the kernels' geometry (csrc/motion_search.cu, the k* constants of
# GEOMETRY; build() checks the library's against it)
CHUNK = 48            # candidates per axis of one staged window chunk
THREADS = 192         # threads of a CUDA block
SAD_RUN = 12          # candidate rows of one SAD thread
SSD_WARP_ROWS = 24    # candidate rows of one SSD warp: 3 tiles of 8
SSD_PAIRS = (SSD_WARP_ROWS + KERNEL_BLOCK) // 2  # window row pairs it reads
SSD_KSTEPS = 12       # row pairs (k = 32 steps) of one tile's K
PLAN_FIELDS = ("ox", "oy", "xlo", "ylo", "n_x", "n_y", "di0", "dj0")
# macroblocks of one block row that a CUDA block searches together, sharing
# one staged window (kSadGroup and kSsdGroup of the kernels)
GROUP = {"sad": 2, "ssd": 4}
# the kernels' constants, by name, in the order sv_motion_geometry reports
GEOMETRY = {"kBlock": KERNEL_BLOCK, "kChunk": CHUNK, "kThreads": THREADS,
            "kSadRun": SAD_RUN, "kYHalf": SSD_WARP_ROWS,
            "kKSteps": SSD_KSTEPS, "kPlanFields": len(PLAN_FIELDS),
            "kSadGroup": GROUP["sad"], "kSsdGroup": GROUP["ssd"]}

# kernel launches since import, in all and by kernel name; plain integers so
# a run can show that its searches went through the kernels
launches = 0
route_launches = {name: 0 for name in KERNELS.values()}
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
    channel of a clamped vector component m (half-to-even rint, in float64
    like the oracle)."""
    d_lo = block // 2 - search // 2
    n_d = max(search - block - d_lo, 1)
    comp = _comp(-(d_lo + np.arange(n_d, dtype=np.float64)))
    cost2 = (_QPEX * (comp[:, None] + comp[None, :])).astype(np.float32)
    axis = (_QPEX * comp).astype(np.float32)
    max_mv = search // 2
    m = np.arange(-max_mv, max_mv + 1, dtype=np.float64)
    mv_u8 = np.clip(np.rint((m / max_mv * 0.5 + 0.5) * 255.0), 0,
                    255).astype(np.uint8)
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


def build() -> ctypes.CDLL:
    """Compile (once per source/flags digest) and load the kernel library;
    raises if its geometry is not this module's ``GEOMETRY``."""
    lib = nvcc.load(SOURCE)
    fn = lib.sv_motion_search
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, I, I, I, I, P, P, I, I, P, P, P, P]
        fn.restype = I
        info = lib.sv_motion_geometry
        info.argtypes = [ctypes.POINTER(I), I]
        info.restype = I
        buf = (I * 32)()
        got = buf[:info(buf, len(buf))]
        if got != list(GEOMETRY.values()):
            fn.argtypes = None
            raise RuntimeError(f"motion_search.cu has the geometry {got}, "
                               f"ops/motion.py {GEOMETRY}")
    return lib


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


def me_fullsearch(cur: torch.Tensor, ref: torch.Tensor, block: int = 16,
                  search: int = 64, metric: str = "sad") -> torch.Tensor:
    """Full search of ``cur`` against ``ref`` ([H, W] u8 luma tensors on one
    device): [H // block, W // block, 4] u8 RGBA MV map on that device.
    The kernel on a CUDA device, the plain version on the CPU."""
    global launches
    dev = _check(cur, ref, block, search, metric)
    if dev.type == "cpu":
        return me_fullsearch_torch(cur, ref, block, search, metric)
    if dev.type != "cuda":
        raise ValueError(f"motion search runs on cuda, not {dev}")
    if block != KERNEL_BLOCK:
        raise ValueError(f"the motion kernel takes {KERNEL_BLOCK}x"
                         f"{KERNEL_BLOCK} blocks, not {block}")
    if not (cur.is_contiguous() and ref.is_contiguous()):
        raise ValueError("frames must be contiguous")
    h, w = cur.shape
    out = torch.empty((h // block, w // block, 4), dtype=torch.uint8,
                      device=dev)
    if out.numel() == 0:
        return out
    lib = build()
    cost, lut = _device_tables(block, search, metric, dev)
    pl, gr = _device_plan(h, w, search, GROUP[metric], dev)
    n_d = tables(block, search)[1].shape[0]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sv_motion_search(cur.data_ptr(), ref.data_ptr(), h, w, search,
                                   METRICS.index(metric), pl.data_ptr(),
                                   gr.data_ptr(), gr.shape[0], n_d,
                                   cost.data_ptr(), lut.data_ptr(),
                                   out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{KERNELS[metric]} launch failed: CUDA error {err}")
    launches += 1
    route_launches[KERNELS[metric]] += 1
    return out
