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
``log2``.  ``me_fullsearch`` launches ``csrc/motion_search.cu`` for CUDA
tensors (it replaces the TPU kernels ``motion.py::_me_pallas_program``
and ``::_me_ssd_pallas_program``) and takes the plain version for CPU
tensors.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from . import nvcc

# kernel launches since import; a plain integer so a run can show that its
# searches went through the kernel
launches = 0

SOURCE = nvcc.CSRC / "motion_search.cu"
METRICS = ("sad", "ssd")
KERNEL_BLOCK = 16     # the kernel's macroblock edge
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
    """Compile (once per source/flags digest) and load the kernel library."""
    lib = nvcc.load(SOURCE)
    fn = lib.sv_motion_search
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


@lru_cache(maxsize=16)
def _device_tables(block: int, search: int, metric: str, device: torch.device):
    """(cost table, mv_u8) on ``device``: sad reads the 2-D cost2 table,
    ssd the per-axis one."""
    _d_lo, cost2, axis, mv_u8 = tables(block, search)
    cost = cost2.reshape(-1) if metric == "sad" else axis
    return tuple(torch.from_numpy(t).to(device) for t in (cost, mv_u8))


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
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sv_motion_search(cur.data_ptr(), ref.data_ptr(), h, w, search,
                                   METRICS.index(metric), cost.data_ptr(),
                                   lut.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"motion_search launch failed: CUDA error {err}")
    launches += 1
    return out
