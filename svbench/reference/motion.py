"""Plain motion search, in torch ops: upstream's exhaustive block search and
the two-stage search that covers the same window faster.

Upstream is SwiftVideo's ``me_fullsearch`` (``kernels.metal:204-267``, its
cost ``deltaCost2`` at ``:138-145``, ``MotionEstimationUniforms`` at
``:33-37``), which ``ComputeKernel`` names (``compute.swift:49-74``).
Written for this benchmark from those semantics and the program's
documented contract; it imports nothing of the program, and takes only
u8 luma planes.

The exhaustive search (``full_search``).  A frame of H x W holds
floor(H / block) x floor(W / block) blocks; a block at origin (ox, oy)
searches the candidates t = (tx, ty) of its clamped window, on each axis
``lo = clip(o + block/2 - search/2, 0, size)``, ``hi = clip(lo + search,
0, size) - block``, lo <= t < hi (the window may reach rows and columns
that hold no block of their own: a 1080-row frame has 67 block rows and
its last 8 rows are only read).  The vector is mv = o - t.  Scores:

* ``sad``: ``f32(cost2(mv) + f32(f32(SAD) * 256/255))``, SAD the integer
  sum of |cur - ref| over the block (upstream's score, in units of
  unorm x 256);
* ``ssd``: ``f32(f32(f32(partial) * 2^-4 + cy(mv.y)) + cx(mv.x))``,
  partial = sum(r^2) - 2 sum(c r), the block's SSD less sum(c^2), which
  is constant per block and leaves the winner as it is.

cost2(mv) = 4 (comp(mv.x) + comp(mv.y)) with comp(v) = 4 (2 log2(|v| + 1)
+ 0.718 + [v != 0]) + 0.5, and cx = cy = 4 comp: built in float64 for the
window's displacements and rounded to float32 once.  The first strict
minimum in (tx outer, ty inner) scan order wins; a block whose window is
empty keeps the zero vector.

The two-stage search (``pyramid``).  The coarse stage scores the SSD on a
stride-2 grid: tx with tx - ox - d_lo even (a grid over the whole frame,
d_lo = block/2 - search/2), ty with ty - lo_y even (anchored at each
block row's clamped window), and takes its minimum in two stages, as the
grouped search it comes from does: over ty first by (inner, ty), inner =
f32(partial) * 2^-4 + cy, then over tx by (inner + cx, tx).  A frame
whose block columns no group of 8, 6, 5, 4, 3 or 2 divides takes the
stride-1 grid.  The refine stage clamps a patch of block + 2 refine
pixels around each coarse pick into the frame and re-scores its (2 refine
+ 1)^2 candidates exactly with the refine's score, leaving out those
outside the block's window; the first minimum in tx-major order wins, and
a block with none keeps the zero vector.  Frames the two stages cannot
express (an odd size, search <= block, a width that is not a multiple of
the block, a frame narrower or shorter than the patch) take the
exhaustive search.

The map is RGBA u8 at block resolution: R and B the vector's components
through one float32 table, rint((clamp(m, +-search/2) / (search/2)) * 0.5
+ 0.5) * 255) with ties to even; G = 128, A = 255.

Departures from upstream's kernel, each a choice the program shares:
the cost tables are computed once in float64 and rounded (upstream
evaluates deltaCost2 in float per candidate); the u8 channel rounds half
to even from float32 (upstream writes the float to a unorm texture);
blocks are counted by floor where the frame is not a multiple of the
block; the SSD score and the two-stage search are not upstream's.

``dtype`` is the precision of every float step (the tables, the scores,
the u8 table): ``torch.float32`` is what the configuration states,
``torch.bfloat16`` the control.  The integer sums are exact in int32 in
either.  Each float product and sum is its own torch op, so nothing is
contracted into a multiply-add.  The search works in whole-frame
displacement steps, one horizontal displacement at a time with every
vertical one batched, so that a 1080p frame fits on one card.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

# no float32 matmul may run in TF32 where this reference runs
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

GROUPS = (8, 6, 5, 4, 3, 2)
SAD_SCALE = 256.0 / 255.0   # rounded to the score's precision
SSD_SCALE = 2.0 ** -4


def window(o: np.ndarray, block: int, search: int,
           size: int) -> Tuple[np.ndarray, np.ndarray]:
    """[lo, hi) of the candidates t of blocks at origins ``o`` on an axis
    of ``size`` pixels."""
    lo = np.clip(o + block // 2 - search // 2, 0, size)
    return lo, np.clip(lo + search, 0, size) - block


def _comp(v: np.ndarray) -> np.ndarray:
    """One axis of deltaCost2, in float64."""
    return 4.0 * (np.log2(np.abs(v) + 1.0) * 2.0 + 0.718 + (v != 0)) + 0.5


def displacements(block: int, search: int) -> np.ndarray:
    """Every d = t - o a window can hold, ascending."""
    d_lo = block // 2 - search // 2
    return np.arange(d_lo, search - block, dtype=np.int64)


def _tables(block: int, search: int, dtype, device):
    """(cost2 [n_d, n_d] by (dx, dy) index, axis [n_d]): the costs of
    mv = -d for every displacement d, from float64 rounded to ``dtype``."""
    comp = _comp(-displacements(block, search).astype(np.float64))
    cost2 = torch.from_numpy(4.0 * (comp[:, None] + comp[None, :]))
    axis = torch.from_numpy(4.0 * comp)
    return cost2.to(dtype).to(device), axis.to(dtype).to(device)


def _u8_table(search: int, dtype, device) -> torch.Tensor:
    """[search + 1] u8: the channel of each clamped component m, computed
    in ``dtype``."""
    max_mv = search // 2
    m = torch.arange(-max_mv, max_mv + 1, device=device).to(dtype)
    n = m / torch.tensor(max_mv, dtype=dtype, device=device) \
        * torch.tensor(0.5, dtype=dtype, device=device) \
        + torch.tensor(0.5, dtype=dtype, device=device)
    n = n * torch.tensor(255.0, dtype=dtype, device=device)
    return torch.clamp(torch.round(n), 0, 255).to(torch.uint8)


def emit(mvx: torch.Tensor, mvy: torch.Tensor, search: int,
         dtype=torch.float32) -> torch.Tensor:
    """The [hb, wb, 4] u8 RGBA map of integer vectors."""
    u8 = _u8_table(search, dtype, mvx.device)
    max_mv = search // 2
    r = u8[torch.clamp(mvx, -max_mv, max_mv) + max_mv]
    b = u8[torch.clamp(mvy, -max_mv, max_mv) + max_mv]
    # G = rint(0.5 * 255) = 128 (127.5 is exact in either precision)
    return torch.stack([r, torch.full_like(r, 128), b,
                        torch.full_like(r, 255)], dim=-1)


def _shifted(refp: torch.Tensor, pad: int, dx: int, d0: int, n: int,
             rows: int, cols: int) -> torch.Tensor:
    """[n, rows, cols] view of the padded reference: plane k is the frame
    moved by (dx, d0 + k)."""
    stride = refp.stride(0)
    return torch.as_strided(refp, (n, rows, cols), (stride, stride, 1),
                            (pad + d0) * stride + pad + dx)


def _block_sums(x: torch.Tensor, hb: int, block: int, wb: int):
    return x.reshape(x.shape[0], hb, block, wb, block).sum(
        dim=(2, 4), dtype=torch.int32)


class _Frames:
    """The two frames of one search as the steps read them: the current
    frame's blocks and the reference padded by ``search`` on every side."""

    def __init__(self, cur, ref, block: int, search: int, wide):
        self.h, self.w = cur.shape
        self.hb, self.wb = self.h // block, self.w // block
        self.block, self.pad = block, search
        self.c = cur[:self.hb * block, :self.wb * block].to(wide)
        self.refp = torch.zeros((self.h + 2 * search, self.w + 2 * search),
                                dtype=wide, device=cur.device)
        self.refp[search:search + self.h, search:search + self.w] = ref

    def moved(self, dx: int, ds: np.ndarray) -> torch.Tensor:
        return _shifted(self.refp, self.pad, dx, int(ds[0]), len(ds),
                        self.hb * self.block, self.wb * self.block)

    def sad(self, r: torch.Tensor) -> torch.Tensor:
        return _block_sums((self.c[None] - r).abs(), self.hb, self.block,
                           self.wb)

    def partial(self, r: torch.Tensor) -> torch.Tensor:
        return (_block_sums(r * r, self.hb, self.block, self.wb)
                - 2 * _block_sums(self.c[None] * r, self.hb, self.block,
                                  self.wb))


def _first_min(score: torch.Tensor):
    """(minimum over dim 0, the first index that holds it)."""
    m = score.min(dim=0).values
    idx = torch.arange(score.shape[0], device=score.device).view(
        -1, *([1] * (score.dim() - 1)))
    first = torch.where(score == m, idx, score.shape[0]).min(dim=0).values
    return m, first


def _valid(o: np.ndarray, ds: np.ndarray, lo, hi, device) -> torch.Tensor:
    """[n_d, len(o)]: o + d inside [lo, hi)."""
    t = o[None, :] + ds[:, None]
    return torch.from_numpy((t >= lo) & (t < hi)).to(device)


def full_search(cur: torch.Tensor, ref: torch.Tensor, block: int = 16,
                search: int = 64, metric: str = "sad",
                dtype=torch.float32) -> torch.Tensor:
    """The exhaustive search of ``cur`` against ``ref`` ([H, W] u8 on one
    device): the [H // block, W // block, 4] u8 map."""
    dev = cur.device
    f = _Frames(cur, ref, block, search,
                torch.int16 if metric == "sad" else torch.int32)
    hb, wb = f.hb, f.wb
    ds = displacements(block, search)
    ox, oy = np.arange(wb) * block, np.arange(hb) * block
    vx = _valid(ox, ds, *window(ox, block, search, f.w), dev)
    vy = _valid(oy, ds, *window(oy, block, search, f.h), dev)
    cost2, axis = _tables(block, search, dtype, dev)
    scale = torch.tensor(SAD_SCALE if metric == "sad" else SSD_SCALE,
                         dtype=dtype, device=dev)
    best = torch.full((hb, wb), float("inf"), dtype=dtype, device=dev)
    bdx = torch.zeros((hb, wb), dtype=torch.int64, device=dev)
    bdy = torch.zeros((hb, wb), dtype=torch.int64, device=dev)
    dys = torch.from_numpy(ds).to(dev)
    for i, dx in enumerate(ds.tolist()):
        if not bool(vx[i].any()):
            continue
        r = f.moved(dx, ds)
        if metric == "sad":
            score = f.sad(r).to(dtype) * scale + cost2[i][:, None, None]
        else:
            score = ((f.partial(r).to(dtype) * scale
                      + axis[:, None, None]) + axis[i])
        score = torch.where(vy[:, :, None] & vx[i][None, None, :], score,
                            float("inf"))
        m, j = _first_min(score)
        better = m < best
        best = torch.where(better, m, best)
        bdx = torch.where(better, dx, bdx)
        bdy = torch.where(better, dys[j], bdy)
    return emit(-bdx, -bdy, search, dtype)


def coarse_stride(w: int, block: int = 16) -> int:
    """2 where a group size of ``GROUPS`` divides the block columns, else
    1."""
    return 2 if any((w // block) % g == 0 for g in GROUPS) else 1


def coarse(cur: torch.Tensor, ref: torch.Tensor, block: int = 16,
           search: int = 64, stride: int = 2,
           dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """The coarse stage: (mvx, mvy), each [hb, wb] int64."""
    dev = cur.device
    f = _Frames(cur, ref, block, search, torch.int32)
    hb, wb = f.hb, f.wb
    ds = displacements(block, search)
    d_lo = int(ds[0])
    ox, oy = np.arange(wb) * block, np.arange(hb) * block
    xlo, xhi = window(ox, block, search, f.w)
    ylo, yhi = window(oy, block, search, f.h)
    vx = _valid(ox, ds, xlo, xhi, dev) \
        & torch.from_numpy((ds - d_lo) % stride == 0).to(dev)[:, None]
    ty = oy[None, :] + ds[:, None]
    vy = _valid(oy, ds, ylo, yhi, dev) \
        & torch.from_numpy((ty - ylo[None, :]) % stride == 0).to(dev)
    _cost2, axis = _tables(block, search, dtype, dev)
    scale = torch.tensor(SSD_SCALE, dtype=dtype, device=dev)
    best = torch.full((hb, wb), float("inf"), dtype=dtype, device=dev)
    bdx = torch.zeros((hb, wb), dtype=torch.int64, device=dev)
    bdy = torch.zeros((hb, wb), dtype=torch.int64, device=dev)
    dys = torch.from_numpy(ds).to(dev)
    for i, dx in enumerate(ds.tolist()):
        if not bool(vx[i].any()):
            continue
        inner = f.partial(f.moved(dx, ds)).to(dtype) * scale \
            + axis[:, None, None]
        inner = torch.where(vy[:, :, None], inner, float("inf"))
        m1, j1 = _first_min(inner)
        score = m1 + axis[i]
        better = vx[i][None, :] & (score < best)
        best = torch.where(better, score, best)
        bdx = torch.where(better, dx, bdx)
        bdy = torch.where(better, dys[j1], bdy)
    return -bdx, -bdy


def refine(cur: torch.Tensor, ref: torch.Tensor, mvx: torch.Tensor,
           mvy: torch.Tensor, block: int = 16, search: int = 64,
           radius: int = 2, metric: str = "ssd",
           dtype=torch.float32) -> torch.Tensor:
    """The refine stage around the coarse vectors (mvx, mvy): the map."""
    dev = cur.device
    h, w = cur.shape
    hb, wb = h // block, w // block
    side = block + 2 * radius
    d_lo = block // 2 - search // 2
    cost2, axis = _tables(block, search, dtype, dev)
    n_d = axis.shape[0]
    ox_np, oy_np = np.arange(wb) * block, np.arange(hb) * block
    xlo, xhi = (torch.from_numpy(a).to(dev)[None, :]
                for a in window(ox_np, block, search, w))
    ylo, yhi = (torch.from_numpy(a).to(dev)[:, None]
                for a in window(oy_np, block, search, h))
    ox = torch.from_numpy(ox_np).to(dev)[None, :]
    oy = torch.from_numpy(oy_np).to(dev)[:, None]
    gx = torch.clamp(ox - mvx - radius, 0, w - side)
    gy = torch.clamp(oy - mvy - radius, 0, h - side)
    c = (cur[:hb * block, :wb * block].to(torch.int32)
         .reshape(hb, block, wb, block).permute(0, 2, 1, 3))
    iota = torch.arange(block, device=dev)
    scale = torch.tensor(SAD_SCALE if metric == "sad" else SSD_SCALE,
                         dtype=dtype, device=dev)
    scores, vecs = [], []
    for ddx in range(2 * radius + 1):          # tx-major
        for ddy in range(2 * radius + 1):
            tx, ty = gx + ddx, gy + ddy
            r = ref[(ty[..., None] + iota)[..., :, None],
                    (tx[..., None] + iota)[..., None, :]].to(torch.int32)
            ix = torch.clamp(tx - ox - d_lo, 0, n_d - 1)
            iy = torch.clamp(ty - oy - d_lo, 0, n_d - 1)
            if metric == "sad":
                term = (c - r).abs().sum(dim=(2, 3))
                score = cost2[ix, iy] + term.to(dtype) * scale
            else:
                term = (r * r).sum(dim=(2, 3)) - 2 * (c * r).sum(dim=(2, 3))
                score = (term.to(dtype) * scale + axis[iy]) + axis[ix]
            ok = (tx >= xlo) & (tx < xhi) & (ty >= ylo) & (ty < yhi)
            scores.append(torch.where(ok, score, float("inf")))
            vecs.append((ox - tx, oy - ty))
    m, k = _first_min(torch.stack(scores))
    found = torch.isfinite(m)
    out = []
    for axis_ in (0, 1):
        v = torch.stack([p[axis_].expand(hb, wb) for p in vecs])
        out.append(torch.where(found, v.gather(0, k[None])[0], 0))
    return emit(out[0], out[1], search, dtype)


def falls_back(h: int, w: int, block: int, search: int, radius: int) -> bool:
    """Frames the two-stage search cannot express."""
    return bool(h % 2 or w % 2 or block % 2 or search % 2 or block < 8
                or search <= block or w % block
                or h < block + 2 * radius or w < block + 2 * radius)


def pyramid(cur: torch.Tensor, ref: torch.Tensor, block: int = 16,
            search: int = 64, radius: int = 2, metric: str = "ssd",
            dtype=torch.float32) -> torch.Tensor:
    """The two-stage search: the coarse stage, then the refine with
    ``metric``; the exhaustive search where it cannot be expressed."""
    h, w = cur.shape
    if falls_back(h, w, block, search, radius):
        return full_search(cur, ref, block, search, metric, dtype)
    mvx, mvy = coarse(cur, ref, block, search, coarse_stride(w, block),
                      dtype)
    return refine(cur, ref, mvx, mvy, block, search, radius, metric, dtype)


def by_kernel(kernel: str, cur: torch.Tensor, ref: torch.Tensor,
              block: int, search: int, radius: int,
              dtype=torch.float32) -> torch.Tensor:
    """The map the compute registry's motion kernel ``kernel`` gives:
    ``me_fullsearch`` the exhaustive SAD search, ``me_fullsearch_ssd`` the
    exhaustive SSD search, ``me_fullsearch_pyramid`` the two-stage search
    with the SSD refine."""
    if kernel == "me_fullsearch_pyramid":
        return pyramid(cur, ref, block, search, radius, "ssd", dtype)
    metric = {"me_fullsearch": "sad", "me_fullsearch_ssd": "ssd"}[kernel]
    return full_search(cur, ref, block, search, metric, dtype)
