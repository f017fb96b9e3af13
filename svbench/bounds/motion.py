"""Operations and bytes of the motion search's kernels, from a cell's shapes
alone, and the peaks they are held to.

* ``motion_sad_kernel`` (the exhaustive SAD search, upstream's): one
  pixel-candidate term (|c - r| of one pixel of a block at one candidate
  of its window) a byte; a byte-SIMD lane instruction takes 4 of them,
  and every SM issues 64 integer lanes a clock.
* ``motion_coarse_kernel`` (the two-stage search's coarse stage on the
  stride-2 grid): the SSD cross term's multiply and add, 2 operations a
  pixel-candidate term of the grid, at the int8 tensor rate.
* ``motion_refine_kernel``: the SSD cross term and r^2, 4 operations a
  term of the (2 refine + 1)^2 candidates of every block (all of them, as
  an upper count), at the int8 tensor rate.

Bytes: both frames read once; the exhaustive search writes the RGBA map
(4 bytes a block); the coarse stage writes its int32 vectors (8 bytes a
block), which the refine reads before writing the map.  A kernel's bound
is the larger of its bytes at ``peaks.HBM_BPS`` and its operations at its
rate.
"""

from __future__ import annotations

import numpy as np

from svbench.bounds import peaks
from svbench.reference.motion import coarse_stride, window

# NVIDIA H100 SXM5 (NVIDIA's data sheet): 132 SMs, 1980 MHz the highest
# SM clock, 1979 TOP/s of dense int8 tensor operations; each SM's four
# sub-partitions hold 16 INT32 lanes (the pipe of the byte-SIMD SAD)
SMS = 132
SM_CLOCK_HZ = 1980e6
INT_LANES_PER_SM_CLOCK = 64
INT8_OPS = 1979e12
SAD_TERMS_PER_LANE_OP = 4
SAD_TERMS_PER_S = (SAD_TERMS_PER_LANE_OP * INT_LANES_PER_SM_CLOCK * SMS
                   * SM_CLOCK_HZ)


def pixel_candidates(h: int, w: int, block: int = 16,
                     search: int = 64) -> int:
    """Block pixels times the candidates of every block's clamped
    window."""
    xlo, xhi = window(np.arange(w // block) * block, block, search, w)
    ylo, yhi = window(np.arange(h // block) * block, block, search, h)
    return (block * block * int(np.maximum(xhi - xlo, 0).sum())
            * int(np.maximum(yhi - ylo, 0).sum()))


def grid_candidates(h: int, w: int, block: int = 16, search: int = 64,
                    stride: int = 2, refine: int = 2):
    """(candidates of the coarse grid summed over the blocks, candidates
    of the refine: (2 refine + 1)^2 a block)."""
    d_lo = block // 2 - search // 2
    ox = np.arange(w // block) * block
    xlo, xhi = window(ox, block, search, w)
    ylo, yhi = window(np.arange(h // block) * block, block, search, h)
    nx = sum(sum(1 for tx in range(a, b) if (tx - o - d_lo) % stride == 0)
             for o, a, b in zip(ox, xlo, xhi))
    ny = sum(len(range(a, b, stride)) for a, b in zip(ylo, yhi))
    return nx * ny, len(ox) * len(ylo) * (2 * refine + 1) ** 2


def _shape(config: dict):
    w, h = config["frame"]["size"]
    return h, w, config["block"], config["window"]


def sad_bound_s(config: dict) -> float:
    """Least seconds of one exhaustive SAD search."""
    h, w, block, search = _shape(config)
    nbytes = 2 * h * w + (h // block) * (w // block) * 4
    terms = pixel_candidates(h, w, block, search)
    return max(nbytes / peaks.HBM_BPS, terms / SAD_TERMS_PER_S)


def coarse_bound_s(config: dict) -> float:
    """Least seconds of one coarse stage."""
    h, w, block, search = _shape(config)
    grid, _ = grid_candidates(h, w, block, search, coarse_stride(w, block),
                              config["refine"])
    nbytes = 2 * h * w + (h // block) * (w // block) * 8
    return max(nbytes / peaks.HBM_BPS, 2 * block * block * grid / INT8_OPS)


def refine_bound_s(config: dict) -> float:
    """Least seconds of one refine stage."""
    h, w, block, search = _shape(config)
    _, cands = grid_candidates(h, w, block, search, coarse_stride(w, block),
                               config["refine"])
    nbytes = 2 * h * w + (h // block) * (w // block) * 12
    return max(nbytes / peaks.HBM_BPS, 4 * block * block * cands / INT8_OPS)
