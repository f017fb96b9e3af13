"""Bytes one ladder tick must move: of every channel's frame, each 32-byte
sector that holds a bilinear tap some pixel of any rung weights, read once
(the union over the rungs of ``cell_kernel``'s tap sectors: a rung reads
only the rows and columns its taps land on, and a byte two rungs tap is
needed once), and each rung written once."""

from __future__ import annotations

import numpy as np

from svbench.bounds import cell_kernel


def plane_sectors(in_w: int, in_h: int, outs, sector: int = cell_kernel.SECTOR
                  ) -> int:
    """Sectors of a dense ``in_w`` x ``in_h`` u8 plane that hold a tap of
    any of the output sizes ``outs``."""
    hit = [(cell_kernel.taps(in_h, h)[:, None] * in_w
            + cell_kernel.taps(in_w, w)[None, :]).ravel() // sector
           for w, h in outs]
    return np.unique(np.concatenate(hit)).size


def read_bytes(size, rungs, sector: int = cell_kernel.SECTOR) -> int:
    """Bytes of one frame of ``size`` that the rungs tap, each once."""
    (w, h) = size
    half = [(rw // 2, rh // 2) for rw, rh in rungs]
    return sector * (plane_sectors(w, h, rungs, sector)
                     + 2 * plane_sectors(w // 2, h // 2, half, sector))


def bytes_per_tick(config: dict) -> int:
    rungs = [tuple(r) for r in config["rungs"]]
    written = sum(w * h + 2 * (w // 2) * (h // 2) for w, h in rungs)
    return config["channels"] * (
        read_bytes(tuple(config["frame"]["size"]), rungs) + written)
