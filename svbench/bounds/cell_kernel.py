"""Bytes one wall tick must move: of each stream, the 32-byte sectors that
hold a bilinear tap some cell pixel weights (a downscale reads only the
rows and columns its taps land on); the canvas written once; the streams'
audio read once and the mix written once."""

from __future__ import annotations

import numpy as np

SECTOR = 32


def taps(n_in: int, n_out: int) -> np.ndarray:
    """Input indices with a nonzero bilinear weight when ``n_in`` samples
    fill ``n_out`` outputs (normalized coordinate i / n_out, clamp to
    edge)."""
    x = np.arange(n_out, dtype=np.float64) / n_out * n_in - 0.5
    x0 = np.floor(x)
    lo = np.clip(x0, 0, n_in - 1)
    hi = np.clip(x0 + 1, 0, n_in - 1)[x - x0 > 0]
    return np.unique(np.concatenate([lo, hi]).astype(np.int64))


def plane_sectors(in_w: int, in_h: int, out_w: int, out_h: int,
                  sector: int = SECTOR) -> int:
    """Sectors of a dense ``in_w`` x ``in_h`` u8 plane that hold a tap."""
    rows, cols = taps(in_h, out_h), taps(in_w, out_w)
    return np.unique((rows[:, None] * in_w + cols[None, :]) // sector).size


def stream_bytes(stream, cell, sector: int = SECTOR) -> int:
    (sw, sh), (cw, ch) = stream, cell
    return sector * (plane_sectors(sw, sh, cw, ch, sector)
                     + 2 * plane_sectors(sw // 2, sh // 2, cw // 2, ch // 2,
                                         sector))


def bytes_per_tick(config: dict) -> int:
    (W, H), (gw, gh) = config["canvas"], config["grid"]
    cell = (W // gw, H // gh)
    n = config["streams"]
    a = config["audio"]
    audio = (n + 1) * a["samples"] * a["channels"] * 2
    canvas = W * H + 2 * (W // 2) * (H // 2)
    return n * stream_bytes(config["stream_size"], cell) + canvas + audio
