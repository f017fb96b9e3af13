"""Plain composite of z-ordered sources onto a y420p canvas, in torch ops.

The per-pixel algorithm of SwiftVideo's compute kernels
(``kernels.cl.swift``): clear the canvas (luma 0, chroma 128), then fold
each source over it with OpenCL-style normalized bilinear sampling
(clamp to edge), the border / element / texture masks, the planar-yuv
blend (family A) or the RGBA blend (family B), and a u8 quantize after
every source.  Written for this benchmark and imported by nothing of the
program; it takes only planes and :class:`Placement` values that the
benchmark itself made.

``dtype`` is the precision of every operation: ``torch.float32`` is the
precision the configurations state, ``torch.bfloat16`` the control (the
nearest precision below).  In float32 each product and sum is its own
torch op and the per-source scalars are numpy float32, so nothing is
contracted into a multiply-add and every step rounds as the published
float32 algorithm does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch

# RGB -> YUV rows on [r, g, b, 1] (kernels.cl.swift:96-99, with the
# reference's 0.113 blue-luma coefficient)
RGB2YUV = np.array([[0.299, 0.587, 0.113, 0.0],
                    [-0.169, -0.331, 0.5, 0.5],
                    [0.5, -0.419, -0.081, 0.5],
                    [0.0, 0.0, 0.0, 1.0]], dtype=np.float32)
_U8 = np.arange(256, dtype=np.float32) / np.float32(255.0)


@dataclass(frozen=True)
class Placement:
    """Where a source lands: three inverse affines, each (a, b, c, d, tx,
    ty) for [[a, b, tx], [c, d, ty]] in float32 (canvas NDC -> element
    local, element local -> texture uv, canvas NDC -> border local), the
    fill colour (rgba in [0, 1]) and the opacity."""

    transform: np.ndarray
    texture: np.ndarray
    border: np.ndarray
    fill: np.ndarray
    opacity: np.float32


def _to_f(plane: torch.Tensor, dtype) -> torch.Tensor:
    lut = torch.from_numpy(_U8).to(plane.device).to(dtype)
    return lut[plane.to(torch.int64)]


def _to_u8(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x * 255.0), 0, 255).to(torch.uint8)


def _grid(h: int, w: int, device, dtype):
    xs = np.arange(w, dtype=np.float32) / np.float32(w) * np.float32(2.0) \
        - np.float32(1.0)
    ys = np.arange(h, dtype=np.float32) / np.float32(h) * np.float32(2.0) \
        - np.float32(1.0)
    return (torch.from_numpy(xs).to(device).to(dtype)[None, :],
            torch.from_numpy(ys).to(device).to(dtype)[:, None])


def _affine(c, x, y):
    return (x * float(c[0]) + y * float(c[1]) + float(c[4]),
            x * float(c[2]) + y * float(c[3]) + float(c[5]))


def _inside(x, y):
    return (x >= 0.0) & (x <= 1.0) & (y >= 0.0) & (y <= 1.0)


def bilinear(plane: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """Normalized bilinear sample, clamp to edge; ``plane`` [H, W] or
    [H, W, C]."""
    h, w = plane.shape[:2]
    x = u * w - 0.5
    y = v * h - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    # clamped in integers: a bfloat16 bound such as 1919 would round up
    xs, ys = x0.to(torch.int64), y0.to(torch.int64)
    xi0, xi1 = torch.clamp(xs, 0, w - 1), torch.clamp(xs + 1, 0, w - 1)
    yi0, yi1 = torch.clamp(ys, 0, h - 1), torch.clamp(ys + 1, 0, h - 1)
    if plane.dim() == 3:
        fx, fy = fx[..., None], fy[..., None]
    top = plane[yi0, xi0] * (1.0 - fx) + plane[yi0, xi1] * fx
    bot = plane[yi1, xi0] * (1.0 - fx) + plane[yi1, xi1] * fx
    return top * (1.0 - fy) + bot * fy


def _csc_np(rgb) -> np.ndarray:
    m = RGB2YUV
    return np.array([m[i, 0] * rgb[0] + m[i, 1] * rgb[1] + m[i, 2] * rgb[2]
                     + m[i, 3] for i in range(3)], dtype=np.float32)


def _csc(r, g, b, i):
    m = RGB2YUV
    return (r * float(m[i, 0]) + g * float(m[i, 1]) + b * float(m[i, 2])
            + float(m[i, 3]))


def _grid_fold(curs, planes, rgba: bool, p: Placement, luma: bool, dtype):
    """One source over the luma grid ([y]) or the chroma grid ([cb, cr])."""
    h, w = curs[0].shape
    px, py = _grid(h, w, curs[0].device, dtype)
    tx_x, tx_y = _affine(p.transform, px, py)
    uv_x, uv_y = _affine(p.texture, tx_x, tx_y)
    bd_x, bd_y = _affine(p.border, px, py)
    m_border, m_tx, m_uv = (_inside(bd_x, bd_y), _inside(tx_x, tx_y),
                            _inside(uv_x, uv_y))
    op, fill = p.opacity, p.fill
    chans = (0,) if luma else (1, 2)
    outs = []
    if not rgba:
        fill_yuv = _csc_np(fill[:3])
        a_fill = op * fill[3]
        lo = 0.0 if luma else -1.0
        samples = ([bilinear(_to_f(planes[0], dtype), uv_x, uv_y)] if luma
                   else [bilinear(_to_f(planes[1], dtype), uv_x, uv_y),
                         bilinear(_to_f(planes[2], dtype), uv_x, uv_y)])
        inside = m_border & m_tx & m_uv
        for cur_u8, ch, sample in zip(curs, chans, samples):
            cur = _to_f(cur_u8, dtype)
            blended = cur * float(1 - op) + sample * float(op)
            filled = torch.clamp(cur * float(1 - a_fill)
                                 + float(fill_yuv[ch] * a_fill), lo, 1.0)
            outs.append(_to_u8(torch.where(
                inside, blended, torch.where(m_border, filled, cur))))
        return outs
    a_fill = op * fill[3]
    fill_yuv = _csc_np(fill[:3] * a_fill)
    rgba_s = bilinear(_to_f(planes[0], dtype), uv_x, uv_y)
    r, g, b, a = (rgba_s[..., c] for c in range(4))
    a_s = a * float(op)
    write = m_border & m_tx
    for cur_u8, ch in zip(curs, chans):
        cur = _to_f(cur_u8, dtype)
        res = cur * float(1 - a_fill) + float(fill_yuv[ch] * a_fill)
        if not luma:
            res = torch.clamp(res, -1.0, 1.0)
        yuv_s = _csc(r * a_s, g * a_s, b * a_s, ch)
        res = torch.where(m_uv, res * (1.0 - a_s) + yuv_s * a_s, res)
        outs.append(_to_u8(torch.where(write, res, cur)))
    return outs


def clear_y420p(size: Tuple[int, int], device) -> List[torch.Tensor]:
    w, h = size
    return [torch.zeros((h, w), dtype=torch.uint8, device=device),
            torch.full((h // 2, w // 2), 128, dtype=torch.uint8, device=device),
            torch.full((h // 2, w // 2), 128, dtype=torch.uint8, device=device)]


def composite_y420p(size: Tuple[int, int], sources: Sequence, device,
                    dtype=torch.float32) -> List[torch.Tensor]:
    """Clear a y420p canvas of ``size`` = (w, h) and fold ``sources`` in
    order: each (planes, is_rgba, Placement), planes u8 tensors on
    ``device`` (three y420p planes, or one [H, W, 4] RGBA plane)."""
    canvas = clear_y420p(size, device)
    for planes, rgba, p in sources:
        canvas = (_grid_fold([canvas[0]], planes, rgba, p, True, dtype)
                  + _grid_fold([canvas[1], canvas[2]], planes, rgba, p, False,
                               dtype))
    return canvas
