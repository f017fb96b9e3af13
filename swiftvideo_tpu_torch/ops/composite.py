"""Plain composite: the per-pixel algorithm of the golden oracle in torch.

This is ``swiftvideo_tpu/ops/golden.py`` (clear, z-ordered fold,
``bilinear_norm`` clamp-to-edge sampling, border / element / texture masks,
family A and family B blends, u8 quantize after every source) written as
whole-grid torch ops on an explicit device.  It is the reference the
frame kernel (ops/frame.py) is held against and the CPU path of the port;
on the card no composite takes it.

Bit-exactness with golden rests on doing the same float32 operations in
the same order, each rounded on its own:

* the u8 read is a table of ``v / 255`` built with numpy (torch's CUDA
  division by a scalar multiplies by its reciprocal, which is not golden's
  division);
* the pixel-grid NDC vectors (``x / W * 2 - 1``) are built with numpy for
  the same reason;
* per-source scalars (``1 - opacity``, the fill colour's csc) are computed
  in numpy float32 exactly as golden computes them;
* every product and sum is its own torch op, so nothing is contracted into
  an FMA.

The quantize uses ``torch.round``, which rounds half to even like
``np.rint``.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..media.pixel import (PixelFormat, num_planes, packed422_to_planar,
                           plane_array_shape, planar_to_packed422)

from .color import RGB2YUV, YUV2RGB

YUV_PLANAR = (PixelFormat.y420p, PixelFormat.y422p, PixelFormat.y444p)
YUV_BIPLANAR = (PixelFormat.nv12, PixelFormat.nv21)
RGBA_FAMILY = (PixelFormat.RGBA, PixelFormat.BGRA)
YUV_FAMILY = YUV_PLANAR + YUV_BIPLANAR
PACKED_422 = (PixelFormat.yuvs, PixelFormat.zvuy)

_U8_TO_F = np.arange(256, dtype=np.float32) / np.float32(255.0)

# composite_stack_torch calls since import: on the card, a run can show
# that its frames did not take the plain route
calls = 0


def packed(uni) -> np.ndarray:
    """The [29] float32 uniform vector of an ImageUniforms-like object
    (anything with ``pack()``) or of an already packed vector."""
    p = uni.pack() if hasattr(uni, "pack") else uni
    return np.asarray(p, dtype=np.float32)


def is_axis_aligned(p: np.ndarray, eps: float = 1e-7) -> bool:
    """True when none of the three packed affines has a cross term (no
    rotation or shear): every map is separable into a row and a column
    side (golden.is_axis_aligned)."""
    p = np.asarray(p)
    return bool(abs(p[1]) < eps and abs(p[2]) < eps
                and abs(p[7]) < eps and abs(p[8]) < eps
                and abs(p[13]) < eps and abs(p[14]) < eps)


@lru_cache(maxsize=8)
def _u8_lut(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_U8_TO_F).to(device)


def _to_f(plane: torch.Tensor) -> torch.Tensor:
    return _u8_lut(plane.device)[plane.to(torch.int64)]


def _to_u8(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x * 255.0), 0, 255).to(torch.uint8)


@lru_cache(maxsize=32)
def _grid_ndc(h: int, w: int, device: torch.device):
    """normpos (px [1, w], py [h, 1]) of an h x w grid."""
    xs = np.arange(w, dtype=np.float32) / np.float32(w) * np.float32(2.0) \
        - np.float32(1.0)
    ys = np.arange(h, dtype=np.float32) / np.float32(h) * np.float32(2.0) \
        - np.float32(1.0)
    return (torch.from_numpy(xs).to(device)[None, :],
            torch.from_numpy(ys).to(device)[:, None])


def _affine(c: np.ndarray, x: torch.Tensor, y: torch.Tensor):
    """Packed 2D affine [a, b, c, d, tx, ty] applied as golden._affine."""
    return (x * float(c[0]) + y * float(c[1]) + float(c[4]),
            x * float(c[2]) + y * float(c[3]) + float(c[5]))


def _inside(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (x >= 0.0) & (x <= 1.0) & (y >= 0.0) & (y <= 1.0)


def _masks(p: np.ndarray, h: int, w: int, device: torch.device):
    px, py = _grid_ndc(h, w, device)
    tx_x, tx_y = _affine(p[0:6], px, py)
    uv_x, uv_y = _affine(p[6:12], tx_x, tx_y)
    bd_x, bd_y = _affine(p[12:18], px, py)
    return (_inside(bd_x, bd_y), _inside(tx_x, tx_y), _inside(uv_x, uv_y),
            uv_x, uv_y)


def bilinear_norm(plane: torch.Tensor, u: torch.Tensor,
                  v: torch.Tensor) -> torch.Tensor:
    """OpenCL-style normalized bilinear sample with clamp-to-edge
    (golden.bilinear_norm, general path).  ``plane``: [H, W] or [H, W, C]
    float; ``u``/``v``: normalized coords of one shape."""
    h, w = plane.shape[:2]
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    xi0 = torch.clamp(x0, 0, w - 1).to(torch.int64)
    xi1 = torch.clamp(x0 + 1, 0, w - 1).to(torch.int64)
    yi0 = torch.clamp(y0, 0, h - 1).to(torch.int64)
    yi1 = torch.clamp(y0 + 1, 0, h - 1).to(torch.int64)
    if plane.dim() == 3:
        fx = fx[..., None]
        fy = fy[..., None]
    top = plane[yi0, xi0] * (1.0 - fx) + plane[yi0, xi1] * fx
    bot = plane[yi1, xi0] * (1.0 - fx) + plane[yi1, xi1] * fx
    return top * (1.0 - fy) + bot * fy


def _csc_yuv_np(rgb: np.ndarray) -> np.ndarray:
    """RGB2YUV rows on a homogeneous [r, g, b, 1] (numpy float32, golden's
    operation order)."""
    m = RGB2YUV
    return np.array([m[i, 0] * rgb[0] + m[i, 1] * rgb[1] + m[i, 2] * rgb[2]
                     + m[i, 3] for i in range(3)], dtype=np.float32)


def _csc_yuv(r, g, b, i: int) -> torch.Tensor:
    m = RGB2YUV
    return (r * float(m[i, 0]) + g * float(m[i, 1]) + b * float(m[i, 2])
            + float(m[i, 3]))


def clear_planes(fmt: PixelFormat, size: Tuple[int, int],
                 device: torch.device) -> List[torch.Tensor]:
    """Cleared target: luma 0, chroma 128, rgba (0, 0, 0, 255)."""
    if fmt not in YUV_FAMILY + RGBA_FAMILY:
        raise ValueError(f"unsupported target format {fmt}")
    planes = [torch.zeros(plane_array_shape(fmt, size, i), dtype=torch.uint8,
                          device=device) for i in range(num_planes(fmt))]
    if fmt in RGBA_FAMILY:
        planes[0][..., 3] = 255
    else:
        for chroma in planes[1:]:
            chroma.fill_(128)
    return planes


def _sample_rgba(planes, in_fmt, u, v) -> List[torch.Tensor]:
    rgba = bilinear_norm(_to_f(planes[0]), u, v)
    order = (2, 1, 0, 3) if in_fmt == PixelFormat.BGRA else (0, 1, 2, 3)
    return [rgba[..., c] for c in order]


def _sample_uv(planes, in_fmt, u, v) -> List[torch.Tensor]:
    """[cb, cr] samples of a yuv source."""
    if in_fmt in YUV_PLANAR:
        return [bilinear_norm(_to_f(planes[1]), u, v),
                bilinear_norm(_to_f(planes[2]), u, v)]
    uv = bilinear_norm(_to_f(planes[1]), u, v)
    first, second = uv[..., 0], uv[..., 1]
    return [second, first] if in_fmt == PixelFormat.nv21 else [first, second]


def _composite_yuv_grid(curs, src_planes, in_fmt, p, luma: bool):
    """One source over one grid of a yuv target.  ``curs``: the grid's u8
    channels, luma [y] or chroma [cb, cr] (target-layout independent)."""
    h, w = curs[0].shape
    device = curs[0].device
    m_border, m_tx, m_uv, uv_x, uv_y = _masks(p, h, w, device)
    op = p[22]
    fill = p[18:22]
    chans = (0,) if luma else (1, 2)
    outs = []
    if in_fmt in YUV_FAMILY:
        # family A (kernels.cl.swift:186-255)
        fill_yuv = _csc_yuv_np(fill[:3])
        a_fill = op * fill[3]
        lo = 0.0 if luma else -1.0
        samples = ([bilinear_norm(_to_f(src_planes[0]), uv_x, uv_y)] if luma
                   else _sample_uv(src_planes, in_fmt, uv_x, uv_y))
        inside = m_border & m_tx & m_uv
        for cur_u8, ch, sample in zip(curs, chans, samples):
            cur = _to_f(cur_u8)
            blended = cur * float(1 - op) + sample * float(op)
            filled = torch.clamp(cur * float(1 - a_fill)
                                 + float(fill_yuv[ch] * a_fill), lo, 1.0)
            out = torch.where(inside, blended,
                              torch.where(m_border, filled, cur))
            outs.append(_to_u8(out))
        return outs
    if in_fmt not in RGBA_FAMILY:
        raise ValueError(f"unsupported source format {in_fmt}")
    # family B: rgba input (kernels.cl.swift:267-532)
    a_fill = op * fill[3]
    fill_yuv = _csc_yuv_np(fill[:3] * a_fill)
    r, g, b, a = _sample_rgba(src_planes, in_fmt, uv_x, uv_y)
    a_s = a * float(op)
    write_mask = m_border & m_tx
    for cur_u8, ch in zip(curs, chans):
        cur = _to_f(cur_u8)
        res = cur * float(1 - a_fill) + float(fill_yuv[ch] * a_fill)
        if not luma:
            res = torch.clamp(res, -1.0, 1.0)
        yuv_s = _csc_yuv(r * a_s, g * a_s, b * a_s, ch)
        res = torch.where(m_uv, res * (1.0 - a_s) + yuv_s * a_s, res)
        outs.append(_to_u8(torch.where(write_mask, res, cur)))
    return outs


def _composite_rgba_out(cur_u8, out_fmt, src_planes, in_fmt, p):
    """RGBA-family target (golden._composite_rgba_out, the blit blend)."""
    h, w = cur_u8.shape[:2]
    m_border, m_tx, m_uv, uv_x, uv_y = _masks(p, h, w, cur_u8.device)
    op = p[22]
    fill = p[18:22]
    swz = (2, 1, 0, 3) if out_fmt == PixelFormat.BGRA else (0, 1, 2, 3)
    cur = _to_f(cur_u8)
    cur_rgba = [cur[..., c] for c in swz]
    if in_fmt in RGBA_FAMILY:
        r, g, b, a = _sample_rgba(src_planes, in_fmt, uv_x, uv_y)
        alpha = a * float(op)
        new = [r, g, b, torch.ones_like(a)]
    elif in_fmt in YUV_FAMILY:
        y = bilinear_norm(_to_f(src_planes[0]), uv_x, uv_y)
        cb, cr = _sample_uv(src_planes, in_fmt, uv_x, uv_y)
        m = YUV2RGB
        new = [y * float(m[i, 0]) + cb * float(m[i, 1]) + cr * float(m[i, 2])
               + float(m[i, 3]) for i in range(3)] + [torch.ones_like(y)]
        alpha = torch.full_like(y, float(op))
    else:
        raise ValueError(f"unsupported source format {in_fmt}")
    a_fill = op * fill[3]
    fill_rgba = (fill[0], fill[1], fill[2], np.float32(1.0))
    inside = m_border & m_tx & m_uv
    outs = []
    for k in range(4):
        blended = cur_rgba[k] * (1.0 - alpha) + new[k] * alpha
        filled = torch.clamp(cur_rgba[k] * float(1 - a_fill)
                             + float(fill_rgba[k] * a_fill), 0.0, 1.0)
        outs.append(torch.where(inside, blended,
                                torch.where(m_border, filled, cur_rgba[k])))
    return _to_u8(torch.stack([outs[c] for c in swz], dim=-1))


def apply_composite(target: Sequence[torch.Tensor], out_fmt: PixelFormat,
                    src_planes: Sequence[torch.Tensor], in_fmt: PixelFormat,
                    uni) -> List[torch.Tensor]:
    """One source composited over the current target planes (one reference
    kernel launch, compute.cl.swift:264-344).  Returns new u8 planes."""
    p = packed(uni)
    if out_fmt in RGBA_FAMILY:
        return [_composite_rgba_out(target[0], out_fmt, src_planes, in_fmt, p)]
    luma = _composite_yuv_grid([target[0]], src_planes, in_fmt, p, True)
    if out_fmt in YUV_PLANAR:
        return luma + _composite_yuv_grid([target[1], target[2]], src_planes,
                                          in_fmt, p, False)
    if out_fmt not in YUV_BIPLANAR:
        raise ValueError(f"unsupported target format {out_fmt}")
    # biplanar target channel order: nv12 = cbcr, nv21 = crcb
    nv21 = out_fmt == PixelFormat.nv21
    cb_i, cr_i = (1, 0) if nv21 else (0, 1)
    cb, cr = _composite_yuv_grid([target[1][..., cb_i], target[1][..., cr_i]],
                                 src_planes, in_fmt, p, False)
    pair = (cr, cb) if nv21 else (cb, cr)
    return luma + [torch.stack(pair, dim=-1)]


def _unpack(packed: torch.Tensor, fmt: PixelFormat) -> List[torch.Tensor]:
    """A packed 4:2:2 plane as contiguous y422p planes, by torch ops on its
    own device."""
    return [t.contiguous() for t in packed422_to_planar(packed, fmt, torch)]


def unpack_sources(sources) -> list:
    """``sources`` with every packed 4:2:2 (yuvs / zvuy) source as y422p
    planes (the normalisation of golden.composite_stack)."""
    return [(_unpack(planes[0], fmt), PixelFormat.y422p, uni)
            if fmt in PACKED_422 else (planes, fmt, uni)
            for planes, fmt, uni in sources]


def composite_stack_torch(out_fmt: PixelFormat, size: Tuple[int, int],
                          sources, device: torch.device,
                          target=None) -> List[torch.Tensor]:
    """Clear (or start from ``target``) and fold z-sorted ``sources``
    (mix.video.swift:116-125 semantics).  ``sources``: sequence of
    (planes, in_fmt, ImageUniforms or packed [29] vector); planes are u8
    tensors on ``device``.  Packed 4:2:2 sources and targets go through
    y422p planes, as golden.composite_stack does."""
    global calls
    calls += 1
    device = torch.device(device)
    packed_out = out_fmt in PACKED_422
    fold_fmt = PixelFormat.y422p if packed_out else out_fmt
    if target is None:
        planes = clear_planes(fold_fmt, size, device)
    else:
        planes = _unpack(target[0], out_fmt) if packed_out else list(target)
    for src_planes, in_fmt, uni in unpack_sources(sources):
        planes = apply_composite(planes, fold_fmt, src_planes, in_fmt, uni)
    return ([planar_to_packed422(planes, out_fmt, torch)] if packed_out
            else planes)
