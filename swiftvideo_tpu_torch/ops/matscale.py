"""Bilinear scale of y420p planes as two dense products: ``out = V @ X @ H``.

``V`` [oh, ih] and ``H`` [iw, ow] are two-tap clamp-to-edge hat matrices
built on the host from a plan's geometry; ``X`` is the source plane as
float32.  Any axis-aligned full-coverage scale (the transcode ladder's
1080p -> 720p / 480p / 360p rungs, the mixing wall's 1080 -> 136 tiles) is
two matrix products with no gathers.  This is the counterpart of
``swiftvideo_tpu/ops/matscale.py``, which the JAX package computes outside
any Pallas kernel; here the products are ``torch.matmul`` on the planes'
device.

Precision: the products run in full float32 and ``check_fp32_matmul``
raises when PyTorch's TF32 switches are on (ops/fp32.py).  Each output is
a sum of at most four taps whose weights sum to 1, so the product is
within a few float32 ulps of golden's bilinear sample and the u8 result
within 1 LSB of golden (tests/test_torch_matscale.py, and chip_smoke.py
on the card).  The quantize is ``torch.round`` (half to even, like
``jnp.rint``), then a clamp to [0, 255].

Geometry comes from ``_plane_params_np``, a float32 copy of the frame
kernel's plane algebra operation for operation (the plan is
parity-critical: one ulp moves a tap), so a plan built from composite
uniforms samples like the plain composite's separable path.  The hat
matrices are built once per plan and copied once per device
(``ScalePlan.on``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .composite import is_axis_aligned
from .fp32 import check_fp32_matmul


def _plane_params_np(packed: np.ndarray, h_out: int, w_out: int,
                     h_in: int, w_in: int) -> np.ndarray:
    """The per-plane affine scalars of a packed uniform vector, float32 op
    by op: [ay, by, ax, bx] (src_y = ay*r + by, src_x = ax*c + bx), then
    the texture and border maps' row and column terms."""
    p = np.asarray(packed, np.float32)
    t0, t3, t4, t5 = p[0], p[3], p[4], p[5]
    e0, e3, e4, e5 = p[6], p[9], p[10], p[11]
    b0, b3, b4, b5 = p[12], p[15], p[16], p[17]
    f = np.float32
    a_tx_x = f(t0 * f(2.0) / f(w_out))
    b_tx_x = f(t4 - t0)
    a_uv_x = f(e0 * a_tx_x)
    b_uv_x = f(f(e0 * b_tx_x) + e4)
    ax = f(a_uv_x * f(w_in))
    bx = f(f(b_uv_x * f(w_in)) - f(0.5))
    a_tx_y = f(t3 * f(2.0) / f(h_out))
    b_tx_y = f(t5 - t3)
    a_uv_y = f(e3 * a_tx_y)
    b_uv_y = f(f(e3 * b_tx_y) + e5)
    ay = f(a_uv_y * f(h_in))
    by = f(f(b_uv_y * f(h_in)) - f(0.5))
    a_bd_x = f(b0 * f(2.0) / f(w_out))
    b_bd_x = f(b4 - b0)
    a_bd_y = f(b3 * f(2.0) / f(h_out))
    b_bd_y = f(b5 - b3)
    return np.array([ay, by, ax, bx, a_tx_y, b_tx_y, a_tx_x, b_tx_x,
                     a_bd_y, b_bd_y, a_bd_x, b_bd_x], np.float32)


def hat_matrix(n_out: int, n_in: int, a: float, b: float,
               transpose: bool = False) -> np.ndarray:
    """Two-tap bilinear sampling matrix with clamp-to-edge taps.

    Row r carries weight (1-f) at floor(x) and f at floor(x)+1 for
    x = clip(a*r + b, 0, n_in-1); when x clamps, the single surviving tap
    carries the full weight (golden.bilinear_norm's clipped xi0 / xi1).
    """
    r = np.arange(n_out, dtype=np.float64)
    x = np.float32(a) * r.astype(np.float32) + np.float32(b)
    x = np.clip(x, 0.0, np.float32(n_in - 1))
    k0 = np.floor(x).astype(np.int64)
    f = (x - k0).astype(np.float32)
    k1 = np.minimum(k0 + 1, n_in - 1)
    m = np.zeros((n_out, n_in), np.float32)
    m[np.arange(n_out), k0] += (1.0 - f)
    m[np.arange(n_out), k1] += f
    return m.T if transpose else m


@dataclass(frozen=True, eq=False)
class ScalePlan:
    """Host-built sampling matrices for one y420p -> y420p geometry."""

    vy: np.ndarray   # [oh, ih]
    hy: np.ndarray   # [iw, ow]
    vc: np.ndarray   # [oh/2, ih/2]
    hc: np.ndarray   # [iw/2, ow/2]
    out_size: Tuple[int, int]
    _on: Dict[torch.device, Tuple[torch.Tensor, ...]] = field(
        default_factory=dict, init=False, repr=False)

    def on(self, device: torch.device) -> Tuple[torch.Tensor, ...]:
        """(vy, hy, vc, hc) as float32 tensors on ``device``, copied there
        on first use."""
        mats = self._on.get(device)
        if mats is None:
            mats = tuple(torch.from_numpy(np.ascontiguousarray(m)).to(device)
                         for m in (self.vy, self.hy, self.vc, self.hc))
            self._on[device] = mats
        return mats


def plan_scale(uniform, out_size: Tuple[int, int],
               in_shape: Tuple[int, int]) -> Optional[ScalePlan]:
    """A ScalePlan from composite uniforms, or None when the mapping is not
    a pure full-coverage scale (the caller then composites).

    Eligible: axis-aligned, opacity 1, the element's border and texture
    cover the whole output canvas (identity_uniforms-style mappings: the
    ladder rungs and wall cells), even sizes.
    """
    w, h = out_size
    h_in, w_in = in_shape
    p = np.asarray(uniform.pack() if hasattr(uniform, "pack") else uniform,
                   np.float64)
    if not is_axis_aligned(p):
        return None
    if abs(float(p[22]) - 1.0) > 1e-9:        # opacity
        return None
    pl_ = _plane_params_np(np.asarray(p, np.float32), h, w, h_in, w_in)
    ay, by, ax, bx = (float(pl_[0]), float(pl_[1]),
                      float(pl_[2]), float(pl_[3]))
    if ay <= 0 or ax <= 0:
        return None
    # border and texture must cover every output pixel (the corners
    # suffice: the maps are affine)
    for (aa, bb, n) in ((pl_[4], pl_[5], h), (pl_[6], pl_[7], w),
                        (pl_[8], pl_[9], h), (pl_[10], pl_[11], w)):
        lo = float(aa) * 0.0 + float(bb)
        hi = float(aa) * (n - 1) + float(bb)
        if not (min(lo, hi) >= -1e-6 and max(lo, hi) <= 1.0 + 1e-6):
            return None
    if h % 2 or w % 2 or h_in % 2 or w_in % 2:
        return None
    pc = _plane_params_np(np.asarray(p, np.float32), h // 2, w // 2,
                          h_in // 2, w_in // 2)
    ayc, byc, axc, bxc = (float(pc[0]), float(pc[1]),
                          float(pc[2]), float(pc[3]))
    return ScalePlan(
        vy=hat_matrix(h, h_in, ay, by),
        hy=hat_matrix(w, w_in, ax, bx, transpose=True),
        vc=hat_matrix(h // 2, h_in // 2, ayc, byc),
        hc=hat_matrix(w // 2, w_in // 2, axc, bxc, transpose=True),
        out_size=out_size,
    )


def _scale_plane(x: torch.Tensor, v: torch.Tensor,
                 hmat: torch.Tensor) -> torch.Tensor:
    """u8 [..., ih, iw] -> u8 [..., oh, ow]; a leading batch axis
    broadcasts against ``v``."""
    if not isinstance(x, torch.Tensor) or x.dtype != torch.uint8:
        raise TypeError("planes must be uint8 tensors")
    if tuple(x.shape[-2:]) != (v.shape[1], hmat.shape[0]):
        raise ValueError(f"plane {tuple(x.shape)} does not fit a plan from "
                         f"{(v.shape[1], hmat.shape[0])}")
    s = torch.matmul(torch.matmul(v, x.to(torch.float32)), hmat)
    return torch.clamp(torch.round(s), 0, 255).to(torch.uint8)


def _scale_planes(y, cb, cr, plan: ScalePlan):
    check_fp32_matmul()
    vy, hy, vc, hc = plan.on(y.device)
    return (_scale_plane(y, vy, hy), _scale_plane(cb, vc, hc),
            _scale_plane(cr, vc, hc))


def scale_y420p(planes: Sequence[torch.Tensor], plan: ScalePlan):
    """Scale one y420p frame (y [ih, iw], cb, cr [ih/2, iw/2], u8 tensors
    on one device) to ``plan.out_size``; returns three u8 tensors there."""
    y, cb, cr = planes
    return _scale_planes(y, cb, cr, plan)


def scale_y420p_batch(ys: torch.Tensor, us: torch.Tensor, vs: torch.Tensor,
                      plan: ScalePlan):
    """[N, ih, iw] luma and [N, ih/2, iw/2] chroma -> [N, oh, ow] and
    [N, oh/2, ow/2]: the stream axis is the products' batch axis (no loop
    over streams)."""
    return _scale_planes(ys, us, vs, plan)
