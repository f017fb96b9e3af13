"""Colorspace constants.

The RGB<->YUV matrices reproduce the reference kernels' BT.601-style
constants **exactly**, including the 0.113 blue-luma coefficient quirk
(reference uses 0.113 where BT.601 specifies 0.114 —
kernels.cl.swift:96-99); the golden oracle and device kernels must agree
with each other, and parity is defined against this spec.
"""

from __future__ import annotations

import numpy as np

# Rows: Y, U, V; applied to [r, g, b, 1] homogeneous vectors.
# (kernels.cl.swift:96-99 / kernels.cuda.swift analogue.)
RGB2YUV = np.array([
    [0.299, 0.587, 0.113, 0.0],
    [-0.169, -0.331, 0.5, 0.5],
    [0.5, -0.419, -0.081, 0.5],
    [0.0, 0.0, 0.0, 1.0],
], dtype=np.float32)

# Inverse mapping [y, u, v, 1] -> [r, g, b, 1], derived from RGB2YUV so that
# yuv->rgb conversion kernels (an extension over the reference's kernel set,
# needed for the y420p->RGBA benchmark config) are exactly consistent.
YUV2RGB = np.linalg.inv(RGB2YUV.astype(np.float64)).astype(np.float32)


def rgb_to_yuv(rgb: np.ndarray) -> np.ndarray:
    """[..., 3] rgb in [0,1] -> [..., 3] yuv (u, v centered at 0.5)."""
    h = np.concatenate([rgb, np.ones_like(rgb[..., :1])], axis=-1)
    return (h @ RGB2YUV.T)[..., :3]


def yuv_to_rgb(yuv: np.ndarray) -> np.ndarray:
    h = np.concatenate([yuv, np.ones_like(yuv[..., :1])], axis=-1)
    return (h @ YUV2RGB.T)[..., :3]
