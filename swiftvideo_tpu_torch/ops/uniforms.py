"""Composite kernel uniforms.

Reference semantics: ``ImageUniforms`` (compute.swift:76-86) built by
``applyComputeImage`` (compute.swift:145-170).  The reference passes
inverse-transpose matrices and applies them with a row-dot product; here the
uniforms carry the plain **inverse** matrices in column-vector convention —
the geometric effect (output-space sampling: output NDC -> element local ->
texture uv) is identical.

``ImageUniforms.pack()/unpack()`` flatten to a ``[UNIFORM_WIDTH]`` f32 vector
so a z-sorted stack of N sources rides into device kernels as one
``[N, UNIFORM_WIDTH]`` array (SMEM-friendly scalars for Pallas).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

from ..utils import matrix as m4

# packed layout: 6 affine coeffs each for transform/texture/border
# (a, b, c, d, tx, ty meaning [[a, b, tx], [c, d, ty]]) + fill rgba +
# opacity + in/out sizes + times
UNIFORM_WIDTH = 6 * 3 + 4 + 1 + 4 + 2


def _affine2_to_mat4(v: np.ndarray) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[0, 1], m[1, 0], m[1, 1], m[0, 3], m[1, 3] = v
    return m


@dataclass(frozen=True)
class ImageUniforms:
    """Per-source composite parameters (compute.swift:76-86)."""

    transform_inv: np.ndarray  # 4x4: output NDC -> element local [0,1]^2
    texture_inv: np.ndarray    # 4x4: element local -> texture uv
    border_inv: np.ndarray     # 4x4: output NDC -> border local [0,1]^2
    fill_color: np.ndarray     # rgba in [0,1]
    input_size: Tuple[int, int]
    output_size: Tuple[int, int]
    opacity: float = 1.0
    image_time: float = 0.0
    target_time: float = 0.0

    @staticmethod
    def from_sample(image, target) -> "ImageUniforms":
        """Build uniforms from a PictureSample pair (compute.swift:145-161).
        ``image.matrix()`` maps element-local [0,1]^2 to output NDC,
        ``image.texture_matrix()`` maps texture uv to element-local."""
        return ImageUniforms(
            transform_inv=m4.inverse(image.matrix()),
            texture_inv=m4.inverse(image.texture_matrix()),
            border_inv=m4.inverse(image.border_matrix()),
            fill_color=np.asarray(image.fill_color(), dtype=np.float32),
            input_size=image.size(),
            output_size=target.size(),
            opacity=float(image.opacity()),
        )

    def pack(self) -> np.ndarray:
        # one array construction: this runs for every source of every frame
        t, x, b = self.transform_inv, self.texture_inv, self.border_inv
        f = self.fill_color
        return np.array((t[0, 0], t[0, 1], t[1, 0], t[1, 1], t[0, 3], t[1, 3],
                         x[0, 0], x[0, 1], x[1, 0], x[1, 1], x[0, 3], x[1, 3],
                         b[0, 0], b[0, 1], b[1, 0], b[1, 1], b[0, 3], b[1, 3],
                         f[0], f[1], f[2], f[3], self.opacity,
                         *self.input_size, *self.output_size,
                         self.image_time, self.target_time), dtype=np.float32)

    @staticmethod
    def unpack(v: np.ndarray) -> "ImageUniforms":
        return ImageUniforms(
            transform_inv=_affine2_to_mat4(v[0:6]),
            texture_inv=_affine2_to_mat4(v[6:12]),
            border_inv=_affine2_to_mat4(v[12:18]),
            fill_color=np.asarray(v[18:22], dtype=np.float32),
            opacity=float(v[22]),
            input_size=(int(v[23]), int(v[24])),
            output_size=(int(v[25]), int(v[26])),
            image_time=float(v[27]), target_time=float(v[28]))


def identity_uniforms(input_size, output_size, *, opacity=1.0,
                      fill_color=(0, 0, 0, 0)) -> ImageUniforms:
    """Full-canvas passthrough: element covers the whole output."""
    # model matrix: [0,1]^2 -> NDC [-1,1]^2 is scale(2,2)+translate(-1,-1)
    model = m4.translation(-1.0, -1.0) @ m4.scale(2.0, 2.0)
    return ImageUniforms(
        transform_inv=m4.inverse(model),
        texture_inv=m4.identity4(),
        border_inv=m4.inverse(model),
        fill_color=np.asarray(fill_color, dtype=np.float32),
        input_size=tuple(input_size), output_size=tuple(output_size),
        opacity=opacity)


def rect_uniforms(input_size, output_size, *, x, y, w, h, opacity=1.0,
                  fill_color=(0, 0, 0, 0), rotation=0.0,
                  texture_matrix=None, border=None) -> ImageUniforms:
    """Place the source in a pixel rect of the output canvas — the common
    picture-in-picture transform (animator.pic.swift:229-272 geometry)."""
    ow, oh = output_size
    proj = m4.ortho(ow, oh)
    model = proj @ m4.translation(x, y) @ m4.rotation_z(rotation) @ m4.scale(w, h)
    if border is not None:
        bx, by, bw, bh = border
        bmodel = proj @ m4.translation(bx, by) @ m4.rotation_z(rotation) @ m4.scale(bw, bh)
    else:
        bmodel = model
    return ImageUniforms(
        transform_inv=m4.inverse(model),
        texture_inv=(m4.inverse(texture_matrix) if texture_matrix is not None
                     else m4.identity4()),
        border_inv=m4.inverse(bmodel),
        fill_color=np.asarray(fill_color, dtype=np.float32),
        input_size=tuple(input_size), output_size=tuple(output_size),
        opacity=opacity)
