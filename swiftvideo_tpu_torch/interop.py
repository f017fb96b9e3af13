"""Carry the JAX package's composite inputs into this package.

There are no weights: the state both packages share is a frame's source
list.  ``to_port_sources`` turns ``swiftvideo_tpu`` source lists into
this package's, so that the two compute on the same data.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from .ops.composite import packed


def to_port_sources(sources: Sequence, device) -> List[Tuple[list, object, np.ndarray]]:
    """``[(planes, fmt, ImageUniforms | packed [29])]`` of the JAX package
    — planes as numpy or JAX-produced arrays, uniforms as either package's
    ``ImageUniforms`` or a packed vector — as ``[(u8 tensors on device,
    fmt, packed float32 [29])]``.  Arrays are copied through numpy;
    the packed layout is the same in both packages."""
    device = torch.device(device)
    return [([torch.from_numpy(np.array(p, dtype=np.uint8)).to(device)
              for p in planes], fmt, packed(uni).copy())
            for planes, fmt, uni in sources]
