"""A rendition ladder's rungs in the plain reference: each frame scaled to
a rung's size is the frame composited alone, with the full-cell placement
(``scene.FULL_CELL``: the element, its border and its texture cover the
whole canvas, opacity 1), onto a cleared canvas of that size."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from .composite import composite_y420p
from .scene import FULL_CELL


def rung(planes: Sequence[torch.Tensor], size: Tuple[int, int],
         dtype=torch.float32) -> List[torch.Tensor]:
    """The y420p frame ``planes`` (three u8 planes on one device) at the
    rung ``size`` = (w, h)."""
    return composite_y420p(size, [(list(planes), False, FULL_CELL)],
                           planes[0].device, dtype)
