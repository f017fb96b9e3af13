"""Plain audio mixes: the saturating s16 fold of SwiftVideo's audio mixer
(``mix.audio.swift:260-294``) and the wall's gain-weighted sum.

Mixer fold: for each source in order, ``out = clamp_s16(trunc(in *
gain[channel]) + out)``, channels interleaved.  Wall mix: ``clamp_s16(
trunc(sum over streams of in * gain))``.  ``dtype`` is the precision of the
products and sums: ``torch.float32`` as the configurations state,
``torch.bfloat16`` for the control.  Torch on whatever device the inputs
are on; imports nothing of the program.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


def fold_s16(sources: Sequence[Tuple[np.ndarray, np.ndarray]], n: int,
             dtype=torch.float32) -> np.ndarray:
    """The saturating fold of ``sources`` = [(interleaved int16 [..., n],
    per-channel float32 gains [..., C])] into zeroed int16 [..., n]; the
    leading axes are frames folded side by side."""
    acc = None
    for data, gains in sources:
        x = torch.from_numpy(np.asarray(data, np.int16)).to(dtype)
        g = torch.from_numpy(np.asarray(gains, np.float32)).to(dtype)
        ch = torch.arange(n) % g.shape[-1]
        contrib = torch.trunc(x * g[..., ch]).to(torch.int64)
        acc = contrib if acc is None else acc + contrib
        acc = torch.clamp(acc, -32768, 32767)
    return acc.to(torch.int16).numpy()


def wall_mix(audio: torch.Tensor, gains: torch.Tensor,
             dtype=torch.float32) -> torch.Tensor:
    """[N, n] int16 streams and [N] gains -> [n] int16."""
    total = torch.sum(audio.to(dtype) * gains.to(dtype)[:, None], dim=0)
    return torch.clamp(torch.trunc(total.to(torch.float64)), -32768,
                       32767).to(torch.int16)
