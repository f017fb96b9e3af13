"""Plain rational sample-rate conversion: the polyphase FIR's published
design, summed tap by tap.

The design is the port's, in place of the reference's soxr (below): a
Kaiser-windowed sinc prototype ``h`` of N = K·L taps (K taps a phase,
Kaiser β, rolloff), cut off at rolloff · min(fs_in, fs_out) / 2 at the
upsampled rate fs_in · L, where L / M = fs_out / fs_in in lowest terms;
the K taps of each phase, ``h[q + L·j]`` for j < K, scaled to unit DC gain;
designed in float64 and cast to float32.

Output sample n of a stream is

    y[n] = sum over j < K of h[q + L·j] · x[floor(n·M / L) − j],
    q = n·M mod L,

which is sum_r h[n·M − L·r] · x[r] over the r where 0 <= n·M − L·r < N,
with x[r] = 0 for r < 0: a stream starts on silence (the program's zero
pre-pad, its ``r0``).  No ``[L, R]`` matrix, no window view, no FIFO.

Emission follows the program's granularity: outputs come in whole cycles
of L, and cycle c goes out once the last input any of its outputs needs,
x[c·M + r_hi] with r_hi = floor((L − 1)·M / L), has arrived; after n
input samples, L · max(0, floor((n − 1 − r_hi) / M) + 1) outputs are out
(``emitted``).  A flush feeds one window of zeros, r_hi − r_lo + 1
samples (``flush_samples``; r_lo is the earliest input offset any phase
reaches).  The first emitted sample's pts is the stream's first input pts
rescaled to the output rate, truncated toward zero; each later one is the
last plus its count.  The s16 output is clip(rint(y · 32768)).

``dtype`` is the precision of the products and the sum: ``torch.float32``
as the configurations state, ``torch.bfloat16`` for the control.  Torch
on whatever device the inputs are on, TF32 switched off; imports nothing
of the program.

Departures from the reference's soxr (``src.audio.ffmpeg.swift:134-147``:
``resampler=soxr``, precision 24, triangular dither):

* the filter is this 24-tap Kaiser design (> 90 dB stopband), not soxr's
  own, so the samples differ from soxr's by the two filters' difference;
* no dither: the s16 output is rounded to nearest, where soxr adds
  triangular dither before quantizing, so the output is a function of the
  input alone;
* no delay compensation: output 0 lies at input 0 with the prototype's
  group delay of (N − 1) / (2L) input samples after a start on silence;
* whole cycles of L outputs at a time, where soxr emits what it can.
"""

from __future__ import annotations

from dataclasses import dataclass
from math import gcd

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@dataclass(frozen=True)
class Design:
    """A conversion's filter: ``taps`` [L, K] float32 (row q: the phase's K
    taps, ``h[q + L·j]``, at unit DC gain), the ratio L / M and the input
    offsets r_lo..r_hi that a cycle's outputs reach from c·M."""

    taps: np.ndarray
    L: int
    M: int
    K: int
    r_lo: int
    r_hi: int


def design(in_rate: int, out_rate: int, taps_per_phase: int = 24,
           beta: float = 12.0, rolloff: float = 0.945) -> Design:
    g = gcd(in_rate, out_rate)
    L, M, K = out_rate // g, in_rate // g, taps_per_phase
    N = K * L
    wc = rolloff * 0.5 * min(in_rate, out_rate) / (in_rate * L)
    m = np.arange(N, dtype=np.float64)
    h = 2.0 * wc * np.sinc(2.0 * wc * (m - (N - 1) / 2.0)) * np.kaiser(N, beta)
    phases = h.reshape(K, L).T            # [L, K]: phases[q, j] = h[q + L j]
    phases = phases / phases.sum(axis=1, keepdims=True)
    r_lo = min(-((N - 1 - p * M) // L) for p in range(L))
    r_hi = max(p * M // L for p in range(L))
    return Design(phases.astype(np.float32), L, M, K, r_lo, r_hi)


def emitted(d: Design, fed: int) -> int:
    """Outputs out once ``fed`` input samples of a stream have arrived."""
    return d.L * max(0, (fed - 1 - d.r_hi) // d.M + 1)


def flush_samples(d: Design) -> int:
    """The zeros a flush feeds: one window, r_hi − r_lo + 1 samples."""
    return d.r_hi - d.r_lo + 1


def first_pts(value: int, scale: int, out_rate: int) -> int:
    """A pts of ``value`` / ``scale`` s in 1 / ``out_rate`` s, truncated
    toward zero."""
    if scale == out_rate:
        return value
    q = abs(value) * out_rate // scale
    return q if value >= 0 else -q


def inputs_needed(d: Design, n0: int, n1: int):
    """The first input index and one past the last that outputs
    ``n0``..``n1`` − 1 read."""
    return (n0 * d.M) // d.L - (d.K - 1), ((n1 - 1) * d.M) // d.L + 1


def outputs(d: Design, x: torch.Tensor, n0: int, n1: int, first: int = 0,
            dtype=torch.float32) -> torch.Tensor:
    """Outputs ``n0``..``n1`` − 1 of a stream, [C, n1 − n0] float32.
    ``x[:, r − first]`` is input sample r; samples before 0 are zeros (the
    start on silence), and so are those past the end of ``x`` (a flush's
    zeros)."""
    n = torch.arange(n0, n1, dtype=torch.int64, device=x.device)
    r = (n * d.M // d.L)[:, None] - torch.arange(d.K, device=x.device)
    idx = r - first
    valid = (r >= 0) & (idx >= 0) & (idx < x.shape[1])
    xs = torch.where(valid, x[:, idx.clamp(0, max(x.shape[1] - 1, 0))],
                     torch.zeros((), dtype=x.dtype, device=x.device))
    g = torch.from_numpy(d.taps).to(x.device)[n * d.M % d.L]
    return (xs.to(dtype) * g.to(dtype)).sum(-1).to(torch.float32)


def to_s16(y: torch.Tensor) -> torch.Tensor:
    """[C, n] float32 -> [n · C] int16, channels interleaved."""
    q = torch.clamp(torch.round(y * 32768.0), -32768, 32767)
    return q.to(torch.int16).T.reshape(-1)
