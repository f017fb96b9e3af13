"""Polyphase FIR sample-rate conversion (host route).

Replaces the reference's soxr-backed resampler (src.audio.ffmpeg.swift:
134-147: ``resampler=soxr, precision 24, triangular dither``) with a
Kaiser-windowed sinc prototype factored into L polyphase branches and
evaluated as **one dense matmul per cycle block** —

    out[c*L + p] = dot(H[p, :], x[c*M + r0 : c*M + r0 + R])

i.e. frame the input into overlapping [cycles, R] windows and contract with
the [L, R] phase-filter matrix.  The host route does it in numpy; the
device route (``use_device=True``) copies the windowed span of the FIFO to
the device, views it as [C, cycles, R] windows with ``Tensor.unfold`` (the
window starts step by M) and runs one full-float32 ``torch.matmul``
against H (ops/fp32.py raises when the TF32 switches are on).  Streaming
state stays on the host either way: an input FIFO with absolute sample
accounting so emitted (pts, count) bookkeeping is exact (the contract
asserted by the reference's sampleCountTest,
sampleRateConversionTests.swift:26-58).

Quality: default 24 taps/phase Kaiser beta 12 gives > 90 dB stopband —
within the tolerance band of soxr's 24-bit precision setting for the
benchmark configs (BASELINE.md config 2).

While the recorder is on (core/spans.py) each ``process`` call is a
``resample.process`` span, and on the device route the copy to the
device, the product's enqueue and the wait on its result are a
``resample.device`` span inside it; the counters ``resample.calls``,
``resample.device_calls`` (the calls that ran a device product),
``resample.in_samples`` and ``resample.out_samples`` (samples a channel
fed and emitted) add up the calls.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from math import gcd
from typing import List, Optional

import numpy as np
import torch

from ..core import spans
from ..media.audio import is_planar
from .fp32 import check_fp32_matmul
from .registry import make_compute_context


@lru_cache(maxsize=32)
def design_polyphase(in_rate: int, out_rate: int, taps_per_phase: int = 24,
                     beta: float = 12.0, rolloff: float = 0.945):
    """Build (H [L, R], r0, L, M): the polyphase matrix and window offset.

    Upsample-by-L / lowpass / downsample-by-M factorization:
    ``out[n] = sum_r h[n*M - L*r] * x[r]`` with h a length-``K*L``
    Kaiser-sinc lowpass at ``min(fs_in, fs_out)/2 * rolloff``, each phase row
    normalized to unit DC gain.
    """
    g = gcd(in_rate, out_rate)
    L, M = out_rate // g, in_rate // g
    K = taps_per_phase
    N = K * L
    center = (N - 1) / 2.0
    # cutoff in cycles/sample at the upsampled rate (in_rate * L):
    # pass min(in, out)/2 Hz, scaled by the rolloff margin
    wc = rolloff * 0.5 * min(in_rate, out_rate) / (in_rate * L)
    m = np.arange(N, dtype=np.float64)
    h = 2.0 * wc * np.sinc(2.0 * wc * (m - center)) * np.kaiser(N, beta)
    h *= L

    # phase p uses taps h[p*M - L*r]; valid r for p: (p*M - N, p*M] / L
    r_lo = min(-((N - 1 - p * M) // L) for p in range(L))  # ceil((p*M-N+1)/L)
    r_hi = max((p * M) // L for p in range(L))
    R = r_hi - r_lo + 1
    H = np.zeros((L, R), dtype=np.float64)
    for p in range(L):
        for j in range(R):
            idx = p * M - L * (r_lo + j)
            if 0 <= idx < N:
                H[p, j] = h[idx]
        s = H[p].sum()
        if s != 0:
            H[p] /= s
    return H.astype(np.float32), int(r_lo), L, M


def _windows_matmul_np(x: np.ndarray, H: np.ndarray, starts: np.ndarray) -> np.ndarray:
    R = H.shape[1]
    idx = starts[:, None] + np.arange(R)[None, :]
    return (np.take(x, idx, axis=-1) @ H.T)  # [..., cycles, L]


def windows_matmul_torch(span: torch.Tensor, h_t: torch.Tensor,
                         step: int) -> torch.Tensor:
    """[C, n] float32 ``span`` -> [C, cycles, L]: the R-sample windows at
    0, step, 2 step, ... (every one that fits) of every channel against
    ``h_t`` ([R, L], the phase filters transposed), on ``span``'s
    device."""
    return torch.matmul(span.unfold(-1, h_t.shape[0], step), h_t)


@dataclass
class _StreamState:
    buffer: np.ndarray          # [C, n] f32 backlog starting at abs index base
    base: int                   # absolute input index of buffer[:, 0]
    next_cycle: int             # next output cycle to compute


class PolyphaseResampler:
    """Streaming rational resampler for [C, n] float32 audio.

    ``use_device=True`` runs the filter product on ``device``, by default
    the current CUDA card (construction raises without one; tests pass
    ``"cpu"``).  The FIFO and the bookkeeping stay on the host, and
    ``process`` returns numpy in both routes."""

    def __init__(self, in_rate: int, out_rate: int, channels: int,
                 taps_per_phase: int = 24, use_device: bool = False,
                 device=None):
        self.in_rate = in_rate
        self.out_rate = out_rate
        self.channels = channels
        self.H, self.r0, self.L, self.M = design_polyphase(
            in_rate, out_rate, taps_per_phase)
        self.R = self.H.shape[1]
        self.taps_per_phase = taps_per_phase
        self.use_device = use_device
        self.device = None
        if use_device:
            self.device = make_compute_context(device).device
            self._h_t = torch.from_numpy(
                np.ascontiguousarray(self.H.T)).to(self.device)
        self._state: Optional[_StreamState] = None

    @property
    def latency_input_samples(self) -> float:
        """Group delay of the prototype filter in input samples:
        (N-1)/(2L) for the length N = K*L linear-phase prototype."""
        n = self.taps_per_phase * self.L
        return (n - 1) / (2.0 * self.L)

    def process(self, x: np.ndarray) -> np.ndarray:
        """Feed [C, n] samples; return [C, m] resampled output (possibly
        m == 0 while the filter fills)."""
        span = spans.ON and spans.begin("resample.process")
        x = np.asarray(x, dtype=np.float32)
        if x.ndim == 1:
            x = x[None, :]
        out = self._resample(x, span)
        if span:
            spans.count("resample.calls")
            spans.count("resample.in_samples", x.shape[1])
            spans.count("resample.out_samples", out.shape[1])
            spans.end(span)
        return out

    def _resample(self, x: np.ndarray, span) -> np.ndarray:
        if self._state is None:
            # pre-pad with zeros so cycle 0's window (which may reach
            # negative indices via r0) is defined; output starts aligned
            pad = max(0, -self.r0)
            self._state = _StreamState(
                buffer=np.zeros((self.channels, pad), np.float32),
                base=self.r0 if self.r0 < 0 else 0,
                next_cycle=0)
        st = self._state
        st.buffer = np.concatenate([st.buffer, x], axis=1)
        # cycle c needs inputs [c*M + r0, c*M + r0 + R)
        avail_end = st.base + st.buffer.shape[1]
        ncycles = (avail_end - self.r0 - self.R) // self.M - st.next_cycle + 1
        ncycles = max(0, ncycles)
        if ncycles == 0:
            return np.zeros((self.channels, 0), np.float32)
        starts = (st.next_cycle + np.arange(ncycles)) * self.M + self.r0 - st.base
        if self.use_device:
            check_fp32_matmul()
            # the FIFO's span from the first window's start to the last
            # window's end: exactly ncycles windows
            window = np.ascontiguousarray(
                st.buffer[:, int(starts[0]):int(starts[-1]) + self.R])
            device = span and spans.begin("resample.device")
            out = windows_matmul_torch(
                torch.from_numpy(window).to(self.device), self._h_t,
                self.M).cpu().numpy()
            if device:
                spans.end(device)
                spans.count("resample.device_calls")
        else:
            out = _windows_matmul_np(st.buffer, self.H, starts)
        out = out.reshape(self.channels, ncycles * self.L)
        st.next_cycle += ncycles
        # drop consumed history: keep from the next cycle's window start
        keep_from = st.next_cycle * self.M + self.r0 - st.base
        keep_from = max(0, keep_from)
        st.buffer = st.buffer[:, keep_from:]
        st.base += keep_from
        return out


# --- format conversion helpers (channel layout + dtype) --------------------

def to_planar_f32(buffers, fmt: str, channels: int) -> np.ndarray:
    """Decode AudioSample buffers to [C, n] float32 in [-1, 1]."""
    scale = np.float32(1.0 / 32768.0) if fmt.startswith("s16") else np.float32(1.0)
    if is_planar(fmt):
        chans = [np.asarray(b).astype(np.float32) * scale for b in buffers]
        return np.stack(chans[:channels], axis=0)
    inter = np.asarray(buffers[0]).astype(np.float32) * scale
    n = inter.size // channels
    return inter[:n * channels].reshape(n, channels).T.copy()


def from_planar_f32(x: np.ndarray, fmt: str) -> List[np.ndarray]:
    """Encode [C, n] float32 back to AudioSample buffers for ``fmt``."""
    if fmt.startswith("s16"):
        data = np.clip(np.rint(x * 32768.0), -32768, 32767).astype(np.int16)
    elif fmt.startswith("f64"):
        data = x.astype(np.float64)
    else:
        data = x.astype(np.float32)
    if is_planar(fmt):
        return [np.ascontiguousarray(data[c]) for c in range(data.shape[0])]
    return [np.ascontiguousarray(data.T.reshape(-1))]


def map_channels(x: np.ndarray, out_channels: int) -> np.ndarray:
    """Channel-count conversion: mono->N duplicates, N->mono averages,
    otherwise truncate / zero-pad (swr default-matrix-style behavior)."""
    c = x.shape[0]
    if c == out_channels:
        return x
    if c == 1:
        return np.broadcast_to(x, (out_channels, x.shape[1])).copy()
    if out_channels == 1:
        return x.mean(axis=0, keepdims=True)
    if c > out_channels:
        return x[:out_channels]
    pad = np.zeros((out_channels - c, x.shape[1]), x.dtype)
    return np.concatenate([x, pad], axis=0)
