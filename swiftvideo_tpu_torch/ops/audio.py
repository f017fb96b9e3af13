"""Audio mixing compute: sample-accurate sum/gain with s16 saturation.

Reference semantics:

* ``applyMixS16`` — the CPU hot loop (mix.audio.swift:260-294): for each
  int16 sample, ``out = clamp_s16(trunc(in * gain[channel]) + out)``.
* ``channelGains`` — smoothstep pan across channels placed on a circle
  (mix.audio.swift:237-258).
* ``snd_s16i_s16i`` — the dormant 8-input GPU mix kernel
  (kernels.cl.swift:534-562), here a fold of torch ops on the tensors'
  device: sources fold in order with saturating adds (order matters for
  saturation, so the fold is a loop over sources, not a sum).

The host functions stay numpy (they are the oracle and the small-tick
path); ``mix_s16_device`` / ``mix_s16_device_batched`` /
``mix_s16_device_windowed`` run on whatever device their input tensors
live on.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch


def smoothstep(edge0: float, edge1: float, val):
    """mix.audio.swift:303-306"""
    t = np.clip((val - edge0) / (edge1 - edge0), 0.0, 1.0)
    return t * t * (3 - 2 * t)


def channel_gains(position: Tuple[float, float], gain: float,
                  channel_count: int) -> np.ndarray:
    """Per-channel gains for a source at ``position`` (mix.audio.swift:237-258).
    Channels sit on a circle at angles theta*i + theta/2."""
    dims = min(channel_count - 1, 2)
    theta = 2.0 * math.pi / channel_count
    half = theta / 2.0
    out = np.empty(channel_count, dtype=np.float32)
    for idx in range(channel_count):
        px = math.cos(theta * idx + half) - position[0]
        py = math.sin(theta * idx + half) - position[1]
        if dims == 0:
            out[idx] = gain
        elif dims == 1:
            out[idx] = smoothstep(0.0, 0.5, 1.0 - px * 0.5) * gain
        else:
            dist = math.sqrt(px * px + py * py) * 0.5
            out[idx] = smoothstep(0.0, 0.5, 1.0 - dist) * gain
    return out


# --- host path (the oracle; mix.audio.swift:260-294) ----------------------

def apply_mix_s16(input_buf: np.ndarray, gains: Sequence[float],
                  backing: np.ndarray, backing_start: int = 0,
                  input_start: int = 0) -> int:
    """Saturating mix of int16 ``input_buf`` into ``backing`` in place.

    Offsets are in samples (int16 units), mirroring the byte-offset/2 math
    of the reference.  Returns the number of samples mixed, or -1 on bad
    offsets (reference returns -1 without mixing)."""
    if not (0 <= input_start < input_buf.size and
            0 <= backing_start < backing.size):
        return -1
    n = min(backing.size - backing_start, input_buf.size - input_start)
    if n <= 0:
        return 0
    gains = np.asarray(gains, dtype=np.float32)
    ch = gains.size
    idx = np.arange(n)
    g = gains[idx % ch]
    contrib = np.trunc(input_buf[input_start:input_start + n]
                       .astype(np.float32) * g).astype(np.int64)
    acc = contrib + backing[backing_start:backing_start + n].astype(np.int64)
    backing[backing_start:backing_start + n] = np.clip(
        acc, -32768, 32767).astype(np.int16)
    return n


# --- device path ----------------------------------------------------------

def _fold_args(inputs: torch.Tensor, gains, base, ndim: int = 2):
    """(gains on the inputs' device, the int32 accumulator: ``base`` or
    zeros, shaped as ``inputs`` without its source axis).  ``inputs`` must
    be an ``ndim``-dimensional int16 tensor: [S, n], or [B, S, n] when
    ``ndim`` is 3."""
    if not isinstance(inputs, torch.Tensor) or inputs.dtype != torch.int16 \
            or inputs.dim() != ndim:
        layout = "[B, S, n]" if ndim == 3 else "[S, n]"
        raise TypeError(f"inputs must be an {layout} int16 tensor")
    device = inputs.device
    gains = torch.as_tensor(gains, dtype=torch.float32, device=device)
    if base is None:
        acc = torch.zeros(inputs.shape[:-2] + inputs.shape[-1:],
                          dtype=torch.int32, device=device)
    else:
        acc = torch.as_tensor(base, device=device).to(torch.int32)
    return gains, acc


def mix_s16_device(inputs: torch.Tensor, gains, base=None) -> torch.Tensor:
    """Mix [S, n] int16 ``inputs`` with [S, C] gains over ``base`` ([n]
    int16, zeros when None), on the device ``inputs`` lives on.  Returns
    [n] int16.  i32 accumulation is exact: the fold clamps to s16 after
    every source, so magnitudes stay far inside i32."""
    gains, acc = _fold_args(inputs, gains, base)
    n = inputs.shape[1]
    ch = torch.arange(n, device=inputs.device) % gains.shape[-1]
    for s in range(inputs.shape[0]):
        contrib = torch.trunc(inputs[s].to(torch.float32)
                              * gains[s][ch]).to(torch.int32)
        acc = torch.clamp(acc + contrib, -32768, 32767)
    return acc.to(torch.int16)


def mix_s16_device_batched(inputs: torch.Tensor, gains,
                           base=None) -> torch.Tensor:
    """``mix_s16_device`` over a leading stream axis: [B, S, n] int16
    ``inputs`` with [B, S, C] gains over ``base`` ([B, n] int16, zeros when
    None) -> [B, n] int16, on the device ``inputs`` lives on.  Every stream
    folds its S sources in order with the same trunc and saturation; the
    loop is over sources, the streams are one tensor axis."""
    gains, acc = _fold_args(inputs, gains, base, ndim=3)
    n = inputs.shape[2]
    ch = torch.arange(n, device=inputs.device) % gains.shape[-1]
    for s in range(inputs.shape[1]):
        contrib = torch.trunc(inputs[:, s].to(torch.float32)
                              * gains[:, s][:, ch]).to(torch.int32)
        acc = torch.clamp(acc + contrib, -32768, 32767)
    return acc.to(torch.int16)


def mix_s16_device_windowed(inputs: torch.Tensor, gains, starts, ends,
                            base=None) -> torch.Tensor:
    """Mix [S, L] int16 buffers (zero-padded into backing alignment) with
    [S, C] gains, each source active on [starts[k], ends[k]) of the
    backing, with its gain phase anchored at ``starts[k]`` — exactly
    ``apply_mix_s16``'s ``idx % ch`` over the contribution range.
    Positions outside the span add 0 before the clamp; the accumulator is
    already inside [-32768, 32767] there, so the fold stays integer-equal
    to the sequential host loop."""
    gains, acc = _fold_args(inputs, gains, base)
    n = inputs.shape[1]
    channels = gains.shape[-1]
    idx = torch.arange(n, device=inputs.device)
    for s in range(inputs.shape[0]):
        lo, hi = int(starts[s]), int(ends[s])
        phase = torch.remainder(idx - lo, channels)
        contrib = torch.trunc(inputs[s].to(torch.float32)
                              * gains[s][phase]).to(torch.int32)
        contrib = torch.where((idx >= lo) & (idx < hi), contrib, 0)
        acc = torch.clamp(acc + contrib, -32768, 32767)
    return acc.to(torch.int16)


# --- audio stats (stats.audio.swift:19-86) --------------------------------

def audio_peak_rms(buffers: Sequence[np.ndarray], fmt: str,
                   channels: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-channel (peak, rms) in [0,1] for s16/f32, planar or interleaved."""
    peaks = np.zeros(channels, np.float32)
    rms = np.zeros(channels, np.float32)
    planar = fmt.endswith("p")
    scale = 32768.0 if fmt.startswith("s16") else 1.0
    for ch in range(channels):
        if planar:
            data = np.asarray(buffers[ch]).astype(np.float32) / scale
        else:
            data = np.asarray(buffers[0]).astype(np.float32)[ch::channels] / scale
        if data.size:
            peaks[ch] = np.abs(data).max()
            rms[ch] = np.sqrt(np.mean(data * data))
    return peaks, rms
