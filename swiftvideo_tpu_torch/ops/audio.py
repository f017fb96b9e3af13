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

The mixing wall's N-way mix (``mix_wall_s16_cuda``: gain, float32 sum over
the streams, trunc, s16 clamp) is a hand-written kernel on the card,
``csrc/audio_mix.cu``, built on first use with ``nvcc`` and launched on
the current stream by ops/nvcc.py (``SIGNATURES`` declares its C entry);
CPU tensors take its plain version, ``mix_wall_s16_torch``.  ``launches``
counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence, Tuple

import numpy as np
import torch

from . import nvcc


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


# --- the mixing wall's mix (csrc/audio_mix.cu) ------------------------------

SOURCE = nvcc.CSRC / "audio_mix.cu"
KERNEL = "wall_audio_kernel"

# the C entry of audio_mix.cu, {name: (restype, [argtypes])}
SIGNATURES = {"sv_wall_audio": (ctypes.c_int, [ctypes.c_void_p] * 3
                                + [ctypes.c_int] * 3 + [ctypes.c_void_p])}

# launches of the wall's mix kernel since import; a plain integer so a run
# can show that its mixes went through the kernel
launches = 0


def build() -> ctypes.CDLL:
    """Compile (once per source/flags digest) and load the mix kernel's
    library."""
    return nvcc.load(SOURCE, SIGNATURES)


def wall_sum_f32(audio: torch.Tensor, gains: torch.Tensor) -> torch.Tensor:
    """The float32 sum over streams of ``gains[s] * audio[s]``: [S, n] s16
    with [S] float32 gains -> [n] float32 (torch.sum's order)."""
    return torch.sum(audio.to(torch.float32) * gains[:, None], dim=0)


def saturate_s16(total: torch.Tensor) -> torch.Tensor:
    """A float32 sum to s16: trunc toward zero, clamp to [-32768, 32767]."""
    return torch.clamp(torch.trunc(total), -32768, 32767).to(torch.int16)


def mix_wall_s16_torch(audio: torch.Tensor, gains: torch.Tensor) -> torch.Tensor:
    """The plain version of ``mix_wall_s16_cuda``, on the tensors' device."""
    return saturate_s16(wall_sum_f32(audio, gains))


def mix_wall_s16_in_order(audio: torch.Tensor,
                          gains: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in plain torch, its contract for any gains:
    the sum from 0.0 over stream 0 to S - 1 in order, each float32 product
    and each add rounded on its own, then trunc and the s16 clamp."""
    acc = torch.zeros(audio.shape[1], dtype=torch.float32,
                      device=audio.device)
    for s in range(audio.shape[0]):
        acc = acc + audio[s].to(torch.float32) * gains[s]
    return saturate_s16(acc)


def _check_wall(audio, gains) -> torch.device:
    """Validate a wall mix's inputs; returns the device they live on."""
    if not isinstance(audio, torch.Tensor) or audio.dtype != torch.int16:
        raise TypeError("audio must be an int16 tensor")
    if not isinstance(gains, torch.Tensor) or gains.dtype != torch.float32:
        raise TypeError("gains must be a float32 tensor")
    if audio.dim() != 2 or gains.shape != audio.shape[:1]:
        raise ValueError(f"audio {tuple(audio.shape)} and gains "
                         f"{tuple(gains.shape)} are not [streams, samples] "
                         f"and [streams]")
    if not (audio.is_contiguous() and gains.is_contiguous()):
        raise ValueError("audio and gains must be contiguous")
    dev = audio.device
    if gains.device != dev:
        raise ValueError(f"gains on {gains.device}, audio on {dev}")
    return dev


def mix_wall_s16_cuda(audio: torch.Tensor, gains: torch.Tensor) -> torch.Tensor:
    """Mix [S, n] contiguous s16 ``audio`` with [S] contiguous float32
    ``gains`` on the same device into [n] s16: for every sample, trunc of
    the float32 sum of ``gains[s] * audio[s]``, clamped to s16.

    On the card one launch of ``wall_audio_kernel`` into a new tensor, on
    the current stream: it sums stream 0 to S - 1 in order, each product
    and each add rounded to float32 on its own, which equals the plain
    version wherever every partial sum is exact (unity or power-of-two
    gains below 2**24) and is the kernel's contract elsewhere
    (``mix_wall_s16_in_order``).  CPU tensors take the plain version
    (``mix_wall_s16_torch``)."""
    global launches
    dev = _check_wall(audio, gains)
    if dev.type == "cpu":
        return mix_wall_s16_torch(audio, gains)
    if dev.type != "cuda":
        raise ValueError(f"the wall's mix kernel runs on cuda, not {dev}")
    streams, samples = audio.shape
    if streams >= 2**31 or samples >= 2**31:
        raise ValueError(f"audio {tuple(audio.shape)} is too large a launch")
    out = torch.empty(samples, dtype=torch.int16, device=dev)
    if samples == 0:
        return out
    nvcc.launch(build().sv_wall_audio, dev, audio.data_ptr(), gains.data_ptr(),
                out.data_ptr(), streams, samples)
    launches += 1
    return out


# --- audio stats (stats.audio.swift:19-86) --------------------------------

def audio_peak_rms(buffers: Sequence[np.ndarray], fmt: str,
                   channels: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-channel (peak, rms) in [0,1] for s16/f32, planar or interleaved."""
    peaks = np.zeros(channels, np.float32)
    rms = np.zeros(channels, np.float32)
    planar = fmt.endswith("p")
    scale = 32768.0 if fmt.startswith("s16") else 1.0
    whole = np.asarray(buffers[0]) if len(buffers) and not planar else None
    if whole is not None and whole.size and channels \
            and whole.size % channels == 0:
        # one cast of the interleaved buffer into a row a channel: each
        # row is the channel's strided slice below, reduced along a
        # contiguous row as that slice is, so both are bit-equal
        data = whole.reshape(-1, channels).T.astype(np.float32, order="C")
        data /= scale
        peaks[:] = np.abs(data).max(axis=1)
        data *= data
        rms[:] = np.sqrt(data.mean(axis=1))
        return peaks, rms
    for ch in range(channels):
        if planar:
            data = np.asarray(buffers[ch]).astype(np.float32) / scale
        else:
            data = np.asarray(buffers[0]).astype(np.float32)[ch::channels] / scale
        if data.size:
            peaks[ch] = np.abs(data).max()
            rms[ch] = np.sqrt(np.mean(data * data))
    return peaks, rms
