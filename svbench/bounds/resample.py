"""The least time the card could take for one call of the resampler's
device product: each new input sample read once and each output written
once, as float32 bytes, at the HBM's rate, or 2 · K operations an output
(K taps, a multiply and an add each) at the float32 rate outside the tensor
cores, whichever is larger.  The dense ``[L, R]`` product the port runs
is not counted: the bound is the filter's work, whatever computes it."""

from __future__ import annotations

from svbench.bounds import peaks

# NVIDIA's data sheet for one H100 SXM at 700 W: float32 outside the
# tensor cores
FP32_FLOPS = 67e12


def bytes_per_call(channels: int, in_samples: float,
                   out_samples: float) -> float:
    return 4 * channels * (in_samples + out_samples)


def flops_per_call(channels: int, out_samples: float, taps: int) -> float:
    return 2 * taps * channels * out_samples


def seconds_per_call(channels: int, in_samples: float, out_samples: float,
                     taps: int) -> float:
    return max(bytes_per_call(channels, in_samples, out_samples)
               / peaks.HBM_BPS,
               flops_per_call(channels, out_samples, taps) / FP32_FLOPS)
