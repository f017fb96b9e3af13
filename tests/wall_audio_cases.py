"""Inputs of the wall's audio mix for its CPU and card tests: seeded s16
audio under one kind of float32 gains."""

import numpy as np
import torch

# every sum an exact float32 integer: any order gives the plain result
EXACT_KINDS = ["unity", "power of two", "zero", "saturating"]


def case(kind, streams=64, samples=1600, seed=0):
    """(audio, gains) as host tensors: random s16 audio under unity,
    power-of-two, zero (every third stream) or random float32 gains, or
    full-scale audio whose sums saturate."""
    rng = np.random.default_rng(seed)
    audio = rng.integers(-32768, 32768, (streams, samples), np.int64)
    gains = np.ones(streams, np.float32)
    if kind == "power of two":
        gains = rng.choice(np.float32([0.25, 0.5, 1.0, 2.0]), streams)
    elif kind == "zero":
        gains[::3] = 0.0
    elif kind == "random":
        gains = rng.uniform(0.0, 1.7, streams).astype(np.float32)
    elif kind == "saturating":
        audio = np.where(np.arange(samples) % 2, 30000, -30000)[None].repeat(
            streams, 0)
    elif kind != "unity":
        raise ValueError(kind)
    return (torch.from_numpy(audio.astype(np.int16)),
            torch.from_numpy(gains.astype(np.float32)))
