"""An audio ingest node: every live publisher's decoded AAC converted to
the station's rate and format by its own sample-rate conversion stage,
the program's ``AudioSampleRateConversion`` on its card route, one frame
a publisher a tick, one tick after the last.

The configuration gives the streams, their channels, the input and output
rates and formats, the frame size (a list of sizes is taken in turn: the
CPU tests' ragged frames), the filter's taps a phase and the threads for
torch's CPU ops (``torch_threads``, for spread); the traffic gives
the ring, the signal, the clipped frames, the warm-up and how many frames
the check samples.  Each stream's input is a seeded programme-like signal
on a host ring of ``ring_frames`` frames, read round and round: three
tones a channel, log-uniform between ``tone_hz``, at ``level_dbfs`` RMS
together, white noise at ``noise_dbfs``, and in a ``clip_share`` of the
frames a 1 kHz burst that peaks at ``burst_peak`` (past full scale, so the
s16 clip runs).  The signal is drawn on the cell's device and kept on the
host as f32p frames, as a decoder hands them over.  Each tick hands every
stream its next frame: views of the ring at new addresses, in a new
``AudioSample`` with the stream's pts (1 / in_rate s from a seeded start),
through ``stage(sample)``.  Every input frame converted counts as one
frame; a tick's latency runs from the first stream's sample to the last
stream's output.

The stages are built as ``cli.py transcode`` builds them on a card:
``AudioSampleRateConversion(out_rate, channels, out_format,
use_device=True, device=<the cell's device>)``; on the CPU the same route
runs its product with torch on the CPU.

The check, after the window, works everything out from the seed and the
frames fed (``svbench/reference/resample.py``):

* every stream's emitted sample count (``audio_count_diff``: the largest
  difference, limit 0) and pts (``audio_pts_gaps``: the emitted samples
  whose pts is not the last one's plus its count, and the streams whose
  first or last pts is not the reference's, limit 0);
* a seeded reservoir of ``sample_frames`` emitted samples of the window,
  one (stream, frame) each, each recomputed by the reference from the
  stream's first input sample on: ``audio_max_diff``, the largest
  difference of an s16 sample, limit 1.

Why 1 LSB: the program sums a sample's 24 float32 products in the order
of the card's GEMM (the other 146 terms of a row of the ``[160, 170]``
phase matrix are exact zeros) and the reference in torch's reduction
order, so the two float32 sums can differ in their last bit, and the
rounding to s16 then flips where y · 32768 lies within that of a half.
Anything coarser fails: TF32 (about 2^-11 relative on each input) moves a
sample at −18 dBFS (about 4100 LSB) by several LSB, and the bfloat16
control (2^-8) by tens.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from svbench.reference import resample as ref

LIMITS = {"audio_count_diff": 0, "audio_pts_gaps": 0, "audio_max_diff": 1}

# a CPU test's size: two streams, frames of four sizes in turn (the
# 7-sample one emits nothing by itself), a ring that frames straddle
TINY = {"config": {"streams": 2, "frame_samples": [1024, 7, 441, 2048]},
        "traffic": {"ring_frames": 6, "clip_share": 0.3, "warm_ticks": 3,
                    "sample_frames": 24}}


def tiny(config: dict, traffic: dict) -> dict:
    """Overrides that shrink a cell of this driver to a CPU test's size."""
    return TINY


def _signal(config: dict, traffic: dict, seed: int,
            device: torch.device) -> np.ndarray:
    """[streams, channels, ring] float32: the seeded programme signal."""
    sizes = config["frame_samples"]
    frame = sizes if isinstance(sizes, int) else sizes[0]
    n, c = config["streams"], config["channels"]
    rate = config["in_rate"]
    length = traffic["ring_frames"] * frame
    gen = torch.Generator(device=device).manual_seed(seed)

    def uniform(*shape):
        return torch.rand(shape, generator=gen, device=device,
                          dtype=torch.float64)

    lo, hi = traffic["tone_hz"]
    tones = traffic["tones"]
    hz = lo * (hi / lo) ** uniform(n, c, tones, 1)
    phase = 2 * np.pi * uniform(n, c, tones, 1)
    t = torch.arange(length, device=device, dtype=torch.float64) / rate
    level = 10 ** (traffic["level_dbfs"] / 20)
    noise = 10 ** (traffic["noise_dbfs"] / 20)
    # equal tones whose sum has the level's RMS with the noise's beside it
    amp = np.sqrt(2.0 * max(level ** 2 - noise ** 2, 0.0) / tones)
    x = torch.zeros((n, c, length), device=device, dtype=torch.float64)
    for k in range(tones):
        x += amp * torch.sin(2 * np.pi * hz[:, :, k] * t + phase[:, :, k])
    x += noise * torch.randn((n, c, length), generator=gen, device=device,
                             dtype=torch.float64)
    # the bursts: a Hann-shaped 1 kHz tone over a seeded stretch of a frame
    width = min(traffic["burst_samples"], frame)
    clipped = uniform(n, traffic["ring_frames"]) < traffic["clip_share"]
    at = (uniform(n, traffic["ring_frames"]) * (frame - width)).long()
    u = torch.arange(width, device=device, dtype=torch.float64)
    burst = (traffic["burst_peak"] * torch.sin(np.pi * u / (width - 1)) ** 2
             * torch.sin(2 * np.pi * 1000.0 * u / rate))
    for s, f in clipped.nonzero().tolist():
        a = f * frame + int(at[s, f])
        x[s, :, a:a + width] += burst
    return x.to(torch.float32).cpu().numpy()


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int,
                 device: torch.device, spans=None):
        from swiftvideo_tpu_torch.core import TimePoint
        from swiftvideo_tpu_torch.media.audio import AudioSample
        from swiftvideo_tpu_torch.mix.src_audio import (
            AudioSampleRateConversion)
        self._sample, self._tp = AudioSample, TimePoint
        self.config, self.traffic, self.device = config, traffic, device
        self.spans = spans
        if config.get("torch_threads"):
            # the ingest's threads for torch's CPU ops in its process
            torch.set_num_threads(int(config["torch_threads"]))
        self.n = config["streams"]
        self.channels = config["channels"]
        self.in_rate, self.out_rate = config["in_rate"], config["out_rate"]
        self.in_format = config["in_format"]
        sizes = config["frame_samples"]
        self.sizes = [sizes] if isinstance(sizes, int) else list(sizes)
        self.ring = _signal(config, traffic, seed, device)
        self.ring_len = self.ring.shape[-1]
        rng = np.random.default_rng(seed)
        # each publisher's first pts, 1 / in_rate s, up to ~13.5 h in
        self.pts0 = rng.integers(0, 2**31, self.n).tolist()
        self.names = [f"publisher{s}" for s in range(self.n)]
        self.stages = [AudioSampleRateConversion(
            self.out_rate, self.channels, config["out_format"],
            use_device=True, device=device) for _ in range(self.n)]
        self.design = ref.design(self.in_rate, self.out_rate,
                                 config["taps_per_phase"])
        # what the program emitted, per stream, from the stream's start
        self.emitted = [0] * self.n
        self.first_pts: List = [None] * self.n
        self.last_pts: List = [None] * self.n
        self.next_pts: List = [None] * self.n
        self.gaps = 0
        # the reservoir of (tick, stream, s16 samples), the window's only
        self.pick = np.random.default_rng([seed, 1])
        self.kept: List[tuple] = []
        self.offered = 0
        self.latencies: List[float] = []
        self.frames = self.attempted = 0
        self.t = self.fed = 0

    def _frames(self, size: int):
        """Every stream's next frame as its channels' buffers."""
        a = self.fed % self.ring_len
        if a + size <= self.ring_len:
            return [tuple(self.ring[s, :, a:a + size]) for s in range(self.n)]
        idx = (a + np.arange(size)) % self.ring_len
        return [tuple(self.ring[s][:, idx]) for s in range(self.n)]

    def tick(self) -> None:
        size = self.sizes[self.t % len(self.sizes)]
        tp, rate = self._tp, self.in_rate
        t0 = time.perf_counter_ns()
        outs = []
        for s, (stage, bufs) in enumerate(zip(self.stages,
                                              self._frames(size))):
            pts = tp(self.pts0[s] + self.fed, rate)
            outs.append(stage(self._sample(
                buffers=bufs, frequency=rate, channels=self.channels,
                format=self.in_format, sample_count=size, time_point=pts,
                pts_value=pts, id_asset=self.names[s],
                id_workspace="ingest")).value())
        t1 = time.perf_counter_ns()
        if self.spans is not None:
            self.spans.add("tick", t0, t1)
        self.attempted += self.n
        self.frames += self.n
        self.latencies.append((t1 - t0) / 1e9)
        for s, out in enumerate(outs):
            if out is None:
                continue
            pts = out.pts()
            if pts.scale != self.out_rate:
                self.gaps += 1
            if self.first_pts[s] is None:
                self.first_pts[s] = pts.value
            elif pts.value != self.next_pts[s]:
                self.gaps += 1
            self.last_pts[s] = pts.value
            self.next_pts[s] = pts.value + out.number_samples()
            self.emitted[s] += out.number_samples()
        self._offer(outs)
        self.t += 1
        self.fed += size

    def _offer(self, outs) -> None:
        """Algorithm R over the window's ticks, one seeded stream a kept
        tick."""
        k = self.traffic["sample_frames"]
        n = self.offered
        self.offered += 1
        slot = n if n < k else int(self.pick.integers(0, n + 1))
        if slot >= k:
            return
        s = int(self.pick.integers(0, self.n))
        out = outs[s]
        pcm = (np.concatenate([np.asarray(b) for b in out.data()])
               if out is not None else np.zeros(0, np.int16))
        entry = (self.t, s, pcm.copy())
        if n < k:
            self.kept.append(entry)
        else:
            self.kept[slot] = entry

    def warm(self) -> None:
        for _ in range(self.traffic["warm_ticks"]):
            self.tick()
        self.frames = self.attempted = 0
        self.latencies = []
        self.kept, self.offered = [], 0

    def inputs(self) -> List[torch.Tensor]:
        """Every input the program is handed, as tensors."""
        return [torch.from_numpy(self.ring)]

    def counters(self) -> Dict[str, int]:
        return {}

    def release(self) -> None:
        self.stages = None

    def _fed_before(self, t: int) -> int:
        cycle = len(self.sizes)
        return (t // cycle) * sum(self.sizes) + sum(self.sizes[:t % cycle])

    def _last_count(self) -> int:
        """The reference's count of the last frame that emitted."""
        t = self.t
        while t > 0:
            a, b = self._fed_before(t - 1), self._fed_before(t)
            got = ref.emitted(self.design, b) - ref.emitted(self.design, a)
            if got:
                return got
            t -= 1
        return 0

    def expected(self, t: int, s: int, dtype=torch.float32) -> torch.Tensor:
        """The reference's s16 samples of stream ``s``'s output for frame
        ``t``, interleaved."""
        d = self.design
        fed = self._fed_before(t)
        n0 = ref.emitted(d, fed)
        n1 = ref.emitted(d, fed + self.sizes[t % len(self.sizes)])
        if n1 == n0:
            return torch.zeros(0, dtype=torch.int16)
        a, b = ref.inputs_needed(d, n0, n1)
        a = max(a, 0)
        ring = torch.from_numpy(self.ring[s]).to(self.device)
        x = ring[:, torch.arange(a, b, device=self.device) % self.ring_len]
        return ref.to_s16(ref.outputs(d, x, n0, n1, a, dtype)).cpu()

    def check(self, dtype=torch.float32, stand_in=None) -> Dict[str, tuple]:
        """{number: (value, limit)}; ``stand_in`` replaces the program's
        samples by the reference in that precision (the control)."""
        d = self.design
        want = ref.emitted(d, self.fed)
        count_diff = max(abs(e - want) for e in self.emitted)
        gaps = self.gaps
        last = want - self._last_count()
        for s in range(self.n):
            first = ref.first_pts(self.pts0[s], self.in_rate, self.out_rate)
            if want == 0:
                gaps += self.first_pts[s] is not None
            elif (self.first_pts[s], self.last_pts[s]) != (first,
                                                           first + last):
                gaps += 1
        diff = 0
        for t, s, pcm in self.kept:
            expect = self.expected(t, s, dtype)
            have = (self.expected(t, s, stand_in) if stand_in is not None
                    else torch.from_numpy(pcm))
            if have.shape != expect.shape:
                diff = max(diff, 65535)
            elif expect.numel():
                diff = max(diff, int((have.int() - expect.int()).abs().max()))
        return {"audio_count_diff": (count_diff, LIMITS["audio_count_diff"]),
                "audio_pts_gaps": (gaps, LIMITS["audio_pts_gaps"]),
                "audio_max_diff": (diff, LIMITS["audio_max_diff"])}
