"""The mixing wall: the program's ``MixingWall.step`` on one device, one
tick after the last.

The configuration gives the streams, their size, the canvas and its grid
of cells and the audio a stream a tick; the traffic gives the ring of
input batches made on the device from the seed (new addresses each tick,
as a decoder's surfaces would give), the audio level and how many ticks
the check samples.  A tick's latency runs from handing its batch to
``step`` to the host seeing the canvas and the mix complete (an event
recorded after the step, waited on).  On the card the default-cell tick
(no uniforms) is the cell launch; on the CPU, where the default cells take
float32 products instead, the driver hands the wall its own default
uniforms so the tiny CPU drive takes the plain per-cell fold.

The check works each sampled tick out again from its batch: every stream
composited alone onto its cell with the full-cell placement
(``reference.scene.FULL_CELL``), cells in row-major order, cells past the
last stream cleared, and the audio as the unity-gain sum.
"""

from __future__ import annotations

import time
from typing import Dict, List

import torch

from svbench.drivers.live import Reservoir
from svbench.reference import audio as ref_audio
from svbench.reference import composite as ref_comp
from svbench.reference.scene import FULL_CELL

LIMITS = {"video_max_lsb": 0, "audio_max_diff": 0}

# a CPU test's size: six 64x36 streams onto 3x3 cells of 16x8
TINY = {"streams": 6, "stream_size": [64, 36], "canvas": [48, 24],
        "grid": [3, 3]}


def tiny(config: dict, traffic: dict) -> dict:
    """Overrides that shrink a cell of this driver to a CPU test's size."""
    return {"config": TINY, "traffic": {}}


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int,
                 device: torch.device, spans=None):
        from swiftvideo_tpu_torch.ops import frame
        from swiftvideo_tpu_torch.parallel.wall import MixingWall
        self._frame = frame
        self.config, self.traffic, self.device = config, traffic, device
        self.spans = spans
        n = self.n = config["streams"]
        sw, sh = self.stream = tuple(config["stream_size"])
        self.canvas = tuple(config["canvas"])
        self.grid = tuple(config["grid"])
        a = config["audio"]
        samples = a["samples"] * a["channels"]
        gen = torch.Generator(device=device).manual_seed(seed)
        peak = traffic["audio_peak"]
        self.ring = []
        for _ in range(traffic["ring"]):
            ys = torch.randint(0, 256, (n, sh, sw), dtype=torch.uint8,
                               device=device, generator=gen)
            us, vs = (torch.randint(0, 256, (n, sh // 2, sw // 2),
                                    dtype=torch.uint8, device=device,
                                    generator=gen) for _ in range(2))
            au = torch.randint(-peak, peak + 1, (n, samples),
                               dtype=torch.int16, device=device,
                               generator=gen)
            self.ring.append((ys, us, vs, au))
        self.wall = MixingWall(n_streams=n, stream_size=self.stream,
                               canvas_size=self.canvas, grid=self.grid,
                               audio_samples=a["samples"],
                               channels=a["channels"], device=device)
        self._unis = (self.wall.default_uniforms() if device.type == "cpu"
                      else None)
        self.samples = Reservoir(traffic["sample_ticks"], seed)
        self.latencies: List[float] = []
        self.frames = self.attempted = 0
        self.t = 0

    def tick(self) -> None:
        batch = self.ring[self.t % len(self.ring)]
        cuda = self.device.type == "cuda"
        t0 = time.perf_counter_ns()
        out = self.wall.step(*batch, uniforms=self._unis)
        if cuda:
            ev = torch.cuda.Event()
            ev.record()
            ev.synchronize()
        t1 = time.perf_counter_ns()
        if self.spans is not None:
            self.spans.add("tick", t0, t1)
        self.attempted += 1
        self.frames += 1
        self.latencies.append((t1 - t0) / 1e9)
        self.samples.offer(self.t, out)
        self.t += 1

    def warm(self) -> None:
        for _ in range(self.traffic["warm_ticks"]):
            self.tick()
        self.frames = self.attempted = 0
        self.latencies = []

    def inputs(self) -> List[torch.Tensor]:
        """Every input the program is handed, as tensors."""
        return [t for batch in self.ring for t in batch]

    def counters(self) -> Dict[str, int]:
        return {"launches": self._frame.launches}

    def release(self) -> None:
        self.wall = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def expected(self, t: int, dtype=torch.float32):
        ys, us, vs, au = self.ring[t % len(self.ring)]
        (W, H), (gw, gh) = self.canvas, self.grid
        cw, ch = W // gw, H // gh
        canvas = ref_comp.clear_y420p((W, H), self.device)
        for i in range(self.n):
            r, c = divmod(i, gw)
            cell = ref_comp.composite_y420p(
                (cw, ch), [([ys[i], us[i], vs[i]], False, FULL_CELL)],
                self.device, dtype)
            for plane, part in zip(canvas, cell):
                ph, pw = part.shape
                plane[r * ph:(r + 1) * ph, c * pw:(c + 1) * pw] = part
        gains = torch.ones(self.n, device=au.device)
        return canvas + [ref_audio.wall_mix(au, gains, dtype)]

    def check(self, dtype=torch.float32, stand_in=None) -> Dict[str, tuple]:
        """{number: (value, limit)}; ``stand_in`` replaces the program's
        outputs by the reference in that precision (the control)."""
        want, got = {}, {}
        lsb = diff = 0
        for t, outs in zip(self.samples.keys, self.samples.slots):
            b = t % len(self.ring)
            if b not in want:
                want[b] = self.expected(t, dtype)
                if stand_in is not None:
                    got[b] = self.expected(t, stand_in)
            have = got[b] if stand_in is not None else outs
            for a, e in zip(have[:3], want[b][:3]):
                lsb = max(lsb, int((a.int() - e.int()).abs().max()))
            diff = max(diff, int((have[3].int() - want[b][3].int())
                                 .abs().max()))
        values = {"video_max_lsb": lsb, "audio_max_diff": diff}
        return {k: (v, LIMITS[k]) for k, v in values.items()}
