"""A transcoder node's rendition ladder: every channel's new frame scaled to
every rung of the ladder by the program's ``matscale.scale_ladder``, one
tick after the last.

The configuration gives the channels, the frame size and format and the
rungs; the traffic gives the ring of input batches on the device, how far
a channel pans a frame, the noise, the warm-up and how many ticks the
check samples.  Batch k of the ring holds frame k of every channel: each
channel's frames are crops of its own seeded texture, panned by a seeded
integer velocity (at most ``pan_px`` a frame on each axis) and overlaid
with seeded luma noise of at most ``noise_lsb``, as the motion cells make
them, so that neighbouring taps differ.  Each tick takes the next batch,
at new addresses, as a decoder's surfaces would give.  The rungs' plans
(``matscale.plan_scale`` of ``identity_uniforms``) are made once at
set-up.  A tick's latency runs from handing its batch to ``scale_ladder``
to the host seeing every rung complete on the card (an event recorded
after the call, waited on).  Every channel's frame counts as one frame.
On the card a tick is one ``scale_ladder`` call; on the CPU, where the
ladder takes float32 products instead, the driver hands the cell wrapper
(``frame.composite_cells_cuda``) each plan's uniforms so that the tiny
CPU drive takes the plain per-cell fold.

The check works each sampled tick out again from its batch: every
channel's frame at every rung, composited alone with the full-cell
placement onto a cleared canvas of the rung's size
(``reference.ladder.rung``).
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from svbench.drivers.live import Reservoir
from svbench.drivers.motion import _texture
from svbench.reference import ladder as ref_ladder

LIMITS = {"video_max_lsb": 0}

# a CPU test's size: two 96x54 channels to three rungs, the last with an
# odd chroma height and width (13x7)
TINY = {"config": {"channels": 2, "frame": {"size": [96, 54],
                                             "format": "y420p"},
                   "rungs": [[64, 36], [48, 28], [26, 14]]},
        "traffic": {"ring": 3, "pan_px": 4, "warm_ticks": 2,
                    "sample_ticks": 4}}


def tiny(config: dict, traffic: dict) -> dict:
    """Overrides that shrink a cell of this driver to a CPU test's size."""
    return TINY


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int,
                 device: torch.device, spans=None):
        from swiftvideo_tpu_torch.ops import frame, matscale
        from swiftvideo_tpu_torch.ops.uniforms import identity_uniforms
        self._frame, self._matscale = frame, matscale
        self.config, self.traffic, self.device = config, traffic, device
        self.spans = spans
        n = self.n = config["channels"]
        w, h = self.size = tuple(config["frame"]["size"])
        if config["frame"]["format"] != "y420p":
            raise ValueError("the ladder cells take y420p frames")
        self.rungs = [tuple(r) for r in config["rungs"]]
        ring, pan = traffic["ring"], traffic["pan_px"]
        noise = traffic["noise_lsb"]
        gen = torch.Generator(device=device).manual_seed(seed)
        span = (ring - 1) * pan
        # the ring of batches: batch k holds frame k of every channel
        self.ring = [(torch.empty((n, h, w), dtype=torch.uint8, device=device),
                      torch.empty((n, h // 2, w // 2), dtype=torch.uint8,
                                  device=device),
                      torch.empty((n, h // 2, w // 2), dtype=torch.uint8,
                                  device=device)) for _ in range(ring)]
        for c in range(n):
            vx, vy = (int(v) for v in torch.randint(
                -pan, pan + 1, (2,), generator=gen, device=device))
            y_tex = _texture(h + span, w + span, gen, device)
            c_tex = [_texture((h + span) // 2, (w + span) // 2, gen, device)
                     for _ in range(2)]
            x0, y0 = max(0, -vx) * (ring - 1), max(0, -vy) * (ring - 1)
            for k, (ys, us, vs) in enumerate(self.ring):
                x, y = x0 + k * vx, y0 + k * vy
                grain = torch.randint(-noise, noise + 1, (h, w),
                                      generator=gen, device=device)
                ys[c] = torch.clamp(y_tex[y:y + h, x:x + w].int() + grain,
                                    0, 255)
                for plane, tex in zip((us, vs), c_tex):
                    plane[c] = tex[y // 2:y // 2 + h // 2,
                                   x // 2:x // 2 + w // 2]
        del y_tex, c_tex
        self.plans = []
        for rung in self.rungs:
            plan = matscale.plan_scale(identity_uniforms(self.size, rung),
                                       rung, (h, w))
            if plan is None:
                raise ValueError(f"no scale plan from {self.size} to {rung}")
            self.plans.append(plan)
        self._unis = ([np.broadcast_to(p.uniform, (n, p.uniform.shape[0]))
                       for p in self.plans] if device.type == "cpu" else None)
        self.samples = Reservoir(traffic["sample_ticks"], seed)
        self.latencies: List[float] = []
        self.frames = self.attempted = 0
        self.t = 0

    def _cpu_ladder(self, ys, us, vs):
        """The plain per-cell fold of every rung, shaped as the ladder's."""
        from swiftvideo_tpu_torch.media.pixel import PixelFormat
        out = []
        for plan, unis in zip(self.plans, self._unis):
            (ow, oh), n = plan.out_size, ys.shape[0]
            y, u, v = self._frame.composite_cells_cuda(
                plan.out_size, [ys, us, vs], PixelFormat.y420p, unis)
            out.append((y.view(n, oh, ow), u.view(n, oh // 2, ow // 2),
                        v.view(n, oh // 2, ow // 2)))
        return out

    def tick(self) -> None:
        batch = self.ring[self.t % len(self.ring)]
        cuda = self.device.type == "cuda"
        t0 = time.perf_counter_ns()
        if cuda:
            rungs = self._matscale.scale_ladder(*batch, self.plans)
            ev = torch.cuda.Event()
            ev.record()
            ev.synchronize()
        else:
            rungs = self._cpu_ladder(*batch)
        t1 = time.perf_counter_ns()
        if self.spans is not None:
            self.spans.add("tick", t0, t1)
        self.attempted += self.n
        self.frames += self.n
        self.latencies.append((t1 - t0) / 1e9)
        self.samples.offer(self.t, [p for r in rungs for p in r])
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
        self.plans = self._unis = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def expected(self, b: int, c: int, r: int, dtype=torch.float32):
        """The reference's planes of channel ``c`` of batch ``b`` at rung
        ``r``."""
        ys, us, vs = self.ring[b]
        return ref_ladder.rung((ys[c], us[c], vs[c]), self.rungs[r], dtype)

    def check(self, dtype=torch.float32, stand_in=None) -> Dict[str, tuple]:
        """{number: (value, limit)}; ``stand_in`` replaces the program's
        rungs by the reference in that precision (the control)."""
        by_batch: Dict[int, list] = {}
        for t, outs in zip(self.samples.keys, self.samples.slots):
            by_batch.setdefault(t % len(self.ring), []).append(outs)
        lsb = 0
        if any(len(outs) != 3 * len(self.rungs)
               for ticks in by_batch.values() for outs in ticks):
            lsb = 255
        for b, ticks in by_batch.items():
            for r in range(len(self.rungs)):
                for c in range(self.n):
                    want = self.expected(b, c, r, dtype)
                    if stand_in is not None:
                        have = [self.expected(b, c, r, stand_in)] * len(ticks)
                    else:
                        have = [[p[c] for p in outs[3 * r:3 * r + 3]]
                                for outs in ticks]
                    for planes in have:
                        for a, e in zip(planes, want):
                            if a.shape != e.shape:
                                lsb = max(lsb, 255)
                                continue
                            lsb = max(lsb, int((a.int() - e.int()).abs()
                                               .max()))
        return {"video_max_lsb": (lsb, LIMITS["video_max_lsb"])}
