"""Motion analysis on a multi-camera site: every camera's new frame searched
against its previous one, through the program's compute registry
(``registry.run_compute_kernel`` with the kernel the traffic names), one
tick after the last.

The configuration gives the cameras, the frame size and format, the block,
the search window and the refine radius; the traffic gives the motion
kernel (``me_fullsearch_pyramid`` or ``me_fullsearch``), each camera's
ring of frames on the device, how far a camera pans a frame, the noise,
the warm-up and how many maps the check samples.  Each camera's frames
are crops of its own seeded texture, panned by a seeded integer velocity
(at most ``pan_px`` a frame on each axis) and overlaid with seeded noise
of at most ``noise_lsb``; frame k of the ring is the k-th step of the
pan, so that the last frame of the ring steps back to the first.  The
frames are y420p samples whose planes are on the device, as a decoder's
surfaces would be; each camera's map target is one RGBA sample made once.

One tick searches every camera's frame t (of its ring) against frame
t - 1, then the host waits on an event recorded after the last search.
Every camera's map counts as one frame.  A seeded reservoir keeps a copy
of ``sample_maps`` maps, keyed by tick and camera.

The check works each sampled map out again from the two frames with the
plain reference (``reference.motion``) and counts the blocks whose
vector differs.
"""

from __future__ import annotations

import time
from typing import Dict, List

import torch

from svbench.drivers.live import Reservoir
from svbench.reference import motion as ref_motion

LIMITS = {"mv_blocks_differ": 0}

# a CPU test's size: two 128x96 cameras, one warm tick, four sampled maps
# (the exhaustive search's plain version takes about half a second a map
# on the CPU)
TINY = {"config": {"cameras": 2, "frame": {"size": [128, 96],
                                            "format": "y420p"}},
        "traffic": {"warm_ticks": 1, "sample_maps": 4}}


def tiny(config: dict, traffic: dict) -> dict:
    """Overrides that shrink a cell of this driver to a CPU test's size."""
    return TINY


def _texture(h: int, w: int, gen, device) -> torch.Tensor:
    """[h, w] u8: seeded values on a grid of 8-pixel cells, interpolated,
    with a finer seeded grain over them."""
    coarse = torch.randint(0, 256, (1, 1, h // 8 + 2, w // 8 + 2),
                           generator=gen, device=device).float()
    smooth = torch.nn.functional.interpolate(
        coarse, size=(h, w), mode="bilinear", align_corners=False)[0, 0]
    grain = torch.randint(0, 64, (h, w), generator=gen, device=device)
    return torch.clamp(smooth * 0.75 + grain, 0, 255).to(torch.uint8)


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int,
                 device: torch.device, spans=None):
        from swiftvideo_tpu_torch import media
        from swiftvideo_tpu_torch.ops import motion, registry
        self._motion, self._registry = motion, registry
        self.config, self.traffic, self.device = config, traffic, device
        self.spans = spans
        self.n = config["cameras"]
        w, h = self.size = tuple(config["frame"]["size"])
        if config["frame"]["format"] != "y420p":
            raise ValueError("the motion cells take y420p frames")
        self.block, self.search = config["block"], config["window"]
        self.radius = config["refine"]
        ring, pan = traffic["ring"], traffic["pan_px"]
        noise = traffic["noise_lsb"]
        gen = torch.Generator(device=device).manual_seed(seed)
        span = (ring - 1) * pan
        # each camera's ring of y420p frames on the device
        self.luma: List[List[torch.Tensor]] = []
        self.pictures: List[list] = []
        for _ in range(self.n):
            vx, vy = (int(v) for v in torch.randint(
                -pan, pan + 1, (2,), generator=gen, device=device))
            y_tex = _texture(h + span, w + span, gen, device)
            c_tex = [_texture((h + span) // 2, (w + span) // 2, gen, device)
                     for _ in range(2)]
            x0, y0 = max(0, -vx) * (ring - 1), max(0, -vy) * (ring - 1)
            lumas, pics = [], []
            for k in range(ring):
                x, y = x0 + k * vx, y0 + k * vy
                grain = torch.randint(-noise, noise + 1, (h, w),
                                      generator=gen, device=device)
                luma = torch.clamp(y_tex[y:y + h, x:x + w].int() + grain,
                                   0, 255).to(torch.uint8)
                planes = [luma] + [t[y // 2:y // 2 + h // 2,
                                     x // 2:x // 2 + w // 2].contiguous()
                                   for t in c_tex]
                img = media.ImageBuffer(
                    pixel_format=media.PixelFormat.y420p,
                    buffer_type=(media.BufferType.gpu
                                 if device.type == "cuda"
                                 else media.BufferType.cpu),
                    size=(w, h),
                    planes=tuple(media.planes_for_format(
                        media.PixelFormat.y420p, (w, h))),
                    buffers=tuple(planes))
                lumas.append(luma)
                pics.append(media.PictureSample(img, f"cam{len(self.luma)}",
                                                "site"))
            self.luma.append(lumas)
            self.pictures.append(pics)
        del y_tex, c_tex
        self.ctx = registry.make_compute_context(device)
        self.kernel = registry.default_compute_kernel_from_string(
            traffic["kernel"])
        self.targets = [media.create_picture_sample(
            (w // self.block, h // self.block), media.PixelFormat.RGBA,
            asset_id=f"mv{c}", workspace_id="site") for c in range(self.n)]
        self.samples = Reservoir(traffic["sample_maps"], seed)
        self.latencies: List[float] = []
        self.frames = self.attempted = 0
        self.t = 0

    def tick(self) -> None:
        ring = len(self.pictures[0])
        k, p = self.t % ring, (self.t - 1) % ring
        run = self._registry.run_compute_kernel
        t0 = time.perf_counter_ns()
        maps = [run(self.ctx, [pics[k], pics[p]], target,
                    self.kernel).planes()[0]
                for pics, target in zip(self.pictures, self.targets)]
        if self.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record()
            ev.synchronize()
        t1 = time.perf_counter_ns()
        if self.spans is not None:
            self.spans.add("tick", t0, t1)
        self.attempted += self.n
        self.frames += self.n
        self.latencies.append((t1 - t0) / 1e9)
        for c, mv in enumerate(maps):
            self.samples.offer(self.t * self.n + c, [mv])
        self.t += 1

    def warm(self) -> None:
        for _ in range(self.traffic["warm_ticks"]):
            self.tick()
        self.frames = self.attempted = 0
        self.latencies = []

    def inputs(self) -> List[torch.Tensor]:
        """Every input the program is handed, as tensors."""
        return [t for pics in self.pictures for pic in pics
                for t in pic.planes()]

    def counters(self) -> Dict[str, int]:
        m = self._motion
        return {"sad_launches": m.route_launches[m.KERNELS["sad"]],
                "coarse_launches": m.route_launches[m.COARSE_KERNEL],
                "refine_launches": m.route_launches[m.REFINE_KERNEL]}

    def release(self) -> None:
        self.ctx = self.targets = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def expected(self, c: int, t: int, dtype=torch.float32) -> torch.Tensor:
        """The reference's map of camera ``c`` at tick ``t``."""
        ring = len(self.luma[c])
        return ref_motion.by_kernel(
            self.traffic["kernel"], self.luma[c][t % ring],
            self.luma[c][(t - 1) % ring], self.block, self.search,
            self.radius, dtype)

    def check(self, dtype=torch.float32, stand_in=None) -> Dict[str, tuple]:
        """{number: (value, limit)}; ``stand_in`` replaces the program's
        maps by the reference in that precision (the control)."""
        ring = len(self.luma[0])
        want, got = {}, {}
        differ = 0
        for key, (mv,) in zip(self.samples.keys, self.samples.slots):
            t, c = divmod(key, self.n)
            pair = (c, t % ring)
            if pair not in want:
                want[pair] = self.expected(c, t, dtype)
                if stand_in is not None:
                    got[pair] = self.expected(c, t, stand_in)
            have = got[pair] if stand_in is not None else mv
            if have.shape != want[pair].shape:
                differ += want[pair].shape[0] * want[pair].shape[1]
                continue
            differ += int((have != want[pair]).any(-1).sum())
        return {k: (v, LIMITS[k]) for k, v in
                {"mv_blocks_differ": differ}.items()}
