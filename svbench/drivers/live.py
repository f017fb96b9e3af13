"""The live station: the program's ``Composer`` on a ``StepClock``, stepped
in a closed loop.

The configuration gives the canvas, the frame and audio clocks, the
scene's elements and the station process's threads for torch's CPU ops;
the traffic gives where the cameras' planes live
(``"host"``: numpy planes that ``GPUBarrierUpload`` copies to the card;
``"device"``: planes already on the card, which it passes on), the length
of the ring of camera sets, the audio ring and level, the transitions and
how many frames the check samples.

One tick is one clock step of one audio frame.  Each step publishes a
frame of every camera's audio; the step in which a video tick falls first
publishes the camera set of that frame (frame k shows set k of the ring),
and the frame's latency runs from the start of that publishing to the
moment the host sees the mixed frame complete on the card.  The sink
records an event on the emitted frame and waits on it, as an encoder
taking the frame would.  Every mixed audio frame is kept (host memory);
a seeded reservoir keeps a copy of ``sample_frames`` video frames.

The check works the expected output out again from the inputs alone:
frame k from camera set k, the overlay, and each element's placement from
its state at the step that published the set (``reference.scene``); a
mixed audio frame at pts q from each camera's audio frame of pts q - 2
audio frames (the audio mixer anchors a new source two frames ahead)
with the gains of its element's state at that frame's step.
"""

from __future__ import annotations

import math
import time
from fractions import Fraction
from math import ceil, floor
from typing import Dict, List, Optional

import numpy as np
import torch

from svbench.reference import audio as ref_audio
from svbench.reference import composite as ref_comp
from svbench.reference import scene as ref_scene

# numbers compared and their limits: the frame kernel and the s16 fold are
# exact by construction (integer-contract outputs), so any difference fails
LIMITS = {"video_max_lsb": 0, "video_pts_gaps": 0, "audio_max_diff": 0,
          "audio_pts_gaps": 0}

# a CPU test's size: a 64x36 canvas, the scene's elements scaled to it
TINY = {
    "canvas": [64, 36], "camera": {"size": [64, 36], "format": "y420p"},
    "overlay": {"size": [64, 8], "format": "RGBA"},
    "elements": [
        {"name": "cam0", "input": "camera", "pos": [0, 0], "size": [32, 18],
         "transparency": 0.1, "z": 0},
        {"name": "cam1", "input": "camera", "pos": [32, 0], "size": [32, 18],
         "transparency": 0.1, "z": 1},
        {"name": "cam2", "input": "camera", "pos": [0, 18], "size": [32, 18],
         "transparency": 0.1, "z": 2},
        {"name": "cam3", "input": "camera", "pos": [32, 18],
         "size": [32, 18], "transparency": 0.1, "z": 3},
        {"name": "lower_third", "asset": "lt", "input": "overlay",
         "pos": [0, 24], "size": [64, 8], "transparency": 0.0, "z": 10}]}


def tiny(config: dict, traffic: dict) -> dict:
    """Overrides that shrink a cell of this driver to a CPU test's size:
    the ``TINY`` scene, and a transition ten times as frequent, its
    targets scaled to the tiny canvas."""
    out = {"config": TINY, "traffic": {}}
    tr = traffic.get("transition")
    if tr:
        sx = TINY["canvas"][0] / config["canvas"][0]
        sy = TINY["canvas"][1] / config["canvas"][1]
        out["traffic"]["transition"] = dict(
            tr, every_s=tr["every_s"] / 10, duration_s=tr["duration_s"] / 10,
            to=[dict(t, pos=[t["pos"][0] * sx, t["pos"][1] * sy],
                     size=[t["size"][0] * sx, t["size"][1] * sy])
                for t in tr["to"]])
    return out


def _planes_y420p(flat, w: int, h: int):
    """Three y420p plane views of one contiguous buffer."""
    n, q = w * h, (w // 2) * (h // 2)
    return [flat[:n].reshape(h, w), flat[n:n + q].reshape(h // 2, w // 2),
            flat[n + q:n + 2 * q].reshape(h // 2, w // 2)]


class Reservoir:
    """Keeps a uniform seeded sample of ``k`` items of a stream (Li's
    algorithm L: a random draw only when an item is kept), copying each
    kept item's planes into slots allocated on first use."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng = k, np.random.default_rng(seed)
        self.slots: List[list] = []
        self.keys: List[int] = []
        self.seen = 0
        self._w = 1.0
        self._next = k

    def _skip(self) -> None:
        self._w *= math.exp(math.log(self.rng.random()) / self.k)
        self._next += int(math.log(self.rng.random())
                          / math.log(1.0 - self._w)) + 1

    def offer(self, key: int, planes) -> None:
        n = self.seen
        self.seen += 1
        if n < self.k:
            self.slots.append([torch.empty_like(p) for p in planes])
            self.keys.append(key)
            slot = n
            if n == self.k - 1:
                self._next = self.k - 1
                self._skip()
        elif n == self._next:
            slot = int(self.rng.integers(0, self.k))
            self._skip()
        else:
            return
        for dst, src in zip(self.slots[slot], planes):
            dst.copy_(src)
        self.keys[slot] = key


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int,
                 device: torch.device, spans=None):
        from swiftvideo_tpu_torch import core, media
        from swiftvideo_tpu_torch.compose import Composer
        from swiftvideo_tpu_torch.core import (Bus, EventBox, StepClock,
                                               TimePoint, Tx)
        from swiftvideo_tpu_torch.ops import frame
        from swiftvideo_tpu_torch.ops.registry import make_compute_context
        from swiftvideo_tpu_torch.scene import (ComposerCommand, Composition,
                                                Element, ElementState, Scene,
                                                SetStateCommand)
        self.core, self.media, self._frame = core, media, frame
        self.config, self.traffic = config, traffic
        self.device, self.spans = device, spans
        if config.get("torch_threads"):
            # the deployment's threads for torch's CPU ops in the station's
            # process (one station a process, on its own host thread)
            torch.set_num_threads(int(config["torch_threads"]))
        W, H = self.canvas = tuple(config["canvas"])
        audio = config["audio"]
        self.rate, self.channels = audio["rate"], audio["channels"]
        self.spf = audio["frame_samples"]
        fd_num, fd_den = config["frame_duration"]
        self.step_len = Fraction(self.spf, self.rate)
        self.frame_len = Fraction(fd_num, fd_den)
        self.elements = config["elements"]
        cams = [e for e in self.elements if e["input"] == "camera"]
        self.cam_names = [e["name"] for e in cams]
        self.cam_assets = [self._asset(e) for e in cams]

        # inputs, from the seed: camera sets, the overlay, the audio ring.
        # Host cameras keep only their host copy; the check draws the
        # device copy again from the seed once the program is freed.
        self.seed = seed
        flat, rgba, tones = self._draw()
        self.tones = tones.cpu().numpy()
        if traffic["cameras"] == "host":
            self.sets = self._sets(flat.cpu().numpy())
            self.dev_sets = self.dev_overlay = None
            overlay = rgba.cpu().numpy()
            self._btype = media.BufferType.cpu
        else:
            self.sets = self.dev_sets = self._sets(flat)
            self.dev_overlay = overlay = rgba
            self._btype = media.BufferType.gpu
        del flat, rgba, tones
        # each element's initial state, for the program and the reference;
        # the transitions issued so far, for the reference
        self.initial = {e["name"]: ElementState(
            pic_pos=tuple(map(float, e["pos"])),
            size=tuple(map(float, e["size"])),
            transparency=float(e["transparency"])) for e in self.elements}
        self.ref_initial = {e["name"]: ref_scene.State(
            pos=tuple(map(float, e["pos"])), size=tuple(map(float, e["size"])),
            transparency=float(e["transparency"]), z=int(e["z"]))
            for e in self.elements}
        self.ref_transitions: Dict[str, list] = {e["name"]: []
                                                 for e in self.elements}
        tr = traffic.get("transition")
        if tr:
            every = Fraction(str(tr["every_s"])) / self.step_len
            dur = Fraction(str(tr["duration_s"])) / self.step_len
            if every.denominator != 1 or dur.denominator != 1:
                raise ValueError("transitions must fall on clock steps")
            self._tr = (tr["element"], int(every), int(dur), tr["to"])
        else:
            self._tr = None

        # the program: the Composer with its mixers on the device
        self.clock = StepClock(TimePoint(self.spf, self.rate))
        self.audio_bus, self.picture_bus = Bus(self.clock), Bus(self.clock)
        comp = Composition(
            name="live", canvas_size=(W, H),
            frame_duration=TimePoint(fd_num, fd_den),
            audio_frame_duration=TimePoint(self.spf, self.rate),
            sample_rate=self.rate, channel_count=self.channels,
            scenes=(Scene(name="main", elements=tuple(
                Element(name=e["name"], z_index=int(e["z"]),
                        initial_state=self.initial[e["name"]])
                for e in self.elements)),),
            initial_scene="main")
        self.composer = Composer(
            self.clock, workspace_id="w", composition=comp,
            audio_bus=self.audio_bus, picture_bus=self.picture_bus,
            output_format=media.PixelFormat.y420p,
            compute_context=make_compute_context(device))
        self._ComposerCommand, self._SetStateCommand = (ComposerCommand,
                                                        SetStateCommand)
        self.samples = Reservoir(traffic["sample_frames"], seed)
        self.video_pts: List[int] = []
        self.audio_out: List[tuple] = []
        self.latencies: List[float] = []
        self.frames = self.attempted = 0
        self._done: Optional[int] = None
        cuda = device.type == "cuda"
        clock_ns = time.perf_counter_ns

        def on_frame(s):
            if s.asset_id() != "live":
                return EventBox.nothing(None)
            t0 = clock_ns()
            planes = s.planes()
            if cuda:
                ev = torch.cuda.Event()
                ev.record()
                ev.synchronize()
            self._done = clock_ns()
            pts = s.pts()
            k = pts.value * self.frame_len.denominator
            den = pts.scale * self.frame_len.numerator
            self.video_pts.append(k // den if k % den == 0 else -1)
            self.samples.offer(self.video_pts[-1], planes)
            if self.spans is not None:
                self.spans.add("sink", t0, clock_ns())
            return EventBox.just(s)

        def on_audio(s):
            if s.asset_id() != "live":
                return EventBox.nothing(None)
            p = s.pts()
            self.audio_out.append((p.value, p.scale,
                                   np.asarray(s.data()[0]).view(np.int16)))
            return EventBox.just(s)

        # the buses hold their subscribers weakly
        self._keep = [self.picture_bus.subscribe(Tx(on_frame)),
                      self.audio_bus.subscribe(Tx(on_audio))]
        for e in self.elements:
            self.composer.bind(self._asset(e), e["name"])
        self.step_no = 0
        self._picture(self._asset(next(e for e in self.elements
                                       if e["input"] == "overlay")),
                      media.PixelFormat.RGBA, [overlay])

    @staticmethod
    def _asset(e) -> str:
        return e.get("asset", e["name"])

    def _draw(self):
        """The camera ring (flat, a row a set and camera), the overlay and
        the audio ring, on the device, from the seed alone."""
        cfg, traffic, device = self.config, self.traffic, self.device
        cw, ch = cfg["camera"]["size"]
        ow, oh = cfg["overlay"]["size"]
        n = len(self.cam_names)
        gen = torch.Generator(device=device).manual_seed(self.seed)
        flat = torch.randint(0, 256, (traffic["ring"], n,
                                      cw * ch + 2 * (cw // 2) * (ch // 2)),
                             dtype=torch.uint8, device=device, generator=gen)
        rgba = torch.randint(0, 256, (oh, ow, 4), dtype=torch.uint8,
                             device=device, generator=gen)
        rgba[..., 3] = torch.from_numpy(
            np.linspace(0, 255, ow).astype(np.uint8)).to(device)[None, :]
        peak = traffic["audio_peak"]
        tones = torch.randint(-peak, peak + 1,
                              (n, traffic["audio_ring"],
                               self.spf * self.channels),
                              dtype=torch.int16, device=device, generator=gen)
        return flat, rgba, tones

    def _sets(self, flat):
        cw, ch = self.config["camera"]["size"]
        return [[_planes_y420p(cams[c], cw, ch) for c in range(len(cams))]
                for cams in flat]

    def inputs(self) -> List[torch.Tensor]:
        """Every input the program is handed, as tensors."""
        overlay = (self.dev_overlay if self.dev_overlay is not None
                   else self._draw()[1])
        return ([torch.as_tensor(p) for s in self.sets for c in s for p in c]
                + [overlay, torch.from_numpy(self.tones)])

    def _reference_inputs(self) -> None:
        """The device copy of the cameras and the overlay, for the check."""
        if self.dev_sets is None:
            flat, self.dev_overlay, _ = self._draw()
            self.dev_sets = self._sets(flat)

    # --- inputs -------------------------------------------------------------
    def _picture(self, asset, fmt, planes) -> None:
        m = self.media
        h, w = planes[0].shape[:2]
        img = m.ImageBuffer(pixel_format=fmt, buffer_type=self._btype,
                            size=(w, h),
                            planes=tuple(m.planes_for_format(fmt, (w, h))),
                            buffers=tuple(planes))
        now = self.clock.current()
        self.picture_bus.append(self.core.EventBox.just(m.PictureSample(
            img, asset, "w", time_point=now, pts_value=now)))

    def _frame_in(self, step: int) -> Optional[int]:
        """The video frame whose tick falls in clock step ``step``."""
        k = floor((step + 1) * self.step_len / self.frame_len)
        if k >= 1 and step * self.step_len < k * self.frame_len:
            return k
        return None

    def _feed(self, step: int, frame_k: Optional[int]) -> None:
        m, c = self.media, self.core
        pts = c.TimePoint(step * self.spf, self.rate)
        r = step % self.tones.shape[1]
        for a, asset in enumerate(self.cam_assets):
            self.audio_bus.append(c.EventBox.just(m.AudioSample(
                buffers=(self.tones[a, r],), frequency=self.rate,
                channels=self.channels, format=m.AudioFormat.s16i,
                sample_count=self.spf, pts_value=pts,
                id_asset=asset, id_workspace="w")))
        if frame_k is not None:
            cams = self.sets[frame_k % len(self.sets)]
            for asset, planes in zip(self.cam_assets, cams):
                self._picture(asset, m.PixelFormat.y420p, planes)

    def _transition(self, step: int) -> None:
        name, every, dur, targets = self._tr
        if step == 0 or step % every:
            return
        n = step // every - 1
        to = targets[n % len(targets)]
        state = self.initial[name].with_(
            pic_pos=tuple(map(float, to["pos"])),
            size=tuple(map(float, to["size"])),
            audio_gain=float(to["audio_gain"]))
        self.composer.run_command(self._ComposerCommand(
            set_state=self._SetStateCommand(
                element=name, state=state,
                duration=self.core.TimePoint(dur * self.spf, self.rate))))
        ref = self.ref_initial[name]
        self.ref_transitions[name].append(ref_scene.Transition(
            start=step, duration=dur, to=ref_scene.State(
                pos=state.pic_pos, size=state.size,
                transparency=ref.transparency, z=ref.z,
                audio_gain=state.audio_gain)))

    # --- the loop -----------------------------------------------------------
    def tick(self) -> None:
        step = self.step_no
        if self._tr is not None:
            self._transition(step)
        frame_k = self._frame_in(step)
        spans = self.spans
        t0 = time.perf_counter_ns()
        self._feed(step, frame_k)
        t1 = time.perf_counter_ns()
        self._done = None
        self.clock.step()
        t2 = time.perf_counter_ns()
        if spans is not None:
            spans.add("feed", t0, t1)
            spans.add("step", t1, t2)
        self.step_no += 1
        if frame_k is not None:
            self.attempted += 1
            if self._done is not None:
                self.frames += 1
                self.latencies.append((self._done - t0) / 1e9)

    def warm(self) -> None:
        """Run until ``warm_frames`` frames have been mixed: every camera
        set, the overlay, the caches of the mixers and the pinned pool."""
        while len(self.video_pts) < self.traffic["warm_frames"]:
            self.tick()
        self.frames = self.attempted = 0
        self.latencies = []

    def counters(self) -> Dict[str, int]:
        return {"launches": self._frame.launches}

    def release(self) -> None:
        """Free the program's state; the kept samples stay."""
        self.composer.close()
        self._keep = None
        self.composer = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # --- the check ----------------------------------------------------------
    def _publish_step(self, k: int) -> int:
        return ceil(k * self.frame_len / self.step_len) - 1

    def expected_frame(self, k: int, dtype=torch.float32):
        self._reference_inputs()
        step = self._publish_step(k)
        cams = iter(self.dev_sets[k % len(self.dev_sets)])
        srcs = []
        for e in sorted(self.elements, key=lambda e: e["z"]):
            state = ref_scene.state_at(self.ref_initial[e["name"]],
                                       self.ref_transitions[e["name"]], step)
            place = ref_scene.placement(state, self.canvas)
            if e["input"] == "camera":
                srcs.append((next(cams), False, place))
            else:
                srcs.append(([self.dev_overlay], True, place))
        return ref_comp.composite_y420p(self.canvas, srcs, self.device, dtype)

    def expected_audio(self, dtype=torch.float32):
        """{pts in samples: expected int16 frame} for every kept frame."""
        n = self.spf * self.channels
        lead = 2 * self.spf
        by_step: Dict[int, List[int]] = {}
        keys = []
        for value, scale, _data in self.audio_out:
            q = value * self.rate
            q = q // scale if q % scale == 0 else None
            keys.append(q)
            if q is not None and q - lead >= 0 and (q - lead) % self.spf == 0:
                by_step.setdefault((q - lead) // self.spf, [])
        steps = sorted(by_step)
        out = {}
        if steps:
            idx = np.array(steps)
            sources = []
            for a, name in enumerate(self.cam_names):
                gains = np.stack([ref_scene.channel_gains(
                    ref_scene.state_at(self.ref_initial[name],
                                       self.ref_transitions[name], s),
                    self.channels) for s in steps])
                sources.append((self.tones[a, idx % self.tones.shape[1]],
                                gains))
            mixed = ref_audio.fold_s16(sources, n, dtype)
            for s, row in zip(steps, mixed):
                out[s * self.spf + lead] = row
        return keys, out

    def check(self, dtype=torch.float32, stand_in=None) -> Dict[str, tuple]:
        """{number: (value, limit)}.  ``stand_in`` replaces the program's
        outputs by the reference computed in that precision (the
        control)."""
        lsb = 0
        for k, planes in zip(self.samples.keys, self.samples.slots):
            want = self.expected_frame(k, dtype)
            got = (self.expected_frame(k, stand_in) if stand_in is not None
                   else planes)
            for a, b in zip(got, want):
                lsb = max(lsb, int((a.int() - b.int()).abs().max()))
        gaps = sum(1 for a, b in zip(self.video_pts, self.video_pts[1:])
                   if b != a + 1) + (self.video_pts[:1] != [1])
        keys, want = self.expected_audio(dtype)
        got = self.expected_audio(stand_in)[1] if stand_in is not None else {
            q: d for q, (_v, _s, d) in zip(keys, self.audio_out)}
        diff = 0
        n = self.spf * self.channels
        zero = np.zeros(n, np.int16)
        for q in keys:
            if q is None:
                diff = max(diff, 65535)
                continue
            b = want.get(q, zero)
            a = got.get(q, zero) if stand_in is not None else got.get(q)
            if a.shape != b.shape:
                diff = max(diff, 65535)
                continue
            diff = max(diff, int(np.abs(a.astype(np.int32)
                                        - b.astype(np.int32)).max()))
        apts = sum(1 for a, b in zip(keys, keys[1:])
                   if a is None or b is None or b != a + self.spf)
        values = {"video_max_lsb": lsb, "video_pts_gaps": int(gaps),
                  "audio_max_diff": diff, "audio_pts_gaps": apts}
        return {k: (v, LIMITS[k]) for k, v in values.items()}
