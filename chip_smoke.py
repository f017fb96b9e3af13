"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds both kernel sources of ``swiftvideo_tpu_torch/csrc`` (one nvcc each,
started together) and drives the port's paths at full size:

* the frame kernel on yuv targets (K1 cameras, K2 overlays) against the
  plain torch version at the live-station size (a 1080p canvas, four
  full-1080p y420p cameras scaled 2:1 into its quadrants at opacity 0.9,
  and a 1920x216 RGBA lower third); the port's Composer for 60 video ticks
  of that scene with four stereo s16 audio assets; the audio fold on the
  card against the host loop;
* the frame kernel on RGBA / BGRA targets (K3) against the plain version
  on the same scene, the Composer's VideoMixer with an RGBA output for 30
  ticks, and ``apply_compute_image`` with ``img_y420p_rgba`` (a 1280x720
  y420p picture into a 640x360 RGBA canvas);
* the motion search, SAD (K4, ``motion_sad_kernel``) and SSD (K5,
  ``motion_ssd_kernel``), through ``run_compute_kernel`` at 1080p and 4K
  with 16x16 blocks and a 64-pixel window, against the plain version, on a
  tie-heavy 1080p frame (periodic every 8 pixels, shifted by half a
  period, so that vectors of equal cost tie exactly) and on a reference
  shifted by a known vector.  Phase 2 prints each motion kernel's
  registers and shared memory (ptxas) and what its SASS holds
  (``cuobjdump -sass``): the SSD kernel must hold an integer tensor-core
  instruction, and the SAD kernel's byte-SIMD opcode sets its bound.

Every pixel comparison is exact: the frame kernels are bit-exact against
the plain version, so one differing pixel fails the run.  Then it times
every kernel and its plain version with CUDA events, takes every kernel's
device time per launch from ``torch.profiler``'s kernel events, and the
frame kernels' host time per call.  Each phase prints one line; any
failure exits non-zero.  The line before the last holds every kernel's
numbers as JSON; the last line is the run's JSON summary.  Needs a CUDA
device; imports nothing of JAX.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
import time
from collections import Counter

import numpy as np
import torch

W, H = 1920, 1080
OV_H = 216
LSB = 0  # tolerance of every pixel comparison, in u8 steps
BLOCK, SEARCH = 16, 64
# published peaks of one H100 SXM (dense): HBM bytes/s, float32 outside the
# tensor cores, bf16 and int8 tensor cores
HBM_BPS, NONTENSOR_OPS, BF16_FLOPS, INT8_OPS = 3.35e12, 67e12, 989e12, 1979e12
# the H100 SXM's SMs, and the integer lanes of one SM per clock (4 sub-
# partitions of 16 INT32 lanes), the pipe of the byte-SIMD SAD instructions
SMS, INT_LANES_PER_SM_CLOCK = 132, 64
TENSOR_OPCODES = ("IMMA", "HMMA", "HGMMA", "IGMMA")
BYTE_SAD_OPCODES = ("VABSDIFF4",)  # |a - b| over 4 bytes, summed into an accumulator
REPLACES = {"K1": "swiftvideo_tpu/ops/pallas_frame.py:127",
            "K2": "swiftvideo_tpu/ops/pallas_frame.py:1100",
            "K3": "swiftvideo_tpu/ops/pallas_frame.py:1524",
            "K4": "swiftvideo_tpu/ops/motion.py:260",
            "K5": "swiftvideo_tpu/ops/motion.py:982"}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def max_err(a, b):
    """(max abs error, pixels above 0) over paired plane lists."""
    d = [(x.int() - y.int()).abs() for x, y in zip(a, b)]
    return max(int(t.max()) for t in d), sum(int((t > 0).sum()) for t in d)


def camera_planes(rng, n, w=W, h=H):
    return [[rng.integers(0, 256, (h, w), np.int64).astype(np.uint8),
             rng.integers(0, 256, (h // 2, w // 2), np.int64).astype(np.uint8),
             rng.integers(0, 256, (h // 2, w // 2), np.int64).astype(np.uint8)]
            for _ in range(n)]


def overlay_plane(rng):
    """A 1920x216 RGBA lower third: random colour, alpha ramping 0..255
    across the width."""
    rgba = rng.integers(0, 256, (OV_H, W, 4), np.int64).astype(np.uint8)
    rgba[..., 3] = np.linspace(0, 255, W).astype(np.uint8)[None, :]
    return rgba


def live_stack(rng, dev):
    """The live station's frame sources on ``dev``: four full-1080p y420p
    cameras scaled 2:1 into the quadrants at opacity 0.9, and the RGBA lower
    third 40 px above the bottom edge.  Returns (cameras, overlays)."""
    from swiftvideo_tpu_torch.media import PixelFormat
    from swiftvideo_tpu_torch.ops.uniforms import rect_uniforms
    cams = [[torch.from_numpy(p).to(dev) for p in planes]
            for planes in camera_planes(rng, 4)]
    cam_srcs = [(cams[s], PixelFormat.y420p,
                 rect_uniforms((W, H), (W, H), x=(s % 2) * 960,
                               y=(s // 2) * 540, w=960, h=540, opacity=0.9))
                for s in range(4)]
    ov_srcs = [([torch.from_numpy(overlay_plane(rng)).to(dev)], PixelFormat.RGBA,
                rect_uniforms((W, OV_H), (W, H), x=0, y=H - OV_H - 40, w=W,
                              h=OV_H))]
    return cam_srcs, ov_srcs


def motion_frames(h, w, seed, dev):
    """(cur, ref) luma on ``dev``: random ref, cur = ref + noise in
    [-12, 12)."""
    r = np.random.default_rng(seed)
    ref = r.integers(0, 255, (h, w), np.int64).astype(np.uint8)
    cur = np.clip(ref.astype(int) + r.integers(-12, 12, ref.shape), 0,
                  255).astype(np.uint8)
    return (torch.from_numpy(cur).to(dev), torch.from_numpy(ref).to(dev))


def tie_frames(h, w, period, seed, dev):
    """A frame periodic every ``period`` pixels both ways, and the same
    frame shifted by half a period: the vectors (+-p/2, +-p/2) tie exactly,
    score and cost, and the scan order decides."""
    r = np.random.default_rng(seed)
    tile = r.integers(0, 256, (period, period), np.int64).astype(np.uint8)
    ref = np.tile(tile, (h // period + 1, w // period + 1))[:h, :w]
    cur = np.roll(ref, (period // 2, period // 2), axis=(0, 1))
    return (torch.from_numpy(np.ascontiguousarray(cur)).to(dev),
            torch.from_numpy(np.ascontiguousarray(ref)).to(dev))


def timed_ms(fn, reps=20, batch=10, warmup=3):
    """Median device time per call over ``reps`` batches of ``batch``
    back-to-back calls, from CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(batch):
            fn()
        b.record()
        torch.cuda.synchronize()
        ts.append(a.elapsed_time(b) / batch)
    return float(np.median(ts))


def host_us(fn, n=50):
    """Host microseconds per call: ``n`` calls enqueued back to back, timed
    on the host clock before the device is waited for."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def device_ms(fn, kernel, n=60):
    """Mean device time per launch of the kernel whose name holds
    ``kernel``, from torch.profiler's CUDA kernel events over ``n`` calls
    (warm).  Fails when the profiler shows fewer than 50 such launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if kernel in e.name and e.device_type == DeviceType.CUDA]
    if len(us) < 50:
        fail(f"torch.profiler shows {len(us)} launches of {kernel} in {n} "
             "calls: no device time")
    return float(np.mean(us)) / 1e3


def frame_bytes(size, sources, out_fmt):
    """Bytes a composite must move: every source plane read once, the
    target written once."""
    from swiftvideo_tpu_torch.media.pixel import num_planes, plane_array_shape
    read = sum(p.numel() for planes, _f, _u in sources for p in planes)
    write = sum(int(np.prod(plane_array_shape(out_fmt, size, i)))
                for i in range(num_planes(out_fmt)))
    return read + write


def bound(nbytes, ops, peak):
    """(least ms the card could take, what bounds it): bytes over the HBM
    rate against operations over ``peak``."""
    by_bytes = nbytes / HBM_BPS * 1e3
    by_ops = ops / peak * 1e3
    return (max(by_bytes, by_ops),
            "bytes" if by_bytes >= by_ops else "operations")


def kernel_sass(library) -> dict:
    """{mangled kernel name: Counter of SASS opcodes} of a built library,
    from ``cuobjdump -sass`` (predicates and modifiers dropped)."""
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([exe, "-sass", str(library)], capture_output=True,
                          text=True, check=True).stdout
    out, name = {}, None
    for ln in text.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            name = m.group(1)
            out[name] = Counter()
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", ln)
        if m and name:
            out[name][m.group(1)] += 1
    return out


def ptxas_lines(log: str) -> dict:
    """{mangled kernel name: ptxas's stack-frame and "Used ..." lines}
    from nvcc's -v log."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = m.group(1)
        elif name and ("stack frame" in ln or ("Used" in ln and "registers" in ln)):
            out[name] = (out.get(name, "") + " "
                         + ln.split(":", 1)[-1].strip()).strip()
    return out


def sm_clock_hz() -> float:
    """The card's highest SM clock, as nvidia-smi reads it."""
    mhz = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True,
                         text=True, check=True).stdout.split()[0]
    return float(mhz) * 1e6


def motion_bound(h, w, metric, motion, sad_terms_per_op, clock_hz):
    """(bound ms, by) of one full search: the frames read and the map
    written at the HBM rate, against the pixel-candidate terms.  SSD: the
    cross term's multiply-add, 2 operations a term at the int8 tensor rate
    (the least time of an exact u8 product).  SAD: one byte-SIMD lane-
    instruction per ``sad_terms_per_op`` terms at the integer pipe's lanes
    per SM per clock, on every SM at ``clock_hz``; without such an
    instruction, 2 operations a term at the non-tensor rate."""
    terms = pixel_candidates(h, w, motion)
    nbytes = 2 * h * w + (h // BLOCK) * (w // BLOCK) * 4
    if metric == "ssd":
        return bound(nbytes, 2 * terms, INT8_OPS)
    if sad_terms_per_op:
        rate = sad_terms_per_op * INT_LANES_PER_SM_CLOCK * SMS * clock_hz
        return bound(nbytes, terms, rate)
    return bound(nbytes, 2 * terms, NONTENSOR_OPS)


def pixel_candidates(h, w, motion):
    """Pixel-candidate terms of a full search: block pixels times the
    candidates of every block's clamped window, for this geometry."""
    xlo, xhi = motion.search_bounds(np.arange(w // BLOCK) * BLOCK, BLOCK,
                                    SEARCH, w)
    ylo, yhi = motion.search_bounds(np.arange(h // BLOCK) * BLOCK, BLOCK,
                                    SEARCH, h)
    return (BLOCK * BLOCK * int(np.maximum(xhi - xlo, 0).sum())
            * int(np.maximum(yhi - ylo, 0).sum()))


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this run needs a CUDA card")
    from swiftvideo_tpu_torch.compose import Composer
    from swiftvideo_tpu_torch.core import Bus, EventBox, StepClock, TimePoint, Tx
    from swiftvideo_tpu_torch.media import (AudioFormat, AudioSample,
                                            BufferType, ImageBuffer,
                                            PictureSample, PixelFormat,
                                            create_picture_sample,
                                            planes_for_format)
    from swiftvideo_tpu_torch.mix import video_mixer
    from swiftvideo_tpu_torch.ops import (audio, composite, frame, motion, nvcc,
                                          registry)
    from swiftvideo_tpu_torch.ops.uniforms import ImageUniforms, rect_uniforms
    from swiftvideo_tpu_torch.scene import (Composition, Element, ElementState,
                                            Scene)
    from swiftvideo_tpu_torch.utils import matrix as m4

    loaded = [m for m in sys.modules if m.split(".")[0] in ("jax",
                                                             "swiftvideo_tpu")]
    if loaded:
        fail(f"JAX or the JAX package was imported: {sorted(loaded)[:5]}")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    # phase 1: device
    print(smi)
    print(f"[1 device] {torch.cuda.get_device_name(0)} | torch "
          f"{torch.__version__} | cuda {torch.version.cuda}", flush=True)

    # phase 2: build every kernel source at once
    t0 = time.perf_counter()
    nvcc.build_all([frame.SOURCE, motion.SOURCE])
    frame.build()
    motion.build()
    # the frame kernels' registers here, the motion kernels' below
    regs = [f"{name}: {ln.split(':', 1)[1].strip()}"
            for name, log in sorted(nvcc.build_logs.items())
            if name != motion.SOURCE.stem
            for ln in log.splitlines() if "registers" in ln]
    print(f"[2 build] frame_composite.cu and motion_search.cu built and loaded "
          f"in {time.perf_counter() - t0:.2f} s; {'; '.join(regs) or 'cached'}",
          flush=True)
    sass = kernel_sass(nvcc.library_path(motion.SOURCE))
    ptxas = ptxas_lines(nvcc.build_logs.get(motion.SOURCE.stem, ""))
    parts, sad_terms_per_op = [], 0
    for metric, kname in motion.KERNELS.items():
        # the instantiation the wrapper launches: kname<GROUP[metric]>
        inst = f"{kname}ILi{motion.GROUP[metric]}E"
        found = [k for k in sass if inst in k]
        if len(found) != 1:
            fail(f"cuobjdump shows {len(found)} functions named {inst}")
        ops = sass[found[0]]
        tensor = {o: ops[o] for o in TENSOR_OPCODES if ops[o]}
        byte_sad = {o: ops[o] for o in BYTE_SAD_OPCODES if ops[o]}
        if metric == "ssd" and not tensor:
            fail(f"{kname}'s SASS holds no tensor-core instruction")
        if metric == "sad" and byte_sad:
            sad_terms_per_op = 4  # one lane-instruction: 4 bytes' |c - r|, accumulated
        parts.append(f"{kname}<{motion.GROUP[metric]}>: "
                     f"{ptxas.get(found[0], 'ptxas line not in the log')}; "
                     f"SASS {sum(ops.values())} instructions, tensor-core "
                     f"{tensor or 'none'}, byte-SIMD SAD {byte_sad or 'none'}, "
                     f"LDS {ops['LDS']}, top {ops.most_common(6)}")
    clock_hz = sm_clock_hz()
    print("[2 motion kernels] " + " | ".join(parts) + f" | max SM clock "
          f"{clock_hz / 1e6:.0f} MHz", flush=True)

    # phase 3: yuv-target kernel vs plain on the card, live-station stack
    rng = np.random.default_rng(0)
    cam_srcs, ov_srcs = live_stack(rng, dev)
    stacks = {"K1": cam_srcs, "K2": ov_srcs, "K1+K2": cam_srcs + ov_srcs}
    errs = {}
    parts = []
    for name, srcs in stacks.items():
        for fmt in (PixelFormat.y420p, PixelFormat.nv12, PixelFormat.nv21):
            got = frame.composite_frame_cuda((W, H), srcs, fmt)
            ref = composite.composite_stack_torch(fmt, (W, H), srcs, dev)
            torch.cuda.synchronize()
            err, n_above = max_err(got, ref)
            if err > LSB or n_above:
                fail(f"{name} {fmt.value}: kernel vs plain max abs err {err}, "
                     f"{n_above} pixels differ")
            errs[name] = max(errs.get(name, 0), err)
            parts.append(f"{name}/{fmt.value} err {err} above0 {n_above}")
    print(f"[3 kernel vs plain, tol {LSB} LSB] " + "; ".join(parts), flush=True)

    # phases 4 and 8: the Composer on a StepClock (cameras + lower third)
    host_sets = [camera_planes(rng, 4) for _ in range(2)]
    ov_host = overlay_plane(rng)
    tone = [(np.sin(np.arange(480) * (k + 1) * 0.05) * 3000).astype(np.int16)
            for k in range(4)]

    def drive_composer(out_fmt, n_ticks):
        """n_ticks video ticks of the live scene onto an out_fmt canvas;
        returns (frames, audio frames, kernel launches, plain composites,
        clock steps, host wall s, the last tick's composite call)."""
        clock = StepClock(TimePoint(480, 48000))
        audio_bus, picture_bus = Bus(clock), Bus(clock)
        elements = tuple(
            Element(name=f"cam{s}", z_index=s, initial_state=ElementState(
                pic_pos=((s % 2) * 960.0, (s // 2) * 540.0),
                size=(960.0, 540.0), transparency=0.1))
            for s in range(4)) + (
            Element(name="lower_third", z_index=10, initial_state=ElementState(
                pic_pos=(0.0, float(H - OV_H - 40)),
                size=(float(W), float(OV_H)))),)
        comp = Composition(name="live", canvas_size=(W, H),
                           frame_duration=TimePoint(1000, 30000),
                           audio_frame_duration=TimePoint(480, 48000),
                           sample_rate=48000, channel_count=2,
                           scenes=(Scene(name="main", elements=elements),),
                           initial_scene="main")
        # no context given: the Composer takes the card by default
        composer = Composer(clock, workspace_id="w", composition=comp,
                            audio_bus=audio_bus, picture_bus=picture_bus,
                            output_format=out_fmt)
        if composer.ctx.device.type != "cuda":
            fail(f"the Composer's default device is {composer.ctx.device}")
        frames, mixed_audio = [], []
        # the buses hold their subscribers weakly
        keep = [picture_bus.subscribe(Tx(
                    lambda s: (frames.append(s), EventBox.just(s))[1]
                    if s.asset_id() == "live" else EventBox.nothing(None))),
                audio_bus.subscribe(Tx(
                    lambda s: (mixed_audio.append(s), EventBox.just(s))[1]
                    if s.asset_id() == "live" else EventBox.nothing(None)))]
        for s in range(4):
            composer.bind(f"cam{s}", f"cam{s}")
        composer.bind("lt", "lower_third")
        last_call = {}
        mixer_composite = video_mixer.composite_frame

        def spy(ctx_, fmt, size, sources, target=None):
            last_call.update(out_fmt=fmt, size=size, sources=sources)
            return mixer_composite(ctx_, fmt, size, sources, target)

        def picture(asset, fmt, planes):
            h, w = planes[0].shape[:2]
            img = ImageBuffer(pixel_format=fmt, buffer_type=BufferType.cpu,
                              size=(w, h), planes=tuple(planes_for_format(
                                  fmt, (w, h))), buffers=tuple(planes))
            return PictureSample(img, asset, "w", time_point=clock.current(),
                                 pts_value=clock.current())

        video_mixer.composite_frame = spy
        audio_pts = TimePoint(0, 48000)
        step = 0
        frame.launches = 0
        motion.launches = 0
        composite.calls = 0
        t0 = time.perf_counter()
        picture_bus.append(EventBox.just(picture("lt", PixelFormat.RGBA,
                                                 [ov_host])))
        while len(frames) < n_ticks:
            if step % 3 == 0:
                for s, planes in enumerate(host_sets[(step // 3) % 2]):
                    picture_bus.append(EventBox.just(
                        picture(f"cam{s}", PixelFormat.y420p, planes)))
            for k in range(4):
                pcm = np.repeat(tone[k], 2)
                audio_bus.append(EventBox.just(AudioSample(
                    buffers=(pcm,), frequency=48000, channels=2,
                    format=AudioFormat.s16i, sample_count=480,
                    pts_value=audio_pts, id_asset=f"cam{k}", id_workspace="w")))
            audio_pts = audio_pts + TimePoint(480, 48000)
            clock.step()
            step += 1
            if step > 10 * n_ticks:
                fail(f"only {len(frames)} frames after {step} clock steps")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, plain_calls = frame.launches, composite.calls
        video_mixer.composite_frame = mixer_composite
        composer.close()
        del keep
        if launches != len(frames):
            fail(f"{out_fmt.value}: frame kernel launches {launches} != video "
                 f"ticks {len(frames)}")
        if plain_calls != 0:
            fail(f"{out_fmt.value}: {plain_calls} ticks took the plain "
                 "composite")
        if not all(isinstance(p, torch.Tensor) and p.is_cuda
                   and f.buffer_type() == BufferType.gpu
                   for f in frames for p in f.planes()):
            fail(f"{out_fmt.value}: a mixed frame does not hold CUDA tensors")
        if len(last_call["sources"]) != 5:
            fail(f"last tick composited {len(last_call['sources'])} sources, "
                 "not 5")
        ref = composite.composite_stack_torch(last_call["out_fmt"],
                                              last_call["size"],
                                              last_call["sources"], dev)
        last = frames[-1].planes()
        err, above = max_err(last, ref)
        if err > LSB:
            fail(f"{out_fmt.value}: last mixed frame vs plain max abs err {err}")
        return frames, mixed_audio, launches, plain_calls, step, wall, err, above

    frames, mixed_audio, launches, plain_calls, steps, wall, main_err, \
        main_above = drive_composer(PixelFormat.y420p, 60)
    last = frames[-1].planes()
    if [tuple(p.shape) for p in last] != [(H, W), (H // 2, W // 2),
                                          (H // 2, W // 2)]:
        fail(f"mixed frame shapes {[tuple(p.shape) for p in last]}")
    counts = {a.number_samples() for a in mixed_audio}
    if counts != {480} or not all(a.data()[0].shape == (960,)
                                  for a in mixed_audio):
        fail(f"mixed audio sample counts {counts}")
    if not np.any(mixed_audio[-1].data()[0]):
        fail("mixed audio is silent")
    yuv_launches = launches
    print(f"[4 main path, y420p] {len(frames)} video ticks in {wall:.2f} s host "
          f"wall ({steps} clock steps); frame kernel launches {launches}; "
          f"plain composites {plain_calls}; last frame vs plain err {main_err} "
          f"above0 {main_above}; {len(mixed_audio)} audio frames of 480 "
          f"samples", flush=True)

    # phase 5: the audio fold on the card equals the host loop
    n_src, n = 64, 960 * 2
    srcs = rng.integers(-32768, 32768, (n_src, n), np.int64).astype(np.int16)
    gains = rng.uniform(0.0, 1.5, (n_src, 2)).astype(np.float32)
    base = rng.integers(-32768, 32768, n, np.int64).astype(np.int16)
    host = base.copy()
    for k in range(n_src):
        audio.apply_mix_s16(srcs[k], gains[k], host)
    dev_out = audio.mix_s16_device(torch.from_numpy(srcs).to(dev), gains,
                                   base=torch.from_numpy(base).to(dev))
    starts = rng.integers(0, n - 1, n_src)
    ends = np.minimum(n, starts + rng.integers(1, n, n_src))
    win_in = np.zeros_like(srcs)
    host_w = base.copy()
    for k in range(n_src):
        win_in[k, starts[k]:ends[k]] = srcs[k, :ends[k] - starts[k]]
        audio.apply_mix_s16(srcs[k, :ends[k] - starts[k]], gains[k], host_w,
                            backing_start=int(starts[k]))
    dev_w = audio.mix_s16_device_windowed(torch.from_numpy(win_in).to(dev),
                                          gains, starts, ends,
                                          base=torch.from_numpy(base).to(dev))
    aligned_ok = np.array_equal(dev_out.cpu().numpy(), host)
    windowed_ok = np.array_equal(dev_w.cpu().numpy(), host_w)
    if not (aligned_ok and windowed_ok):
        fail(f"audio fold differs from the host loop (aligned {aligned_ok}, "
             f"windowed {windowed_ok})")
    print(f"[5 audio fold] {n_src} sources x {n} s16 on {dev}: aligned and "
          f"windowed folds equal apply_mix_s16 exactly", flush=True)

    # phase 6: per-tick times of the yuv-target kernel at the main-path shape:
    # the call as the stream sees it, the kernel's device time, host work
    full = stacks["K1+K2"]
    calls = {k: (lambda s=srcs: frame.composite_frame_cuda((W, H), s))
             for k, srcs in stacks.items()}
    times = {k: timed_ms(fn) for k, fn in calls.items()}
    dev_ms = {k: device_ms(fn, "frame_composite_kernel")
              for k, fn in calls.items()}
    host = {k: host_us(fn) for k, fn in calls.items()}
    plain = {
        "K1": timed_ms(lambda: composite.composite_stack_torch(
            PixelFormat.y420p, (W, H), cam_srcs, dev), batch=2),
        "K2": timed_ms(lambda: composite.composite_stack_torch(
            PixelFormat.y420p, (W, H), ov_srcs, dev), batch=2),
        "K1+K2": timed_ms(lambda: composite.composite_stack_torch(
            PixelFormat.y420p, (W, H), full, dev), batch=2),
    }
    bounds = {k: bound(frame_bytes((W, H), stacks[k], PixelFormat.y420p), 0,
                       1.0)[0] for k in times}
    print("[6 timings, ms per 1080p tick; call: median of 20 reps of 10; "
          "device: torch.profiler mean of 60 launches] " + "; ".join(
              f"{k}: call {times[k]:.4f} device {dev_ms[k]:.4f} host "
              f"{host[k]:.1f} us plain {plain[k]:.4f} bound {bounds[k]:.4f} "
              f"share {bounds[k] / dev_ms[k]:.1%}" for k in times)
          + f" | {smi}", flush=True)

    # phase 7: RGBA / BGRA-target kernel vs plain, live stack and config 1
    cfg1_src = [torch.from_numpy(p).to(dev)
                for p in camera_planes(rng, 1, 1280, 720)[0]]
    cfg1_srcs = [(cfg1_src, PixelFormat.y420p,
                  rect_uniforms((1280, 720), (640, 360), x=0, y=0, w=640,
                                h=360))]
    rgba_cases = [("live 1080p RGBA", (W, H), full, PixelFormat.RGBA),
                  ("live 1080p BGRA", (W, H), full, PixelFormat.BGRA),
                  ("config 1 640x360 RGBA", (640, 360), cfg1_srcs,
                   PixelFormat.RGBA)]
    parts = []
    errs["K3"] = 0
    for name, size, srcs, fmt in rgba_cases:
        got = frame.composite_frame_cuda(size, srcs, fmt)
        ref = composite.composite_stack_torch(fmt, size, srcs, dev)
        torch.cuda.synchronize()
        if tuple(got[0].shape) != (size[1], size[0], 4):
            fail(f"{name}: kernel output shape {tuple(got[0].shape)}")
        err, n_above = max_err(got, ref)
        if err > LSB or n_above:
            fail(f"{name}: kernel vs plain max abs err {err}, {n_above} "
                 "pixels differ")
        errs["K3"] = max(errs["K3"], err)
        parts.append(f"{name} err {err} above0 {n_above}")
    print(f"[7 K3 RGBA-target kernel vs plain, tol {LSB} LSB] "
          + "; ".join(parts), flush=True)

    # phase 8: the Composer's VideoMixer with an RGBA output
    frames, _audio, rgba_launches, plain_calls, steps, wall, rgba_err, \
        rgba_above = drive_composer(PixelFormat.RGBA, 30)
    if tuple(frames[-1].planes()[0].shape) != (H, W, 4):
        fail(f"RGBA frame shape {tuple(frames[-1].planes()[0].shape)}")
    print(f"[8 main path, RGBA] {len(frames)} video ticks in {wall:.2f} s host "
          f"wall ({steps} clock steps); frame kernel launches {rgba_launches}; "
          f"plain composites {plain_calls}; last frame vs plain err {rgba_err} "
          f"above0 {rgba_above}", flush=True)

    # phase 9: apply_compute_image with img_y420p_rgba (config 1)
    ctx = registry.make_compute_context()
    image = create_picture_sample((1280, 720), PixelFormat.y420p,
                                  asset_id="cam", workspace_id="w")
    image = image.with_(img=image.img.with_buffers(cfg1_src, BufferType.gpu),
                        matrix=m4.ortho(640, 360) @ m4.scale(640, 360))
    canvas = create_picture_sample((640, 360), PixelFormat.RGBA,
                                   asset_id="out", workspace_id="w")
    canvas.planes()[0][:] = rng.integers(0, 256, (360, 640, 4), np.int64)
    frame.launches = composite.calls = 0
    out = registry.apply_compute_image(ctx, image, canvas)
    torch.cuda.synchronize()
    cfg1_launches, cfg1_plain = frame.launches, composite.calls
    ref = composite.composite_stack_torch(
        PixelFormat.RGBA, (640, 360),
        [(cfg1_src, PixelFormat.y420p, ImageUniforms.from_sample(image, canvas))],
        dev, target=[torch.from_numpy(canvas.planes()[0]).to(dev)])
    cfg1_err, cfg1_above = max_err(out.planes(), ref)
    if (cfg1_launches, cfg1_plain) != (1, 0) or cfg1_err > LSB:
        fail(f"config 1: launches {cfg1_launches}, plain composites "
             f"{cfg1_plain}, err {cfg1_err}")
    print(f"[9 config 1 registry] img_y420p_rgba 1280x720 -> 640x360 on "
          f"{ctx.device}: kernel launches {cfg1_launches}; vs plain err "
          f"{cfg1_err} above0 {cfg1_above}", flush=True)

    # phase 10: motion search through the registry, kernel vs plain, exact
    def luma_sample(plane):
        h, w = plane.shape
        s = create_picture_sample((w, h), PixelFormat.y420p, asset_id="cam",
                                  workspace_id="w")
        return s.with_(img=s.img.with_buffers(
            [plane] + list(s.planes()[1:]), BufferType.gpu))

    me_names = {"sad": "me_fullsearch", "ssd": "me_fullsearch_ssd"}
    me_frames = {"1080p": motion_frames(H, W, 1, dev),
                 "4K": motion_frames(2160, 3840, 2, dev),
                 "1080p ties": tie_frames(H, W, 8, 3, dev)}
    me_cases = [("K4", "sad", "1080p"), ("K5", "ssd", "1080p"),
                ("K4", "sad", "4K"), ("K5", "ssd", "4K")]
    me_launches, parts = {}, []
    for key, metric, res in me_cases + [("K4", "sad", "1080p ties"),
                                        ("K5", "ssd", "1080p ties")]:
        cur, ref = me_frames[res]
        kernel = registry.default_compute_kernel_from_string(me_names[metric])
        frame.launches = motion.launches = composite.calls = 0
        motion.route_launches.update(dict.fromkeys(motion.route_launches, 0))
        got = registry.run_compute_kernel(
            ctx, [luma_sample(cur), luma_sample(ref)],
            create_picture_sample((cur.shape[1] // BLOCK, cur.shape[0] // BLOCK),
                                  PixelFormat.RGBA, asset_id="mv",
                                  workspace_id="w"), kernel)
        torch.cuda.synchronize()
        me_launches[(key, res)] = motion.launches
        routes = {k: n for k, n in motion.route_launches.items() if n}
        if (motion.launches != 1 or frame.launches or composite.calls
                or routes != {motion.KERNELS[metric]: 1}):
            fail(f"{key} {res}: motion launches {motion.launches}, by kernel "
                 f"{routes}")
        mv = got.planes()[0]
        want = motion.me_fullsearch_torch(cur, ref, BLOCK, SEARCH, metric)
        if not (mv.is_cuda and got.pixel_format() == PixelFormat.RGBA
                and torch.equal(mv, want)):
            fail(f"{key} {res}: the kernel's MV map differs from the plain "
                 f"version's ({int((mv != want).any(-1).sum())} blocks)")
        parts.append(f"{key} {metric} {res} {tuple(mv.shape)} equal, "
                     f"launches {routes}")
    # a reference shifted by a known vector comes back as that vector
    dx, dy = -7, 5
    base_ref = me_frames["1080p"][1]
    shifted = torch.roll(base_ref, (dy, dx), dims=(0, 1)).contiguous()
    want_x = int(np.rint((dx / 32 * 0.5 + 0.5) * 255))
    want_y = int(np.rint((dy / 32 * 0.5 + 0.5) * 255))
    for metric in ("sad", "ssd"):
        mv = registry.run_compute_kernel(
            ctx, [luma_sample(shifted), luma_sample(base_ref)],
            create_picture_sample((W // BLOCK, H // BLOCK), PixelFormat.RGBA,
                                  asset_id="mv", workspace_id="w"),
            registry.default_compute_kernel_from_string(me_names[metric])
        ).planes()[0][2:-2, 2:-2].cpu()
        if not (bool((mv[..., 0] == want_x).all())
                and bool((mv[..., 2] == want_y).all())):
            fail(f"{metric}: shift ({dx}, {dy}) not recovered on interior "
                 "blocks")
    parts.append(f"shift ({dx}, {dy}) recovered on every interior block, sad "
                 "and ssd")
    print("[10 motion via run_compute_kernel, exact] " + "; ".join(parts),
          flush=True)

    # phase 11: times of K3, K4, K5 and their plain versions
    def k3_call():
        return frame.composite_frame_cuda((W, H), full, PixelFormat.RGBA)

    times["K3"] = timed_ms(k3_call)
    dev_ms["K3"] = device_ms(k3_call, "frame_composite_rgba_kernel")
    host["K3"] = host_us(k3_call)
    plain["K3"] = timed_ms(lambda: composite.composite_stack_torch(
        PixelFormat.RGBA, (W, H), full, dev), batch=2)
    me_bounds = {}
    for key, metric, res in me_cases:
        cur, ref = me_frames[res]

        def me_call(cur=cur, ref=ref, metric=metric):
            return motion.me_fullsearch(cur, ref, BLOCK, SEARCH, metric)

        times[(key, res)] = timed_ms(me_call, reps=10, batch=5, warmup=2)
        dev_ms[(key, res)] = device_ms(me_call, motion.KERNELS[metric])
        plain[(key, res)] = timed_ms(lambda: motion.me_fullsearch_torch(
            cur, ref, BLOCK, SEARCH, metric), reps=3, batch=1, warmup=1)
        me_bounds[(key, res)] = motion_bound(*cur.shape, metric, motion,
                                             sad_terms_per_op, clock_hz)
        if me_bounds[(key, res)][0] > dev_ms[(key, res)]:
            fail(f"{key} {res}: device time {dev_ms[(key, res)]:.4f} ms is "
                 f"below its bound {me_bounds[(key, res)][0]:.4f} ms")
    k3_bound = bound(frame_bytes((W, H), full, PixelFormat.RGBA), 0, 1.0)[0]
    print(f"[11 timings, ms] K3: call {times['K3']:.4f} device "
          f"{dev_ms['K3']:.4f} host {host['K3']:.1f} us plain "
          f"{plain['K3']:.4f} bound {k3_bound:.4f} share "
          f"{k3_bound / dev_ms['K3']:.1%}; " + "; ".join(
              f"{' '.join(k)}: call {times[k]:.4f} device {dev_ms[k]:.4f} "
              f"plain {plain[k]:.4f} bound {me_bounds[k][0]:.6f} "
              f"({me_bounds[k][1]}) share {me_bounds[k][0] / dev_ms[k]:.1%}"
              for k in me_bounds) + f" | {smi}", flush=True)

    frame_rows = [
        ("K1", "frame_composite (K1: planar-yuv cameras)", cam_srcs,
         PixelFormat.y420p, yuv_launches),
        ("K2", "frame_composite (K2: RGBA overlay)", ov_srcs,
         PixelFormat.y420p, yuv_launches),
        ("K3", "frame_composite (K3: RGBA/BGRA target)", full,
         PixelFormat.RGBA, rgba_launches)]
    kernels = []
    for key, name, srcs, fmt, n_launch in frame_rows:
        bms, by = bound(frame_bytes((W, H), srcs, fmt), 0, 1.0)
        kernels.append({"name": name, "route": "cuda",
                        "source": "swiftvideo_tpu_torch/csrc/frame_composite.cu",
                        "replaces": REPLACES[key], "launches": n_launch,
                        "max_abs_err": errs[key], "ms": times[key],
                        "device_ms": dev_ms[key], "plain_ms": plain[key],
                        "bound_ms": bms, "bound_by": by, "library_ms": None})
    for key, metric, res in me_cases:
        bms, by = me_bounds[(key, res)]
        kernels.append({"name": f"{motion.KERNELS[metric]} ({key}: "
                                f"{metric.upper()}, {res} {BLOCK}/{SEARCH})",
                        "route": "cuda",
                        "source": "swiftvideo_tpu_torch/csrc/motion_search.cu",
                        "replaces": REPLACES[key],
                        "launches": me_launches[(key, res)], "max_abs_err": 0,
                        "ms": times[(key, res)],
                        "device_ms": dev_ms[(key, res)],
                        "plain_ms": plain[(key, res)],
                        "bound_ms": bms, "bound_by": by, "library_ms": None})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
