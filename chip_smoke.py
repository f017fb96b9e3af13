"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the three kernel sources of ``swiftvideo_tpu_torch/csrc`` (one nvcc
each, started together) and drives the port's paths at full size:

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
  shifted by a known vector; at search 48 through the entry point too,
  on a frame moved 16 columns (where the u8 emit's float32 table, the one
  every route reads, differs from the float64 oracles').  Phase 2 prints
  each motion kernel's registers and shared memory (ptxas) and what its
  SASS holds (``cuobjdump -sass``): the SSD and coarse kernels must hold an
  integer tensor-core instruction, the refine kernel byte-SIMD SAD and dot
  products, and the SAD kernel's byte-SIMD opcode sets its bound;
* the batch paths (phases 12-15): the transcode ladder (config 4, a 1080p
  frame to 1280x720, 854x480 and 640x360 through ``matscale.scale_y420p``:
  one frame-kernel launch a rung, no product or plain call, 0 LSB against
  the plain composite); the HLS ladder (phase 12b, the ladder cell's path:
  16 1080p frames to Apple's five rungs by one ``matscale.scale_ladder``
  call, three frame-kernel launches by the C entry's count and the
  profiler's, every rung 0 LSB against the plain composite of each frame
  and against ``scale_y420p_batch``), the device resampler (config 2, 128 channels of
  44 100 samples, 44.1 -> 48 kHz, within 1e-4 of the host route with equal
  counts), the SRC stage's device route (pts and counts equal to the host
  route's), and the mixing wall (config 5, 64 1080p streams onto a
  1920x1088 canvas of 240x136 tiles with 800 stereo samples each): its
  default and per-cell ticks each one cell launch of the frame kernel per
  32 streams (two a tick) straight onto the canvas, no product, plain or
  tile-assembly call, every tile 0 LSB against the plain composite of its
  stream, the audio equal to the host sum, and 60 streams on the same grid
  (two launches, the excess cells blank from the kernel's clear), each
  tick on every batch of a ring of ``WALL_RING`` input batches and timed
  over the ring (new frames at new addresses each tick); the wall's audio
  mix kernel (``wall_audio_kernel``) alone on the tick's 64 x 1600 s16,
  bit-exact against its plain version and its in-order float32 contract,
  timed beside the plain version's six torch ops.
  The dense products, the route these paths took before, run beside them
  as a comparison only (within 1 LSB), and ``F.grid_sample`` on the same
  inputs is timed as the library yardstick (within 1 LSB);
* the two-stage motion search (phase 17): ``me_fullsearch_pyramid`` at
  1080p and 4K, 16/64, refine 2, SSD through ``run_compute_kernel`` and SAD
  through its entry point, one launch of the coarse kernel (stride-2 grid)
  and one of the refine kernel a frame, equal to its plain version on the
  card; each stage against its own plain version (the coarse stage at
  searches 64 and 62 and strides 2 and 1, on a 1080p frame of exact ties
  too), with the blocks that differ from the exhaustive search printed for
  information, the refine as torch ops timed beside its kernel and the
  pyramid's call beside exhaustive K5's and K4's;
* packed 4:2:2 (phase 18): yuvs and zvuy cameras onto a y420p canvas through
  ``registry.composite_frame`` and a VideoMixer tick (unpacked to y422p, one
  frame-kernel launch, 0 LSB against the plain version), and yuvs and zvuy
  targets (unpacked, one frame-kernel launch as y422p, packed again, no
  plain call);
* 4:2:2 and 4:4:4 targets (phase 24): the live stack onto y422p and y444p
  at 1920x1080, 642x362 and 1918x1078 (0 LSB against the plain version),
  the Composer for 60 y422p and 30 y444p ticks (one frame-kernel launch a
  tick, no plain call), and the times of both targets and of a yuvs / zvuy
  canvas through the registry at 1080p;
* the codec-fed station (phase 19): a SyntheticSource of uncompressed 1080p
  frames and one of 44.1 kHz s16 audio through the transcoders (the audio
  SRC on the device route, segmented to 1024 samples), the Composer with an
  RGBA lower third on the card, and the uncompressed encoder; decoded again,
  the program must equal the same graph run on the CPU.  The codec
  backends found on the machine are printed first;
* the CLI and the network layer (phases 20-23): ``mix`` of a 1080p30
  manifest (a full-canvas background and four 960x540 quadrants at
  transparency 0.1) through ``cli.main`` and as ``python -m
  swiftvideo_tpu_torch mix``, one K1 launch a tick and one K3 launch a PNG,
  its PNGs byte-identical between the two and equal to the same command
  under ``SV_DEVICE=cpu``; 64 RTMP publishers into the port's server, whose
  sessions seed the 64 1080p streams of the wall (per-cell and plan ticks:
  two K1 launches each straight onto the canvas, no tile assembled, each
  tile equal to its session's stream);
  ``serve --record`` as a child (one worker, then two) taking 16
  publishers of 5 s of 1080p30 AVC at ~6 Mbit/s and AAC at ~128 kbit/s,
  every recorded file byte for byte what its publisher sent; and four of those streams through a flavor
  push, back byte-identical.  ``serve`` is host-only and runs in a child,
  so nothing forks this process after CUDA is initialised;
* the live tick's host profile (phase 25): phase 4's station on the
  Composer, 10 warm video ticks, then three windows of 60: host ms per
  video tick (p50 and p99 of the steps that mix a frame, and all host work
  a tick with the inputs' publishing), host microseconds a tick of each
  stage (cProfile; the audio chain's stages too, and the inputs' bus
  appends split into audio and pictures), the host ms of the audio-only
  steps, the TimePoints built an audio tick (cProfile's count), device
  busy ms and the device's idle share (torch.profiler's CUDA activities),
  with phase 4's launch, plain-call and 0 LSB checks; and every mixed
  audio frame of the run equal to a plain replay (each sample the
  station's mixer digested fed, in its clock step, through a fresh
  AudioMixer on its own StepClock).

Every kernel comparison is exact: the frame kernels are bit-exact against
the plain version, so one differing pixel fails the run; the float32
products of the batch paths hold their own stated tolerances.  Then it times
every kernel and its plain version with CUDA events, takes every kernel's
device time per launch from ``torch.profiler``'s kernel events, and the
frame kernels' host time per call.  A profile that loses events is taken
again; phase 16 lists every profile that came up short.  Each phase prints
one line; any failure exits non-zero.  The line before the last holds every kernel's
numbers as JSON; the last line is the run's JSON summary.  Needs a CUDA
device; imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import os
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
# torch.profiler: profiles taken per measurement at most, and every
# shortfall of the fullest one
PROFILE_TRIES = 3
profiler_notes: list[str] = []
TENSOR_OPCODES = ("IMMA", "HMMA", "HGMMA", "IGMMA")
BYTE_SAD_OPCODES = ("VABSDIFF4",)  # |a - b| over 4 bytes, summed into an accumulator
BYTE_DOT_OPCODES = ("IDP",)        # __dp4a: a 4-byte dot product into an accumulator
# the batch paths: the transcode ladder's rungs (config 4), the device
# resampler's channels and input samples (config 2: 64 stereo streams, one
# second at 44.1 kHz), the mixing wall (config 5: 64 1080p streams onto a
# 1920x1088 canvas, 8x8 tiles of 240x136, 800 stereo samples a stream)
LADDER_RUNGS = ((1280, 720), (854, 480), (640, 360))
# the HLS ladder (the ladder1080-hls cell's path): channels a tick and
# Apple's five 16:9 rungs
HLS_CHANNELS = 16
HLS_RUNGS = ((1280, 720), (960, 540), (768, 432), (640, 360), (416, 234))
RESAMPLE_CHANNELS, RESAMPLE_IN = 128, 44100
WALL_STREAMS, WALL_CANVAS, WALL_SAMPLES = 64, (1920, 1088), 800
# the wall's ticks are timed over a ring of this many distinct input batches
# (new frames at new addresses each tick, as a live wall gets them)
WALL_RING = 3
REPLACES = {"K1": "swiftvideo_tpu/ops/pallas_frame.py:127",
            "K2": "swiftvideo_tpu/ops/pallas_frame.py:1100",
            "K3": "swiftvideo_tpu/ops/pallas_frame.py:1524",
            "K4": "swiftvideo_tpu/ops/motion.py:260",
            "K5": "swiftvideo_tpu/ops/motion.py:982",
            # the pyramid's two stages: the grouped-conv coarse program and
            # the refine program (both XLA, around no Pallas kernel)
            "coarse": "swiftvideo_tpu/ops/motion.py:537",
            "refine": "swiftvideo_tpu/ops/motion.py:1265",
            # the wall's audio: XLA ops, no Pallas kernel
            "wall audio": "swiftvideo_tpu/parallel/wall.py:126"}
# the two-stage search (phase 17) and the codec-fed station (phase 19): the
# refine's half-width, and the station's video frames and 10 ms audio
# packets at 44.1 kHz
REFINE = 2
PYRAMID_SIZES = (("1080p", (1080, 1920)), ("4K", (2160, 3840)))
STATION_FRAMES, STATION_AUDIO = 8, 30


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


@contextlib.contextmanager
def counting_assembly():
    """A Counter of the wall's tile-assembly calls (``_rows_assemble``,
    ``MixingWall._blank_fix``) made inside the block."""
    from swiftvideo_tpu_torch.parallel import wall as wall_mod
    seen = Counter()
    rows, blank = wall_mod._rows_assemble, wall_mod.MixingWall._blank_fix

    def rows_counted(*args, **kwargs):
        seen["_rows_assemble"] += 1
        return rows(*args, **kwargs)

    def blank_counted(*args, **kwargs):
        seen["_blank_fix"] += 1
        return blank(*args, **kwargs)

    wall_mod._rows_assemble = rows_counted
    wall_mod.MixingWall._blank_fix = blank_counted
    try:
        yield seen
    finally:
        wall_mod._rows_assemble, wall_mod.MixingWall._blank_fix = rows, blank


def wall_batches(dev, n, seed, count):
    """``count`` batches of ``n`` random 1920x1080 y420p streams made on
    the card, batch k from seed ``seed + k``: [(ys, us, vs)]."""
    batches = []
    for k in range(count):
        gen = torch.Generator(device=dev).manual_seed(seed + k)
        ys = torch.randint(0, 256, (n, H, W), dtype=torch.uint8, device=dev,
                           generator=gen)
        us, vs = (torch.randint(0, 256, (n, H // 2, W // 2), dtype=torch.uint8,
                                device=dev, generator=gen) for _ in range(2))
        batches.append((ys, us, vs))
    return batches


def ring_of(batches):
    """A function returning the next batch of ``batches`` each call, in
    turn."""
    turn = [0]

    def next_batch():
        turn[0] = (turn[0] + 1) % len(batches)
        return batches[turn[0]]
    return next_batch


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


def profiled(fn, n, warm):
    """{(name, start us, end us)} of every device activity that
    torch.profiler records over ``n`` calls of ``fn`` after ``warm`` calls.
    In a long run a profile can lose some: usually one to three, once 41
    of 60 launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return {(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.device_type == DeviceType.CUDA}


def device_ms(fn, kernel, n=60):
    """Mean device time per launch of the kernel whose name holds
    ``kernel``, from torch.profiler's CUDA kernel events over ``n`` warm
    calls that each launch it once.  A profile that records fewer than ``n``
    launches is taken again, up to ``PROFILE_TRIES`` times, and the fullest
    one is kept; each shortfall goes into ``profiler_notes``.  When no
    profile records half the launches, the time is the CUDA-event time per
    call (``timed_ms``), and the note says so."""
    best = []
    for _ in range(PROFILE_TRIES):
        us = [end - start for name, start, end in profiled(fn, n, 3)
              if kernel in name]
        best = max(best, us, key=len)
        if len(best) >= n:
            return float(np.mean(best)) / 1e3
    if len(best) >= n // 2:
        profiler_notes.append(f"{kernel}: {len(best)} of {n} launches recorded "
                              f"at best in {PROFILE_TRIES} profiles; device "
                              f"time is their mean")
        return float(np.mean(best)) / 1e3
    profiler_notes.append(f"{kernel}: {len(best)} of {n} launches recorded at "
                          f"best in {PROFILE_TRIES} profiles; device time from "
                          f"CUDA events instead")
    return timed_ms(fn)


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


def device_total_ms(fn, n=20):
    """(device ms per call, device activities per call): every kernel, copy
    and fill that torch.profiler records on the card over ``n`` warm calls,
    summed, over ``n``.  Each call makes the same activities, so a count
    that ``n`` does not divide means the profile lost some: it is taken
    again, up to ``PROFILE_TRIES`` times, and the fullest one is kept, with
    a note in ``profiler_notes``.  When no profile records any activity,
    the time is the CUDA-event time per call (``timed_ms``)."""
    best = set()
    for _ in range(PROFILE_TRIES):
        spans = profiled(fn, n, 2)
        best = max(best, spans, key=len)
        if best and len(best) % n == 0:
            break
    else:
        name = getattr(fn, "__name__", "a call")
        if not best:
            profiler_notes.append(f"{name}: no device activity recorded in "
                                  f"{PROFILE_TRIES} profiles; device time from "
                                  f"CUDA events instead")
            return timed_ms(fn, reps=5, batch=2), float("nan")
        profiler_notes.append(f"{name}: {len(best)} device activities over {n} "
                              f"calls at best in {PROFILE_TRIES} profiles, not "
                              f"a multiple of {n}")
    return (sum(end - start for _n, start, end in best) / n / 1e3,
            len(best) / n)


def host_ms(fn, n=10):
    """Median host-clock ms of ``n`` calls that each end on the host (a
    copy back), after one warm call."""
    fn()
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def scale_flops(plan, in_hw):
    """Multiply-adds x 2 of one y420p frame through ``plan``: V @ X then
    (V X) @ H for the luma plane and both chroma planes."""
    ih, iw = in_hw
    (ow, oh) = plan.out_size
    luma = 2 * oh * ih * iw + 2 * oh * iw * ow
    chroma = 2 * (oh // 2) * (ih // 2) * (iw // 2) \
        + 2 * (oh // 2) * (iw // 2) * (ow // 2)
    return luma + 2 * chroma


def y420p_bytes(w, h):
    return w * h + 2 * (w // 2) * (h // 2)


def tap_bytes(plans, in_hw, sector=32):
    """Bytes a y420p scale must read of one source: the whole ``sector``-
    byte sectors that hold a tap some plan of ``plans`` weights (a row its
    V hits, a column its H hits), each sector once however many plans read
    it.  A downscale reads only the rows and columns its taps land on, so
    this, not the whole frame, is the least the function must read."""
    ih, iw = in_hw
    total = 0
    for mats, pitch in ((lambda p: (p.vy, p.hy), iw),
                        (lambda p: (p.vc, p.hc), iw // 2),
                        (lambda p: (p.vc, p.hc), iw // 2)):
        hit = np.zeros(0, np.int64)
        for plan in plans:
            v, hmat = mats(plan)
            rows, cols = np.flatnonzero(v.any(0)), np.flatnonzero(hmat.any(1))
            hit = np.union1d(hit, (rows[:, None] * pitch + cols[None, :])
                             // sector)
        total += hit.size * sector
    return total


def sample_grids(plan, in_hw, dev, n=1):
    """``F.grid_sample`` grids [n, h, w, 2] of the luma and the chroma
    planes of a y420p scale: the plan's affine ``src = a * i + b`` in texel
    units (``matscale._plane_params_np``, float32 as the plan takes it) as
    ``align_corners=False``'s normalised positions (2 src + 1) / n_in - 1.
    Border padding clamps them as golden's taps clamp, so on a
    full-coverage scale this is golden's bilinear sample up to float32
    rounding (within 1 LSB).  A yardstick only: no path of the port calls
    ``grid_sample``."""
    from swiftvideo_tpu_torch.ops import matscale
    ih, iw = in_hw
    ow, oh = plan.out_size
    grids = []
    for h, w, hin, win in ((oh, ow, ih, iw),
                           (oh // 2, ow // 2, ih // 2, iw // 2)):
        ay, by, ax, bx = matscale._plane_params_np(plan.uniform, h, w, hin,
                                                   win)[:4]
        sx = (ax * np.arange(w, dtype=np.float32) + bx).astype(np.float64)
        sy = (ay * np.arange(h, dtype=np.float32) + by).astype(np.float64)
        g = np.empty((h, w, 2), np.float32)
        g[..., 0] = ((2.0 * sx + 1.0) / win - 1.0)[None, :]
        g[..., 1] = ((2.0 * sy + 1.0) / hin - 1.0)[:, None]
        grids.append(torch.from_numpy(g)[None].expand(n, h, w, 2)
                     .contiguous().to(dev))
    return grids


def grid_sample_y420p(planes, grids):
    """The library yardstick of a y420p scale: u8 to float32, one
    ``F.grid_sample`` (bilinear, border, ``align_corners=False``) for the
    luma and one for cb and cr as two channels, a round and a clamp back to
    u8.  ``planes``: [h, w] or [N, h, w] planes; ``grids``: ``sample_grids``
    of the same N."""
    import torch.nn.functional as F
    y, cb, cr = planes
    gy, gc = grids
    kw = dict(mode="bilinear", padding_mode="border", align_corners=False)
    luma = F.grid_sample(y.reshape(-1, 1, *y.shape[-2:]).float(), gy, **kw)
    chroma = F.grid_sample(torch.stack((cb, cr), -3).reshape(
        -1, 2, *cb.shape[-2:]).float(), gc, **kw)
    out = [torch.clamp(torch.round(t), 0, 255).to(torch.uint8)
           for t in (luma[:, 0], chroma[:, 0], chroma[:, 1])]
    return out if y.dim() == 3 else [t[0] for t in out]


def hls_ladder_phase(dev, smi, plain_scale):
    """Phase 12b: the ladder cell's path, ``HLS_CHANNELS`` random 1080p
    frames to every rung of ``HLS_RUNGS`` by one ``matscale.scale_ladder``
    call (``frame.composite_ladder_cuda``: one kept plan, one C call).  The
    call must make 3 K1 launches (the C entry's count, and the profiler's
    device activities a call, less what a profile lost), no product or
    plain call, and every rung must equal, at 0 LSB, the plain composite
    (``plain_scale``) of each frame and ``scale_y420p_batch`` of that rung.
    Returns the kernels line's row."""
    from swiftvideo_tpu_torch.core import spans
    from swiftvideo_tpu_torch.ops import composite, frame, matscale
    from swiftvideo_tpu_torch.ops.uniforms import identity_uniforms
    n = HLS_CHANNELS
    ys, us, vs = wall_batches(dev, n, 23, 1)[0]
    plans = [matscale.plan_scale(identity_uniforms((W, H), r), r, (H, W))
             for r in HLS_RUNGS]
    if any(p is None for p in plans):
        fail("the HLS rungs have no scale plan")

    def hls():
        return matscale.scale_ladder(ys, us, vs, plans)

    def hls_plain():
        return [[torch.stack(t) for t in zip(*(
            plain_scale([ys[i], us[i], vs[i]], (W, H), r)
            for i in range(n)))] for r in HLS_RUNGS]

    grids = [sample_grids(p, (H, W), dev, n) for p in plans]

    def hls_library():
        return [grid_sample_y420p([ys, us, vs], g) for g in grids]

    hls()
    torch.cuda.synchronize()
    frame.launches = composite.calls = matscale.calls = 0
    spans.start()
    try:
        outs = hls()
        torch.cuda.synchronize()
    finally:
        rec = spans.stop()
    counts = (frame.launches, matscale.calls, composite.calls)
    made = (rec.counters.get("frame.cell_launches", 0),
            rec.counters.get("frame.cell_row_launches", 0))
    fast = rec.counters.get("frame.cell_plan_fast", 0)
    dev_ms, acts = device_total_ms(hls)
    if (counts != (3, 0, 0) or made != (3, 3) or fast != 1
            or not made[0] - 1 < acts <= made[0]):
        fail(f"the HLS ladder: {counts[0]} K1 launches (want 3), "
             f"{counts[1]} product calls, {counts[2]} plain composites, "
             f"(launches, row-kernel launches) by the C entry {made} (want "
             f"(3, 3)), {fast} lookups the kept plan answered (want 1), the "
             f"profiler's {acts} device activities a call (want the counted "
             f"{made[0]}, less what a profile lost)")
    parts, err = [], 0
    for r, p, out, want, lib in zip(HLS_RUNGS, plans, outs, hls_plain(),
                                    hls_library()):
        w, h = r
        batch = matscale.scale_y420p_batch(ys, us, vs, p)
        p_err, p_above = max_err(out, want)
        b_err, b_above = max_err(out, batch)
        l_err, l_at1 = max_err(lib, want)
        err = max(err, p_err, b_err)
        if (p_err > LSB or p_above or b_err or b_above or l_err > 1
                or [tuple(t.shape) for t in out]
                != [(n, h, w), (n, h // 2, w // 2), (n, h // 2, w // 2)]
                or not all(t.device == dev and t.dtype == torch.uint8
                           for t in out)):
            fail(f"HLS rung {w}x{h}: vs plain err {p_err} ({p_above} px "
                 f"differ), vs scale_y420p_batch err {b_err} ({b_above} px "
                 f"differ), grid_sample vs plain {l_err}, shapes "
                 f"{[tuple(t.shape) for t in out]}")
        parts.append(f"{w}x{h} err {p_err} vs plain, {b_err} vs the batch "
                     f"scale, grid_sample err {l_err} ({l_at1} px at 1 LSB)")
    ms = timed_ms(hls, reps=10, batch=5)
    host = host_us(hls, n=20)
    plain_ms = timed_ms(hls_plain, reps=2, batch=1, warmup=1)
    lib_ms = timed_ms(hls_library, reps=5, batch=2)
    nbytes = n * (tap_bytes(plans, (H, W))
                  + sum(y420p_bytes(*r) for r in HLS_RUNGS))
    bms, by = bound(nbytes, 0, 1.0)
    print(f"[12b HLS ladder, the ladder cell's path: {n} x {W}x{H} y420p -> "
          + ", ".join(f"{w}x{h}" for w, h in HLS_RUNGS)
          + f" by one matscale.scale_ladder call, tol {LSB} LSB vs plain and "
          f"vs scale_y420p_batch] " + "; ".join(parts)
          + f" | {counts[0]} K1 launches (C entry {made[0]}, row kernel "
          f"{made[1]}; profiler {acts:.2f} a call), {counts[1]} product "
          f"calls, {counts[2]} plain composites, kept plan {fast} | call "
          f"{ms:.4f} ms, device {dev_ms:.4f} ms, host {host:.1f} us | the "
          f"function: {nbytes / 1e6:.3f} MB of tap sectors (each once) and "
          f"rungs, byte bound {bms:.6f} ms, share {bms / dev_ms:.1%} | plain "
          f"{plain_ms:.4f} ms | grid_sample (library yardstick) call "
          f"{lib_ms:.4f} ms | {smi}", flush=True)
    return {"name": f"frame_composite (K1: HLS ladder, {n} x {W}x{H} -> "
                    + ", ".join(f"{w}x{h}" for w, h in HLS_RUNGS)
                    + ", one scale_ladder call)",
            "route": "cuda",
            "source": "swiftvideo_tpu_torch/csrc/frame_composite.cu",
            "replaces": REPLACES["K1"], "launches": counts[0],
            "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
            "host_us": host, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by, "library_ms": lib_ms}


def batch_phases(dev, smi, rng):
    """Phases 12-15: the batch paths of configs 4, 2 and 5 through the
    port's entry points on ``dev``.  Returns the kernels line's rows of
    K1 on the ladder, on one wall cell and on the wall tick."""
    from swiftvideo_tpu_torch.core import TimePoint, spans
    from swiftvideo_tpu_torch.media import AudioFormat, AudioSample, PixelFormat
    from swiftvideo_tpu_torch.mix import AudioSampleRateConversion
    from swiftvideo_tpu_torch.ops import (audio, composite, frame, matscale,
                                          resample)
    from swiftvideo_tpu_torch.ops.uniforms import identity_uniforms
    from swiftvideo_tpu_torch.parallel import MixingWall
    y420p = PixelFormat.y420p

    def plain_scale(planes, in_size, out_size, uni=None):
        return composite.composite_stack_torch(
            y420p, out_size, [(planes, y420p, identity_uniforms(
                in_size, out_size) if uni is None else uni)], dev)

    # phase 12: the transcode ladder (config 4), one frame to three rungs
    src = [torch.from_numpy(p).to(dev)
           for p in camera_planes(rng, 1, W, H)[0]]
    plans = [matscale.plan_scale(identity_uniforms((W, H), r), r, (H, W))
             for r in LADDER_RUNGS]
    if any(p is None for p in plans):
        fail("the ladder's rungs have no scale plan")

    def ladder():
        return [matscale.scale_y420p(src, p) for p in plans]

    def ladder_products():
        return [matscale.products(*src, p) for p in plans]

    def ladder_plain():
        return [plain_scale(src, (W, H), r) for r in LADDER_RUNGS]

    lad_grids = [sample_grids(p, (H, W), dev) for p in plans]

    def ladder_library():
        return [grid_sample_y420p(src, g) for g in lad_grids]

    torch.cuda.synchronize()
    frame.launches = composite.calls = matscale.calls = 0
    outs = ladder()
    torch.cuda.synchronize()
    lad_counts = (frame.launches, matscale.calls, composite.calls)
    if lad_counts != (len(plans), 0, 0):
        fail(f"the ladder made {lad_counts[0]} K1 launches (want "
             f"{len(plans)}), {lad_counts[1]} product calls and "
             f"{lad_counts[2]} plain composites")
    parts, lad_err = [], 0
    for r, out, dense, lib in zip(LADDER_RUNGS, outs, ladder_products(),
                                  ladder_library()):
        want = plain_scale(src, (W, H), r)
        err, above = max_err(out, want)
        d_err, d_at1 = max_err(dense, want)
        l_err, l_at1 = max_err(lib, want)
        lad_err = max(lad_err, err)
        if err > LSB or above or d_err > 1 or l_err > 1 or not all(
                o.device == dev and o.dtype == torch.uint8 for o in out):
            fail(f"ladder {r}: K1 vs plain err {err} ({above} px differ), "
                 f"products vs plain {d_err}, grid_sample vs plain {l_err}")
        parts.append(f"{r[0]}x{r[1]} K1 err {err}, products err {d_err} "
                     f"({d_at1} px at 1 LSB), grid_sample err {l_err} "
                     f"({l_at1} px at 1 LSB)")
    lad_ms = timed_ms(ladder, reps=10, batch=5)
    lad_dev, lad_acts = device_total_ms(ladder)
    lad_host = host_us(ladder)
    prod_ms = timed_ms(ladder_products, reps=10, batch=5)
    prod_dev, prod_acts = device_total_ms(ladder_products)
    lad_lib_ms = timed_ms(ladder_library, reps=10, batch=5)
    lad_lib_dev, lad_lib_acts = device_total_ms(ladder_library)
    lad_plain_ms = timed_ms(ladder_plain, reps=3, batch=1, warmup=1)
    lad_flops = sum(scale_flops(p, (H, W)) for p in plans)
    lad_bytes = y420p_bytes(W, H) + sum(y420p_bytes(*r) for r in LADDER_RUNGS)
    lad_bound, lad_by = bound(lad_bytes, lad_flops, NONTENSOR_OPS)
    lad_taps = tap_bytes(plans, (H, W)) + sum(y420p_bytes(*r)
                                              for r in LADDER_RUNGS)
    lad_fn, lad_fn_by = bound(lad_taps, 0, 1.0)
    print(f"[12 ladder, config 4: {W}x{H} y420p -> {len(plans)} rungs by "
          f"matscale.scale_y420p, tol {LSB} LSB vs plain; the products and "
          f"grid_sample, comparisons only, 1 LSB] " + "; ".join(parts)
          + f" | {lad_counts[0]} K1 launches, {lad_counts[1]} product calls, "
          f"{lad_counts[2]} plain composites | call {lad_ms:.4f} ms, device "
          f"{lad_dev:.4f} ms ({lad_acts:.0f} device activities a call), host "
          f"{lad_host:.1f} us | the function: {lad_taps / 1e6:.3f} MB of tap "
          f"sectors and targets, byte bound {lad_fn:.6f} ms, share "
          f"{lad_fn / lad_dev:.1%} | plain {lad_plain_ms:.4f} ms | "
          f"grid_sample (library yardstick): call {lad_lib_ms:.4f} ms, device "
          f"{lad_lib_dev:.4f} ms ({lad_lib_acts:.0f} activities) | the "
          f"products (the route before, comparison only): call {prod_ms:.4f} "
          f"ms, device {prod_dev:.4f} ms ({prod_acts:.0f} activities), "
          f"{lad_flops / 1e9:.3f} GFLOP, {lad_bytes / 1e6:.3f} MB, dense "
          f"bound {lad_bound:.4f} ms ({lad_by}), share {lad_bound / prod_dev:.1%}"
          f", share of the function's bound {lad_fn / prod_dev:.2%} | {smi}",
          flush=True)
    ladder_row = {
        "name": f"frame_composite (K1: ladder, {W}x{H} -> "
                + ", ".join(f"{w}x{h}" for w, h in LADDER_RUNGS)
                + ", one launch a rung)",
        "route": "cuda", "source": "swiftvideo_tpu_torch/csrc/frame_composite.cu",
        "replaces": REPLACES["K1"], "launches": lad_counts[0],
        "max_abs_err": lad_err, "ms": lad_ms, "device_ms": lad_dev,
        "plain_ms": lad_plain_ms, "bound_ms": lad_fn, "bound_by": lad_fn_by,
        "library_ms": lad_lib_ms}

    hls_row = hls_ladder_phase(dev, smi, plain_scale)

    # phase 13: the device resampler (config 2), 44.1 -> 48 kHz
    x = np.random.default_rng(13).standard_normal(
        (RESAMPLE_CHANNELS, RESAMPLE_IN)).astype(np.float32)
    dev_rs = resample.PolyphaseResampler(44100, 48000, RESAMPLE_CHANNELS,
                                         use_device=True, device=dev)
    host_rs = resample.PolyphaseResampler(44100, 48000, RESAMPLE_CHANNELS)
    errs_rs = []
    for _ in range(3):   # the first call fills the filter, then steady state
        a, b = dev_rs.process(x), host_rs.process(x)
        if a.shape != b.shape:
            fail(f"resampler: device {a.shape} vs host {b.shape} samples")
        errs_rs.append(float(np.abs(a - b).max()))
    if max(errs_rs) >= 1e-4:
        fail(f"resampler: device vs host max abs diff {max(errs_rs)}")
    rs_ms = host_ms(lambda: dev_rs.process(x))
    rs_host_ms = host_ms(lambda: host_rs.process(x), n=3)
    h_t = torch.from_numpy(np.ascontiguousarray(dev_rs.H.T)).to(dev)
    span = torch.from_numpy(x).to(dev)
    cycles = (RESAMPLE_IN - dev_rs.R) // dev_rs.M + 1
    if tuple(resample.windows_matmul_torch(span, h_t, dev_rs.M).shape) != (
            RESAMPLE_CHANNELS, cycles, dev_rs.L):
        fail("resampler: the product's windows do not match the cycles")
    def product():
        return resample.windows_matmul_torch(span, h_t, dev_rs.M)

    rs_dev, rs_acts = device_total_ms(product)
    rs_flops = 2 * RESAMPLE_CHANNELS * cycles * dev_rs.L * dev_rs.R
    rs_bytes = 4 * RESAMPLE_CHANNELS * (RESAMPLE_IN + cycles * dev_rs.L)
    rs_bound, rs_by = bound(rs_bytes, rs_flops, NONTENSOR_OPS)
    print(f"[13 resampler, config 2: {RESAMPLE_CHANNELS} channels x "
          f"{RESAMPLE_IN} samples, 44.1 -> 48 kHz, L {dev_rs.L} M {dev_rs.M} "
          f"R {dev_rs.R}] device vs host max abs diff "
          f"{', '.join(f'{e:.3g}' for e in errs_rs)} (tol 1e-4), counts equal "
          f"({a.shape[1]} a call) | call {rs_ms:.4f} ms (host clock, copies "
          f"and the numpy result included; host route {rs_host_ms:.4f} ms), "
          f"product device {rs_dev:.4f} ms ({rs_acts:.0f} device activities), "
          f"{rs_flops / 1e9:.3f} GFLOP, {rs_bytes / 1e6:.3f} MB, bound "
          f"{rs_bound:.4f} ms ({rs_by}), share {rs_bound / rs_dev:.1%} | "
          f"{smi}", flush=True)

    # phase 14: the SRC stage on the device route, against the host route
    stages = [AudioSampleRateConversion(48000, 2, AudioFormat.s16i,
                                        use_device=flag,
                                        device=dev if flag else None)
              for flag in (True, False)]
    emitted = ([], [])
    pts = TimePoint(0, 44100)
    for n in (1024, 441, 4410, 7, 2048, 1000):
        pcm = rng.integers(-20000, 20000, 2 * n, np.int64).astype(np.int16)
        for stage, out in zip(stages, emitted):
            got = stage(AudioSample(buffers=(pcm,), frequency=44100,
                                    channels=2, format=AudioFormat.s16i,
                                    sample_count=n, pts_value=pts,
                                    id_asset="mic", id_workspace="w")).value()
            out += [] if got is None else [got]
        pts = pts + TimePoint(n, 44100)
    for stage, out in zip(stages, emitted):
        out += stage.flush()
    book = [[(e.number_samples(), e.pts().value, e.pts().scale) for e in out]
            for out in emitted]
    if book[0] != book[1] or len(book[0]) < 3:
        fail(f"SRC device route bookkeeping {book[0]} != host {book[1]}")
    pcm_err = max(int(np.abs(a.data()[0].astype(int)
                             - b.data()[0].astype(int)).max())
                  for a, b in zip(*emitted))
    print(f"[14 SRC use_device on {stages[0].device}] {len(book[0])} samples "
          f"emitted (flush included), counts and pts equal to the host route "
          f"exactly; s16 PCM max diff {pcm_err} LSB", flush=True)
    if pcm_err > 1:
        fail(f"SRC device route PCM differs by {pcm_err} LSB")

    # phase 15: the mixing wall (config 5), every stream, both paths, over a
    # ring of WALL_RING input batches (batch 0 from seed 15)
    n = WALL_STREAMS
    ring = wall_batches(dev, n, 15, WALL_RING)
    ys, us, vs = ring[0]
    pcm = rng.integers(-32768, 32768, (n, 2 * WALL_SAMPLES),
                       np.int64).astype(np.int16)
    gains = rng.choice(np.float32([0.5, 1.0, 2.0]), n)
    # powers of two: every float32 sum below 2**24 is exact in any order
    want_audio = np.clip(np.trunc((pcm.astype(np.float64)
                                   * gains[:, None]).sum(0)), -32768, 32767)
    wall = MixingWall(n_streams=n, stream_size=(W, H), canvas_size=WALL_CANVAS,
                      audio_samples=WALL_SAMPLES, device=dev)
    tw, th = wall.tile
    if not wall.aligned or wall._plan is None:
        fail(f"wall: aligned {wall.aligned}, plan {wall._plan is not None}")
    audio_t, gains_t = wall.shard(pcm), wall.shard(gains)

    def cells(planes, s, gw=wall.grid_wh[0]):
        r, c = divmod(s, gw)
        return [p[r * h:(r + 1) * h, c * w:(c + 1) * w] for p, (w, h) in zip(
            planes, ((tw, th), (tw // 2, th // 2), (tw // 2, th // 2)))]

    unis = wall.default_uniforms()
    unis[0] = identity_uniforms((W, H), (tw, th), opacity=0.5).pack()
    next_plan, next_cells = ring_of(ring), ring_of(ring)

    def tick_plan():
        return wall.step(*next_plan(), audio_t, gains_t)

    def tick_cells():
        return wall.step(*next_cells(), audio_t, gains_t, uniforms=unis)

    def counted(fn):
        """fn's result and (K1 launches, product calls, plain composites,
        tile-assembly calls, audio kernel launches) it made, each count set
        to 0 just before."""
        torch.cuda.synchronize()
        frame.launches = matscale.calls = composite.calls = 0
        audio.launches = 0
        with counting_assembly() as assembly:
            out = fn()
        torch.cuda.synchronize()
        return out, (frame.launches, matscale.calls, composite.calls,
                     sum(assembly.values()), audio.launches)

    # the kernel launches of a tick as the C call counts them: its two
    # FrameParams of 32 axis-aligned cells as one launch of the row kernel
    # (the profiler's count of the canvas launch is checked below)
    tick_launches = 1
    plain_tiles = {}

    def plain_tile(k, s, uni=None):
        """The plain composite of stream s of ring batch k alone on a
        cleared tile (kept: the ticks compare against it twice)."""
        key = (k, s, None if uni is None else uni.tobytes())
        if key not in plain_tiles:
            plain_tiles[key] = plain_scale([p[s] for p in ring[k]], (W, H),
                                           (tw, th), uni)
        return plain_tiles[key]

    # every tick of the ring: the plan tick and the per-cell tick, each
    # counted, each tile against the plain composite of its stream
    plan_err = cell_err = 0
    audio_ok = True
    plan_counts = cell_counts = None
    for k in range(WALL_RING):
        plan_out, got_plan = counted(
            lambda: wall.step(*ring[k], audio_t, gains_t))
        cell_out, got_cells = counted(
            lambda: wall.step(*ring[k], audio_t, gains_t, uniforms=unis))
        for name, got in (("plan", got_plan), ("per-cell", got_cells)):
            if got != (tick_launches, 0, 0, 0, 1):
                fail(f"wall {name} tick of ring batch {k}: {got[0]} K1 "
                     f"launches (want {tick_launches}), {got[1]} product "
                     f"calls, {got[2]} plain composites, {got[3]} tile-"
                     f"assembly calls, {got[4]} audio kernel launches "
                     f"(want 1)")
        plan_counts, cell_counts = got_plan, got_cells
        for s in range(n):
            plan_err = max(plan_err, max_err(cells(plan_out, s),
                                             plain_tile(k, s))[0])
            # tile 0 at opacity 0.5, the others the identity
            cell_err = max(cell_err, max_err(cells(cell_out, s), plain_tile(
                k, s, None if s else unis[0]))[0])
        audio_ok &= all(np.array_equal(o[3].cpu().numpy(), want_audio)
                        for o in (plan_out, cell_out))
    # the products, the route before: a comparison only
    dense = matscale.products(ys, us, vs, wall._plan)
    dense_err = dense_at1 = 0
    for s in range(n):
        e, at1 = max_err([d[s] for d in dense], plain_tile(0, s))
        dense_err, dense_at1 = max(dense_err, e), dense_at1 + at1
    if plan_err > LSB or cell_err > LSB or dense_err > 1 or not audio_ok:
        fail(f"wall: plan tick err {plan_err}, per-cell tick err {cell_err}, "
             f"products err {dense_err}, audio equal {audio_ok}")
    # 60 streams on the same 8x8 grid: 4 cells blank from the kernel's clear
    n60 = n - 4
    wall60 = MixingWall(n_streams=n60, stream_size=(W, H),
                        canvas_size=WALL_CANVAS, audio_samples=WALL_SAMPLES,
                        device=dev)
    ring60 = [tuple(p[:n60] for p in batch) for batch in ring]
    next60 = ring_of(ring60)

    def tick60():
        return wall60.step(*next60(), audio_t[:n60], gains_t[:n60])

    err60, blank = 0, True
    want60 = np.clip(np.trunc((pcm[:n60].astype(np.float64)
                               * gains[:n60, None]).sum(0)), -32768, 32767)
    for k in range(WALL_RING):
        out60, counts60 = counted(lambda: wall60.step(
            *ring60[k], audio_t[:n60], gains_t[:n60]))
        if counts60 != (tick_launches, 0, 0, 0, 1):
            fail(f"wall of {n60}, ring batch {k}: (K1 launches, product "
                 f"calls, plain composites, tile-assembly calls, audio "
                 f"kernel launches) {counts60}")
        for s in range(n60):
            err60 = max(err60, max_err(cells(out60, s), plain_tile(k, s))[0])
        blank &= all(int(c[0].max()) == 0 and all(bool((p == 128).all())
                                                  for p in c[1:])
                     for s in range(n60, n) for c in [cells(out60, s)])
        audio_ok &= np.array_equal(out60[3].cpu().numpy(), want60)
    if wall60.aligned or err60 > LSB or not blank or not audio_ok:
        fail(f"wall of {n60}: aligned {wall60.aligned}, tiles err {err60}, "
             f"excess cells blank {blank}, audio equal {audio_ok}")
    plan_ms = timed_ms(tick_plan, reps=10, batch=3)
    plan_dev, plan_acts = device_total_ms(tick_plan, n=10)
    cell_ms = timed_ms(tick_cells, reps=10, batch=3)
    cell_dev, cell_acts = device_total_ms(tick_cells, n=10)
    ms60 = timed_ms(tick60, reps=10, batch=3)
    dev60, acts60 = device_total_ms(tick60, n=10)
    tick_host = host_us(tick_plan, n=20)
    cell_host = host_us(tick_cells, n=20)
    host60 = host_us(tick60, n=20)

    def tick_products():
        # the plan tick before the cell launch: the products, then the
        # same assembly and audio
        tiles = matscale.products(ys, us, vs, wall._plan)
        return wall._assemble(tiles) + (wall._mix_audio(audio_t, gains_t),)

    prod_ms = timed_ms(tick_products, reps=10, batch=3)
    prod_dev, prod_acts = device_total_ms(tick_products, n=10)
    wall_flops = n * scale_flops(wall._plan, (H, W))
    wall_bytes = n * (y420p_bytes(W, H) + 2 * 2 * WALL_SAMPLES) \
        + y420p_bytes(*WALL_CANVAS) + 2 * 2 * WALL_SAMPLES
    wall_bound, wall_by = bound(wall_bytes, wall_flops, NONTENSOR_OPS)
    # the function's least bytes: each stream's tap sectors, the canvas,
    # the audio in and out; both paths compute it
    cell_taps = tap_bytes([wall._plan], (H, W))
    wall_taps = wall_bytes - n * y420p_bytes(W, H) + n * cell_taps
    tick_bound, _ = bound(wall_taps, 0, 1.0)

    # the canvas launch alone, on the plan tick's sources (identity cells),
    # beside its plain version and the library yardstick
    stack_unis = np.broadcast_to(wall._identity, (n, 29))
    next_stack = ring_of(ring)

    def stack_call(batch=None):
        return frame.composite_cells_cuda(
            (tw, th), list(batch or next_stack()), y420p, stack_unis,
            grid=wall.grid_wh)

    wall_grids = sample_grids(wall._plan, (H, W), dev, n)

    def stack_library():
        return grid_sample_y420p([ys, us, vs], wall_grids)

    stack, lib = stack_call(ring[0]), stack_library()
    stack_err = lib_err = lib_at1 = 0
    for s in range(n):
        stack_err = max(stack_err, max_err(cells(stack, s),
                                           plain_tile(0, s))[0])
        e, at1 = max_err([t[s] for t in lib], plain_tile(0, s))
        lib_err, lib_at1 = max(lib_err, e), lib_at1 + at1
    if stack_err > LSB or lib_err > 1:
        fail(f"the wall's {n} identity cells: the canvas launch alone err "
             f"{stack_err}, grid_sample err {lib_err} vs plain")
    stack_ms = timed_ms(stack_call)
    stack_dev, stack_acts = device_total_ms(stack_call)
    # the same launch on the tile kernel (the kept plan with its mode words
    # cleared), a comparison only: bit-exact with the row kernel's canvas
    tile_plan = frame.cell_plan((tw, th), wall.grid_wh, [ys, us, vs], y420p,
                                stack_unis).on_tiles()

    def tile_call(batch=None):
        batch = list(batch or next_stack())
        outs = [torch.empty(*s, dtype=torch.uint8, device=dev)
                for s in tile_plan.out_shapes]
        frame._launch_cells(tile_plan, outs, batch, dev)
        return outs

    def launched(fn):
        """fn's result and the (kernel launches, row-kernel launches) of
        the cell wrapper that the C call reported."""
        spans.start()
        try:
            out = fn()
            torch.cuda.synchronize()
        finally:
            rec = spans.stop()
        return out, (rec.counters.get("frame.cell_launches", 0),
                     rec.counters.get("frame.cell_row_launches", 0))

    _, stack_made = launched(lambda: stack_call(ring[0]))
    tile_out, tile_made = launched(lambda: tile_call(ring[0]))
    tile_err = max_err(tile_out, stack)[0]
    if (tile_err or stack_made != (tick_launches, tick_launches)
            or tile_made != (2, 0)
            or not stack_made[0] - 1 < stack_acts <= stack_made[0]):
        fail(f"the wall's canvas launch: tile kernel vs row kernel err "
             f"{tile_err}, (launches, row-kernel launches) counted "
             f"{stack_made} (want {(tick_launches, tick_launches)}) and on "
             f"the tile kernel {tile_made} (want (2, 0)), the profiler's "
             f"{stack_acts} device activities a call (want the counted "
             f"{stack_made[0]}, less what a profile lost)")
    tile_ms = timed_ms(tile_call)
    tile_dev, tile_acts = device_total_ms(tile_call)
    # the tick's host work: the cell wrapper, and its plan lookup (the
    # check of the batch against the kept plan; a fresh numpy build of the
    # table beside it, the table each tick built before layouts were kept)
    stack_host = host_us(stack_call, n=20)
    table_host = host_us(lambda: frame.cell_plan(
        (tw, th), wall.grid_wh, [ys, us, vs], y420p, stack_unis), n=20)
    fresh_host = host_us(lambda: frame.cell_descriptors(
        (tw, th), [ys, us, vs], y420p, stack_unis, wall.grid_wh[0]), n=20)
    stack_lib_ms = timed_ms(stack_library, reps=10, batch=3)
    stack_lib_dev, stack_lib_acts = device_total_ms(stack_library, n=10)
    stack_srcs = [([ys[i], us[i], vs[i]], y420p, wall._identity)
                  for i in range(n)]
    stack_plain_ms = timed_ms(lambda: composite.composite_cells_torch(
        (tw, th), stack_srcs, dev, grid=wall.grid_wh), reps=3, batch=1,
        warmup=1)
    stack_bms, stack_by = bound(n * cell_taps + y420p_bytes(*WALL_CANVAS), 0,
                                1.0)
    print(f"[15 wall, config 5: {n} streams {W}x{H} -> {WALL_CANVAS[0]}x"
          f"{WALL_CANVAS[1]}, {tw}x{th} tiles, {WALL_SAMPLES} stereo samples "
          f"a stream, a ring of {WALL_RING} input batches; tol {LSB} LSB vs "
          f"the per-cell plain fold] plan tick: "
          f"{plan_counts[0]} K1 launches, {plan_counts[1]} product calls, "
          f"{plan_counts[2]} plain composites, {plan_counts[3]} tile-assembly "
          f"calls, {plan_counts[4]} audio kernel launch, every tile err "
          f"{plan_err}; "
          f"per-cell tick (tile 0 at opacity 0.5): {cell_counts[0]} K1 "
          f"launches, {cell_counts[1]} product calls, {cell_counts[2]} plain "
          f"composites, {cell_counts[3]} tile-assembly calls, "
          f"{cell_counts[4]} audio kernel launch, every tile err "
          f"{cell_err}; the products (comparison "
          f"only) err {dense_err} ({dense_at1} px at 1 LSB); audio equal to "
          f"the host sum; {n60} streams: {counts60[0]} K1 launches, "
          f"{counts60[3]} tile-assembly calls, {counts60[4]} audio kernel "
          f"launch, tiles err {err60}, 4 excess "
          f"cells blank | the function: "
          f"{wall_taps / 1e6:.3f} MB of tap sectors, canvas and audio, byte "
          f"bound {tick_bound:.6f} ms | plan tick: call {plan_ms:.4f} ms, "
          f"device {plan_dev:.4f} ms ({plan_acts:.0f} device activities), "
          f"host {tick_host:.1f} us (of it the cell wrapper {stack_host:.1f} "
          f"us, its plan lookup {table_host:.1f} us; a fresh table "
          f"{fresh_host:.1f} "
          f"us), share {tick_bound / plan_dev:.1%} | "
          f"per-cell tick: call {cell_ms:.4f} ms, device {cell_dev:.4f} ms "
          f"({cell_acts:.0f} device activities), host {cell_host:.1f} us, "
          f"share {tick_bound / cell_dev:.1%} | {n60}-stream tick: call "
          f"{ms60:.4f} ms, device {dev60:.4f} ms ({acts60:.0f} device "
          f"activities), host {host60:.1f} us | the canvas launch alone ({n} "
          f"identity cells, {stack_acts:.0f} launches): call {stack_ms:.4f} "
          f"ms, device "
          f"{stack_dev:.4f} ms, bound {stack_bms:.6f} ms ({stack_by}), share "
          f"{stack_bms / stack_dev:.1%}; on the tile kernel ({tile_acts:.0f} "
          f"launches, bit-exact): call {tile_ms:.4f} ms, device "
          f"{tile_dev:.4f} ms, share {stack_bms / tile_dev:.1%}; plain "
          f"{stack_plain_ms:.4f} ms, "
          f"grid_sample [{n}, 1, {H}, {W}] (library yardstick, err {lib_err}, "
          f"{lib_at1} px at 1 LSB): call {stack_lib_ms:.4f} ms, device "
          f"{stack_lib_dev:.4f} ms ({stack_lib_acts:.0f} activities) | "
          f"the plan tick before (the products, comparison only): call "
          f"{prod_ms:.4f} ms, device {prod_dev:.4f} ms ({prod_acts:.0f} "
          f"activities), {wall_flops / 1e9:.3f} GFLOP, dense bound "
          f"{wall_bound:.4f} ms ({wall_by}), share "
          f"{wall_bound / prod_dev:.1%} | {smi}", flush=True)
    tick_row = {"name": f"frame_composite (K1: wall tick's canvas launch "
                        f"alone, {n} identity cells {W}x{H} -> {tw}x{th} "
                        f"straight onto the {WALL_CANVAS[0]}x"
                        f"{WALL_CANVAS[1]} canvas, {stack_made[0]} launches; "
                        f"launches: the plan tick's)",
                "route": "cuda",
                "source": "swiftvideo_tpu_torch/csrc/frame_composite.cu",
                "replaces": REPLACES["K1"], "launches": plan_counts[0],
                "max_abs_err": max(plan_err, cell_err, stack_err, err60),
                "ms": stack_ms,
                "device_ms": stack_dev, "plain_ms": stack_plain_ms,
                "bound_ms": stack_bms, "bound_by": stack_by,
                "library_ms": stack_lib_ms, "tile_kernel_device_ms": tile_dev}

    # one cell alone (the route before the cell grid: one launch a cell),
    # for the kernels line
    cell_srcs = [([ys[1], us[1], vs[1]], y420p, unis[1])]
    one_grids = sample_grids(wall._plan, (H, W), dev)

    def cell_call():
        return frame.composite_frame_cuda((tw, th), cell_srcs)

    def cell_library():
        return grid_sample_y420p(cell_srcs[0][0], one_grids)

    def cell_plain():
        return composite.composite_stack_torch(y420p, (tw, th), cell_srcs, dev)

    one_want = cell_plain()
    one_k1_err = max_err(cell_call(), one_want)[0]
    one_err = max_err(cell_library(), one_want)[0]
    if one_k1_err > LSB or one_err > 1:
        fail(f"one wall cell alone: the one-cell launch err {one_k1_err}, "
             f"grid_sample err {one_err} vs plain")
    k1_bms, k1_by = bound(cell_taps + y420p_bytes(tw, th), 0, 1.0)
    cell_row = {"name": f"frame_composite (K1: one wall cell alone, {W}x{H} "
                        f"-> {tw}x{th}, a one-cell launch timed for "
                        f"comparison; launches: the per-cell tick's)",
                "route": "cuda",
                "source": "swiftvideo_tpu_torch/csrc/frame_composite.cu",
                "replaces": REPLACES["K1"], "launches": cell_counts[0],
                "max_abs_err": one_k1_err, "ms": timed_ms(cell_call),
                "device_ms": device_ms(cell_call, "frame_composite_kernel"),
                "plain_ms": timed_ms(cell_plain, reps=5, batch=2),
                "bound_ms": k1_bms, "bound_by": k1_by,
                "library_ms": timed_ms(cell_library)}

    # the wall's audio mix kernel alone on the tick's audio: bit-exact
    # against the plain version under the cell's unity gains and the
    # ticks' power-of-two gains, and against the in-order float32
    # emulation under random gains
    unity_t = wall.default_gains()
    random_t = torch.from_numpy(rng.uniform(0.0, 1.7, n).astype(
        np.float32)).to(dev)
    audio.launches = 0
    mix_err = max(max_err([audio.mix_wall_s16_cuda(audio_t, g)],
                          [audio.mix_wall_s16_torch(audio_t, g)])[0]
                  for g in (unity_t, gains_t))
    order_err = max_err([audio.mix_wall_s16_cuda(audio_t, random_t)],
                        [audio.mix_wall_s16_in_order(audio_t, random_t)])[0]
    torch.cuda.synchronize()
    mix_launches = audio.launches
    if mix_err or order_err or mix_launches != 3:
        fail(f"wall audio kernel: err {mix_err} vs plain, {order_err} vs the "
             f"in-order emulation, {mix_launches} launches for 3 calls")

    def mix_call():
        return audio.mix_wall_s16_cuda(audio_t, unity_t)

    def mix_plain():
        return audio.mix_wall_s16_torch(audio_t, unity_t)

    mix_bytes = audio_t.numel() * 2 + unity_t.numel() * 4 \
        + audio_t.shape[1] * 2
    mix_bms, mix_by = bound(mix_bytes, 0, 1.0)
    mix_ms, mix_dev = timed_ms(mix_call), device_ms(mix_call, audio.KERNEL)
    mix_host = host_us(mix_call, n=200)
    mix_plain_ms = timed_ms(mix_plain)
    mix_plain_host = host_us(mix_plain, n=200)
    print(f"[15 wall audio, {n} streams x {audio_t.shape[1]} s16] "
          f"{audio.KERNEL}: err {mix_err} vs plain (unity and power-of-two "
          f"gains), {order_err} vs the in-order emulation (random gains), one "
          f"launch a call, {plan_counts[4]} a wall tick | call {mix_ms * 1e3:.2f} us, device "
          f"{mix_dev * 1e3:.2f} us, host {mix_host:.1f} us, byte bound "
          f"{mix_bms * 1e3:.4f} us ({mix_bytes} B), share "
          f"{mix_bms / mix_dev:.2%} | plain (six torch ops): call "
          f"{mix_plain_ms * 1e3:.2f} us, host {mix_plain_host:.1f} us | {smi}",
          flush=True)
    mix_row = {"name": f"{audio.KERNEL} (the wall's audio mix: {n} streams x "
                       f"{audio_t.shape[1]} s16, unity gains)",
               "route": "cuda",
               "source": "swiftvideo_tpu_torch/csrc/audio_mix.cu",
               "replaces": REPLACES["wall audio"],
               "launches": plan_counts[4],
               "max_abs_err": max(mix_err, order_err), "ms": mix_ms,
               "device_ms": mix_dev, "plain_ms": mix_plain_ms,
               "bound_ms": mix_bms, "bound_by": mix_by, "library_ms": None}
    return [ladder_row, hls_row, cell_row, tick_row, mix_row]


def pyramid_frames(h, w, seed, dev):
    """(cur, ref) luma on ``dev``: smooth content (the JAX pyramid test's
    sinusoids) with noise in [-4, 4], and cur the same content moved by
    (3, -5), an odd shift the stride-2 grid misses, with its own noise."""
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h + 3, 0:w + 5].astype(np.float64)
    base = (np.sin(yy / 9.0) + np.cos(xx / 7.0) + 2.0) * 60.0

    def noisy(a):
        return torch.from_numpy(np.clip(a + r.integers(-4, 5, a.shape), 0,
                                        255).astype(np.uint8)).to(dev)
    return noisy(base[:h, 5:]), noisy(base[3:, :w])


def grid_candidates(h, w, motion, stride):
    """Candidates of the coarse stage's ``stride`` grid summed over the
    blocks (tx - ox - d_lo and ty - ylo multiples of ``stride``), and the
    candidates of the refine stage (inside each block's window at most
    (2 REFINE + 1)^2; all of them, as an upper count)."""
    d_lo = BLOCK // 2 - SEARCH // 2
    ox = np.arange(w // BLOCK) * BLOCK
    oy = np.arange(h // BLOCK) * BLOCK
    xlo, xhi = motion.search_bounds(ox, BLOCK, SEARCH, w)
    ylo, yhi = motion.search_bounds(oy, BLOCK, SEARCH, h)
    nx = sum(sum(1 for tx in range(a, b) if (tx - o - d_lo) % stride == 0)
             for o, a, b in zip(ox, xlo, xhi))
    ny = sum(len(range(a, b, stride)) for a, b in zip(ylo, yhi))
    return nx * ny, len(ox) * len(oy) * (2 * REFINE + 1) ** 2


def lattice_frames(h, w, dev):
    """(cur, ref) on ``dev`` whose coarse candidates tie exactly: ref(x, y) =
    T[(x + y // 4) % 8, y % 16] and cur(x, y) = ref(x + 2, y - 8), so the
    vectors (2, -8) and (-2, 8) have equal scores and costs, and the one the
    two-stage minimum takes (tx first) lies in the coarse kernel's second M
    tile while its first tile holds the other."""
    table = np.random.default_rng(5).integers(0, 256, (8, 16))
    yy, xx = np.mgrid[0:h + 8, 0:w + 2]
    big = table[(xx + yy // 4) % 8, yy % 16].astype(np.uint8)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in (big[:h, 2:w + 2], big[8:h + 8, :w]))


def pyramid_phase(dev, ctx, smi, luma_sample):
    """Phase 17: the two-stage search through the registry (ssd, its
    defaults) and its entry point (sad) at 1080p and 4K, against its plain
    version on the card; each stage against its own plain version (the
    coarse stage at searches 64 and 62, strides 2 and 1; the refine, SSD
    and SAD; at 1080p also on a frame of exact ties); the coarse and refine
    launches' times, and the pyramid's call beside exhaustive K5's and
    K4's.  Returns the kernels-line rows of the coarse kernel and the
    refine kernel."""
    from swiftvideo_tpu_torch.media import PixelFormat, create_picture_sample
    from swiftvideo_tpu_torch.ops import composite, frame, motion, registry
    kernel = registry.default_compute_kernel_from_string(
        "me_fullsearch_pyramid")
    rows, parts, launched = {}, [], {}
    errs = {"coarse": 0, "refine": 0}

    def stages_equal_plain(cur, ref, label, searches, strides):
        """Each stage against its plain version on the same inputs: the
        refine re-scores around the coarse pick, so the whole map alone
        could hide a coarse pick one grid step off."""
        for search in searches:
            for stride in strides:
                got = motion.me_coarse(cur, ref, BLOCK, search, stride)
                want = motion.me_coarse_torch(cur, ref, BLOCK, search, stride)
                e = int((got - want).abs().max())
                errs["coarse"] = max(errs["coarse"], e)
                if got.dtype != torch.int32 or e:
                    fail(f"pyramid coarse {label} {BLOCK}/{search} stride "
                         f"{stride}: the kernel's vectors differ from the "
                         f"plain version's in "
                         f"{int((got != want).any(-1).sum())} blocks (max {e})")
        raw = motion.me_coarse_torch(cur, ref, BLOCK, SEARCH,
                                     motion.coarse_stride(cur.shape[1]))
        for metric in ("ssd", "sad"):
            got = motion.me_refine(cur, ref, raw, BLOCK, SEARCH, REFINE,
                                   metric)
            want = motion.refine_torch(cur, ref, raw, BLOCK, SEARCH, REFINE,
                                       metric)
            e = max_err([got], [want])
            errs["refine"] = max(errs["refine"], e[0])
            if e[1]:
                fail(f"pyramid refine {metric} {label}: the kernel's map "
                     f"differs from the plain version's around the same "
                     f"coarse vectors in {e[1]} channels (max {e[0]})")
        return raw

    for res, (h, w) in PYRAMID_SIZES:
        cur, ref = pyramid_frames(h, w, 17, dev)
        stride = motion.coarse_stride(w)
        coarse_name = motion.COARSE_KERNELS[stride]
        for metric in ("ssd", "sad"):
            frame.launches = motion.launches = composite.calls = 0
            motion.route_launches.update(dict.fromkeys(motion.route_launches,
                                                       0))
            if metric == "ssd":   # the registry calls it with its defaults
                mv = registry.run_compute_kernel(
                    ctx, [luma_sample(cur), luma_sample(ref)],
                    create_picture_sample((w // BLOCK, h // BLOCK),
                                          PixelFormat.RGBA, asset_id="mv",
                                          workspace_id="w"),
                    kernel).planes()[0]
            else:
                mv = motion.me_fullsearch_pyramid(cur, ref, BLOCK, SEARCH,
                                                  REFINE, metric)
            torch.cuda.synchronize()
            routes = {k: n for k, n in motion.route_launches.items() if n}
            if routes != {coarse_name: 1, motion.REFINE_KERNEL: 1}:
                fail(f"pyramid {metric} {res}: launches {routes}")
            if metric == "ssd":
                launched[res] = routes
            per_frame = motion.launches
            want = motion.me_fullsearch_pyramid_torch(cur, ref, BLOCK, SEARCH,
                                                      REFINE, metric)
            if not (mv.is_cuda and torch.equal(mv, want)):
                fail(f"pyramid {metric} {res}: the kernels' MV map differs "
                     f"from the plain version's in "
                     f"{int((mv != want).any(-1).sum())} blocks")
            full = motion.me_fullsearch(cur, ref, BLOCK, SEARCH, metric)
            off = int((mv != full).any(-1).sum())
            parts.append(f"{metric} {res}: equal to plain, launches "
                         f"{per_frame} a frame ({coarse_name}, "
                         f"{motion.REFINE_KERNEL}), {off} of "
                         f"{mv.shape[0] * mv.shape[1]} blocks differ from the "
                         f"exhaustive {motion.KERNELS[metric]}")
        # the top two and the bottom block rows and the left blocks clamp
        # their windows; search 62 puts the left blocks' grid on odd tx
        raw = stages_equal_plain(cur, ref, res, (SEARCH, 62), (2, 1))
        checked = (f"{res}: coarse vectors equal to plain (searches {SEARCH} "
                   f"and 62, strides 2 and 1), refine maps equal to plain "
                   f"(ssd, sad)")
        if res == PYRAMID_SIZES[0][0]:
            stages_equal_plain(*lattice_frames(h, w, dev), f"{res} ties",
                               (SEARCH, 62), (2,))
            checked += "; the same on a frame of exact ties (stride 2)"
        parts.append(checked)

        def coarse_call(cur=cur, ref=ref, stride=stride):
            return motion.me_coarse(cur, ref, BLOCK, SEARCH, stride)

        def refine_call(cur=cur, ref=ref, raw=raw):
            return motion.me_refine(cur, ref, raw, BLOCK, SEARCH, REFINE,
                                    "ssd")

        def refine_plain(cur=cur, ref=ref, raw=raw):
            return motion.refine_torch(cur, ref, raw, BLOCK, SEARCH, REFINE,
                                       "ssd")

        def pyramid_call(cur=cur, ref=ref):
            return motion.me_fullsearch_pyramid(cur, ref, BLOCK, SEARCH,
                                                REFINE, "ssd")

        coarse_plain = timed_ms(lambda: motion.me_coarse_torch(
            cur, ref, BLOCK, SEARCH, stride), reps=3, batch=1, warmup=1)
        t = {"coarse call": timed_ms(coarse_call, reps=10, batch=5),
             "coarse device": device_ms(coarse_call, coarse_name.split()[0]),
             "refine call": timed_ms(refine_call, reps=10, batch=5),
             "refine device": device_ms(refine_call, "motion_refine_kernel"),
             "refine plain call": timed_ms(refine_plain, reps=5, batch=2),
             "refine plain device": device_total_ms(refine_plain)[0],
             "pyramid call": timed_ms(pyramid_call, reps=10, batch=5),
             "K5 call": timed_ms(lambda: motion.me_fullsearch(
                 cur, ref, BLOCK, SEARCH, "ssd"), reps=10, batch=5),
             "K4 call": timed_ms(lambda: motion.me_fullsearch(
                 cur, ref, BLOCK, SEARCH, "sad"), reps=10, batch=5),
             "coarse plain": coarse_plain}
        grid, refine_cands = grid_candidates(h, w, motion, stride)
        nbytes = 2 * h * w + (h // BLOCK) * (w // BLOCK) * 8
        # the coarse stage: the cross term's 2 operations a pixel-candidate
        # term of the stride-2 grid at the int8 tensor rate
        c_bound = bound(nbytes, 2 * BLOCK * BLOCK * grid, INT8_OPS)
        # the refine: its SSD cross term and r^2, 4 operations a term at
        # the int8 tensor rate, against the frames and vectors once
        r_bound = bound(nbytes + (h // BLOCK) * (w // BLOCK) * 4,
                        4 * BLOCK * BLOCK * refine_cands, INT8_OPS)
        if c_bound[0] > t["coarse device"] or r_bound[0] > t["refine device"]:
            fail(f"pyramid {res}: a device time is below its bound")
        rows[res] = (t, c_bound, r_bound)
        grid_ops_ms = bound(0, 2 * BLOCK * BLOCK * grid, INT8_OPS)[0]
        parts.append(
            f"{res} stride {stride}: coarse call {t['coarse call']:.4f} device "
            f"{t['coarse device']:.4f} plain {coarse_plain:.2f} bound "
            f"{c_bound[0]:.6f} ({c_bound[1]}; the int8 operations of the "
            f"grid's {grid} candidates alone {grid_ops_ms:.6f}); refine "
            f"kernel call "
            f"{t['refine call']:.4f} device {t['refine device']:.4f} bound "
            f"{r_bound[0]:.6f} ({r_bound[1]}); refine as torch ops call "
            f"{t['refine plain call']:.4f} device "
            f"{t['refine plain device']:.4f}; pyramid call "
            f"{t['pyramid call']:.4f} against exhaustive K5's call "
            f"{t['K5 call']:.4f} and K4's {t['K4 call']:.4f}")
    print("[17 pyramid, exact vs plain, ms] " + "; ".join(parts)
          + f" | {smi}", flush=True)
    t, c_bound, r_bound = rows[PYRAMID_SIZES[0][0]]
    routes = launched[PYRAMID_SIZES[0][0]]
    coarse_name = motion.COARSE_KERNELS[motion.coarse_stride(
        PYRAMID_SIZES[0][1][1])]
    return [
        {"name": f"{coarse_name} (coarse, stride 2; 1080p {BLOCK}/{SEARCH})",
         "route": "cuda",
         "source": "swiftvideo_tpu_torch/csrc/motion_search.cu",
         "replaces": REPLACES["coarse"],
         "launches": routes[coarse_name],
         "max_abs_err": errs["coarse"],
         "ms": t["coarse call"], "device_ms": t["coarse device"],
         "plain_ms": t["coarse plain"], "bound_ms": c_bound[0],
         "bound_by": c_bound[1], "library_ms": None},
        {"name": f"motion_refine_kernel (SSD, refine {REFINE}; 1080p)",
         "route": "cuda",
         "source": "swiftvideo_tpu_torch/csrc/motion_search.cu",
         "replaces": REPLACES["refine"],
         "launches": routes[motion.REFINE_KERNEL],
         "max_abs_err": errs["refine"],
         "ms": t["refine call"], "device_ms": t["refine device"],
         "plain_ms": t["refine plain call"], "bound_ms": r_bound[0],
         "bound_by": r_bound[1], "library_ms": None}]


def packed_phase(dev, ctx, rng):
    """Phase 18: packed 4:2:2 (yuvs, zvuy) cameras onto a y420p canvas
    through ``registry.composite_frame`` and a VideoMixer tick (K1, 0 LSB
    against the plain version), and yuvs and zvuy targets (unpacked, one K1
    launch as y422p, packed again; no plain call)."""
    from swiftvideo_tpu_torch.core import EventBox, StepClock, TimePoint, Tx
    from swiftvideo_tpu_torch.media import PixelFormat, create_picture_sample
    from swiftvideo_tpu_torch.media.pixel import (packed422_to_planar,
                                                  planar_to_packed422)
    from swiftvideo_tpu_torch.mix import VideoMixer
    from swiftvideo_tpu_torch.ops import composite, frame, registry
    from swiftvideo_tpu_torch.ops.uniforms import rect_uniforms
    from swiftvideo_tpu_torch.utils import matrix as m4
    y420p, parts = PixelFormat.y420p, []
    packed = torch.from_numpy(rng.integers(0, 256, (H, W, 2), np.int64)
                              .astype(np.uint8)).to(dev)
    for fmt in (PixelFormat.yuvs, PixelFormat.zvuy):
        srcs = [([packed], fmt, rect_uniforms((W, H), (W, H), x=100.25,
                                              y=60.5, w=1440, h=810,
                                              opacity=0.85))]
        frame.launches = composite.calls = 0
        got = registry.composite_frame(ctx, y420p, (W, H), srcs)
        torch.cuda.synchronize()
        if (frame.launches, composite.calls) != (1, 0):
            fail(f"{fmt.value} source: {frame.launches} K1 launches, "
                 f"{composite.calls} plain composites")
        err, above = max_err(got, composite.composite_stack_torch(
            y420p, (W, H), srcs, dev))
        if err > LSB or above:
            fail(f"{fmt.value} source: K1 vs plain max abs err {err}")
        # a VideoMixer tick with the packed camera, on the card and on the
        # CPU (the plain version)
        cam = create_picture_sample((W, H), fmt, asset_id="cam",
                                    workspace_id="w")
        cam = cam.with_(img=cam.img.with_buffers([packed]), revision="c",
                        matrix=m4.ortho(W, H) @ m4.translation(100.25, 60.5, 1)
                        @ m4.scale(1440, 810), opacity=0.85)
        ticks = {}
        for where in ("cuda", "cpu"):
            clock = StepClock(TimePoint(1000, 30000))
            mixer = VideoMixer(clock, workspace_id="w",
                               frame_duration=TimePoint(1000, 30000),
                               output_size=(W, H), output_format=y420p,
                               compute_context=(ctx if where == "cuda" else
                                                registry.make_compute_context(
                                                    "cpu")), asset_id="mix")
            out = []
            keep = mixer >> Tx(lambda s: (out.append(s), EventBox.just(s))[1])
            mixer.apply(EventBox.just(cam if where == "cuda" else cam.with_(
                img=cam.img.with_buffers([packed.cpu()]))))
            frame.launches = composite.calls = 0
            clock.step()
            torch.cuda.synchronize()
            del keep
            ticks[where] = (out, frame.launches, composite.calls)
        out, k1, plain_calls = ticks["cuda"]
        if len(out) != 1 or (k1, plain_calls) != (1, 0):
            fail(f"{fmt.value} VideoMixer tick: {len(out)} frames, {k1} K1 "
                 f"launches, {plain_calls} plain composites")
        err_m, above_m = max_err(out[0].planes(), [
            p.to(dev) for p in ticks["cpu"][0][0].planes()])
        if err_m > LSB or above_m:
            fail(f"{fmt.value} VideoMixer tick vs plain max abs err {err_m}")
        parts.append(f"{fmt.value} source via registry and VideoMixer: K1 "
                     f"launched, err {err} / {err_m} above0 {above} / "
                     f"{above_m}")
    base = torch.from_numpy(rng.integers(0, 256, (H, W, 2), np.int64)
                            .astype(np.uint8)).to(dev)
    srcs = [([packed], PixelFormat.zvuy, rect_uniforms(
        (W, H), (W, H), x=0.5, y=0.25, w=960, h=540, opacity=0.7))]
    for out_fmt in (PixelFormat.yuvs, PixelFormat.zvuy):
        frame.launches = composite.calls = 0
        got = registry.composite_frame(ctx, out_fmt, (W, H), srcs,
                                       target=[base])
        torch.cuda.synchronize()
        k1, plain_calls = frame.launches, composite.calls
        planar = composite.composite_stack_torch(
            PixelFormat.y422p, (W, H),
            [([t.contiguous() for t in packed422_to_planar(
                packed, PixelFormat.zvuy, torch)], PixelFormat.y422p,
              srcs[0][2])],
            dev, target=[t.contiguous() for t in packed422_to_planar(
                base, out_fmt, torch)])
        err, above = max_err(got, [planar_to_packed422(planar, out_fmt,
                                                       torch)])
        if (err > LSB or above or (k1, plain_calls) != (1, 0)
                or tuple(got[0].shape) != (H, W, 2) or not got[0].is_cuda):
            fail(f"{out_fmt.value} target: err {err}, {k1} K1 launches, "
                 f"{plain_calls} plain composites")
        parts.append(f"{out_fmt.value} target (K1 as y422p between unpack and "
                     f"pack): {k1} K1 launch, {plain_calls} plain, err {err} "
                     f"above0 {above}")
    print("[18 packed 4:2:2, tol 0 LSB] " + "; ".join(parts), flush=True)


# phase 24: the 4:2:2 and 4:4:4 targets (y422p, y444p; yuvs and zvuy fold as
# y422p): the live stack at these sizes, 642x362 and 1918x1078 for ragged
# chroma rows (a 321-byte 4:2:2 row) and runs; the Composer's ticks
YUV_TARGET_SIZES = ((W, H), (642, 362), (1918, 1078))
YUV_TARGET_TICKS = (("y422p", 60), ("y444p", 30))


def scaled_stack(cam_srcs, ov_srcs, size):
    """The live stack's planes placed on a ``size`` canvas: the cameras
    into its quadrants, the lower third across its width."""
    from swiftvideo_tpu_torch.ops.uniforms import rect_uniforms
    w, h = size
    ov_h = OV_H * h / H
    cams = [(planes, fmt, rect_uniforms((W, H), size, x=(s % 2) * w / 2,
                                        y=(s // 2) * h / 2, w=w / 2, h=h / 2,
                                        opacity=0.9))
            for s, (planes, fmt, _u) in enumerate(cam_srcs)]
    ovs = [(planes, fmt, rect_uniforms((W, OV_H), size, x=0,
                                       y=h - ov_h - 40 * h / H, w=w, h=ov_h))
           for planes, fmt, _u in ov_srcs]
    return cams + ovs


def yuv_targets_phase(dev, ctx, smi, cam_srcs, ov_srcs, drive_composer):
    """Phase 24: K1+K2 onto y422p and y444p targets against the plain
    version at 0 LSB (three sizes), the Composer onto those canvases (one K1
    launch a tick, no plain call), and the 1080p times of both targets and
    of a packed canvas through the registry.  Returns the two kernel rows."""
    from swiftvideo_tpu_torch.media import PixelFormat
    from swiftvideo_tpu_torch.ops import composite, frame, registry
    parts, errs = [], {}
    for size in YUV_TARGET_SIZES:
        srcs = scaled_stack(cam_srcs, ov_srcs, size)
        for fmt in (PixelFormat.y422p, PixelFormat.y444p):
            frame.launches = composite.calls = 0
            got = frame.composite_frame_cuda(size, srcs, fmt)
            torch.cuda.synchronize()
            k1, plain_calls = frame.launches, composite.calls
            ref = composite.composite_stack_torch(fmt, size, srcs, dev)
            err, above = max_err(got, ref)
            shapes = [tuple(p.shape) for p in got]
            cw = size[0] // 2 if fmt == PixelFormat.y422p else size[0]
            if (err > LSB or above or (k1, plain_calls) != (1, 0)
                    or shapes != [(size[1], size[0])] + [(size[1], cw)] * 2):
                fail(f"K1+K2 {fmt.value} {size}: err {err} ({above} px), "
                     f"{k1} K1 launches, {plain_calls} plain, planes {shapes}")
            errs[fmt] = max(errs.get(fmt, 0), err)
            parts.append(f"{fmt.value} {size[0]}x{size[1]} err {err} above0 "
                         f"{above}")
    print(f"[24 K1+K2 onto 4:2:2 / 4:4:4 targets, tol {LSB} LSB] "
          + "; ".join(parts), flush=True)

    launches, parts = {}, []
    for name, ticks in YUV_TARGET_TICKS:
        fmt = PixelFormat(name)
        frames, _audio, n, plain_calls, steps, wall, err, above = \
            drive_composer(fmt, ticks)
        cw = W // 2 if fmt == PixelFormat.y422p else W
        if [tuple(p.shape) for p in frames[-1].planes()] != [(H, W)] + [
                (H, cw)] * 2:
            fail(f"{name} Composer frame planes "
                 f"{[tuple(p.shape) for p in frames[-1].planes()]}")
        launches[fmt] = n
        parts.append(f"{name}: {len(frames)} ticks in {wall:.2f} s host wall "
                     f"({steps} clock steps), K1 launches {n}, plain "
                     f"composites {plain_calls}, last frame vs plain err {err} "
                     f"above0 {above}")
    print("[24 Composer onto 4:2:2 / 4:4:4 canvases] " + "; ".join(parts),
          flush=True)

    full = cam_srcs + ov_srcs
    rows, parts = [], []
    for fmt in (PixelFormat.y422p, PixelFormat.y444p):
        def call(fmt=fmt):
            return frame.composite_frame_cuda((W, H), full, fmt)

        t = {"call": timed_ms(call), "device": device_ms(call, frame.YUV_KERNEL),
             "host": host_us(call),
             "plain": timed_ms(lambda fmt=fmt: composite.composite_stack_torch(
                 fmt, (W, H), full, dev), batch=2)}
        bms, by = bound(frame_bytes((W, H), full, fmt), 0, 1.0)
        parts.append(f"{fmt.value}: call {t['call']:.4f} device "
                     f"{t['device']:.4f} host {t['host']:.1f} us plain "
                     f"{t['plain']:.4f} bound {bms:.6f} ({by}) share "
                     f"{bms / t['device']:.1%}")
        rows.append({"name": f"frame_composite (K1+K2 -> {fmt.value})",
                     "route": "cuda",
                     "source": "swiftvideo_tpu_torch/csrc/frame_composite.cu",
                     "replaces": REPLACES["K1"], "launches": launches[fmt],
                     "max_abs_err": errs[fmt], "ms": t["call"],
                     "device_ms": t["device"], "host_us": t["host"],
                     "plain_ms": t["plain"], "bound_ms": bms, "bound_by": by,
                     "library_ms": None})
    for fmt in (PixelFormat.yuvs, PixelFormat.zvuy):
        ms = timed_ms(lambda fmt=fmt: registry.composite_frame(
            ctx, fmt, (W, H), full))
        parts.append(f"{fmt.value} via the registry (unpack, K1 as y422p, "
                     f"pack): call {ms:.4f}")
    print("[24 timings, ms per 1080p tick of the live stack] "
          + "; ".join(parts) + f" | {smi}", flush=True)
    return rows


def codec_station(device, host_cams, ov_rgba, pcm):
    """The codec-fed station on ``device``: a SyntheticSource of uncompressed
    1080p y420p frames and one of uncompressed s16 44.1 kHz audio go through
    the transcoders (the video one as it is; the audio one as
    ``make_audio_transcoder`` builds it, with its SRC on the device route
    on ``device``, segmented to 1024 samples), are decoded onto the
    Composer's buses with an RGBA lower third, and the program is encoded
    again.  Returns (program frames' planes, program
    PCM, packets in, packets out, host s of the clock steps, ticks)."""
    from swiftvideo_tpu_torch.codec import (AudioDecoder, AudioEncoder,
                                            SyntheticSource, VideoDecoder,
                                            VideoEncoder, asset_rename, flat,
                                            make_video_transcoder)
    from swiftvideo_tpu_torch.compose import Composer
    from swiftvideo_tpu_torch.core import (Bus, EventBox, StepClock,
                                           TimePoint, Tx, asset_filter)
    from swiftvideo_tpu_torch.media import (AudioFormat, AudioSample,
                                            BufferType, ImageBuffer,
                                            MediaFormat, PictureSample,
                                            PixelFormat, planes_for_format)
    from swiftvideo_tpu_torch.mix import AudioSampleRateConversion
    from swiftvideo_tpu_torch.ops import make_compute_context
    from swiftvideo_tpu_torch.scene import (Composition, Element,
                                            ElementState, Scene)
    raw = MediaFormat.uncompressed
    clock = StepClock(TimePoint(480, 48000))
    comp = Composition(
        name="program", canvas_size=(W, H),
        frame_duration=TimePoint(1000, 30000),
        audio_frame_duration=TimePoint(480, 48000), sample_rate=48000,
        channel_count=2, scenes=(Scene(name="main", elements=(
            Element(name="cam", initial_state=ElementState(
                pic_pos=(0.0, 0.0), size=(float(W), float(H)))),
            Element(name="lower", z_index=9, initial_state=ElementState(
                pic_pos=(0.0, float(H - OV_H - 40)),
                size=(float(W), float(OV_H)))))),), initial_scene="main")
    audio_bus, picture_bus = Bus(clock), Bus(clock)
    composer = Composer(clock, workspace_id="w", composition=comp,
                        audio_bus=audio_bus, picture_bus=picture_bus,
                        compute_context=make_compute_context(device))
    venc_in = VideoEncoder(raw)
    aenc_in = AudioEncoder(raw, frame_size=441)

    def picture(i):
        planes = host_cams[i % len(host_cams)]
        img = ImageBuffer(PixelFormat.y420p, BufferType.cpu, (W, H),
                          tuple(planes_for_format(PixelFormat.y420p, (W, H))),
                          tuple(planes))
        return PictureSample(img, "cam_file", "w")

    def packet(i):
        return AudioSample(buffers=(pcm[i],), frequency=44100, channels=2,
                           format=AudioFormat.s16i, sample_count=441,
                           pts_value=TimePoint(441 * i, 44100),
                           id_asset="mic_file", id_workspace="w")

    counts = {"in": 0, "out": 0}

    def pull(encode, make, n):
        def puller(i):
            if i >= n:
                return None
            counts["in"] += 1
            box = encode(make(i))
            v = box.value()
            return v[0] if isinstance(v, list) else v
        return puller

    vsrc = SyntheticSource(clock, pull(venc_in, picture, STATION_FRAMES),
                           frame_duration=TimePoint(1000, 30000),
                           asset_id="cam_file")
    asrc = SyntheticSource(clock, pull(aenc_in, packet, STATION_AUDIO),
                           frame_duration=TimePoint(441, 44100),
                           asset_id="mic_file")
    audio_tc = (asset_rename("cam") >> AudioDecoder()
                >> flat(AudioSampleRateConversion(48000, 2, AudioFormat.s16i,
                                                  use_device=True,
                                                  device=device))
                >> flat(AudioEncoder(raw, 1024)))

    def onto(bus):
        return flat(Tx(lambda s: (bus.append(EventBox.just(s)),
                                  EventBox.nothing(None))[1]))

    out_v, out_a = [], []

    def collect(out):
        def put(s):
            counts["out"] += 1
            out.append(s)
            return EventBox.nothing(None)
        return flat(Tx(put))

    keep = [vsrc >> make_video_transcoder("cam", raw) >> flat(VideoDecoder())
            >> onto(picture_bus),
            asrc >> audio_tc >> flat(AudioDecoder()) >> onto(audio_bus),
            picture_bus.subscribe(asset_filter("program")
                                  >> flat(VideoEncoder(raw)) >> collect(out_v)),
            audio_bus.subscribe(asset_filter("program")
                                >> flat(AudioEncoder(raw, 1024))
                                >> collect(out_a))]
    composer.bind("cam", "cam")
    composer.bind("lower", "lower")
    ov = ImageBuffer(PixelFormat.RGBA, BufferType.cpu, (W, OV_H),
                     tuple(planes_for_format(PixelFormat.RGBA, (W, OV_H))),
                     (ov_rgba,))
    picture_bus.append(EventBox.just(PictureSample(ov, "lower", "w")))
    vsrc.play()
    asrc.play()
    t0 = time.perf_counter()
    for _ in range(STATION_FRAMES * 10 // 3 + 30):
        clock.step()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    vsrc.close()
    asrc.close()
    composer.close()
    del keep
    vdec, adec = VideoDecoder(), AudioDecoder()
    frames = [[np.asarray(p) for p in vdec(c).value().planes()]
              for c in out_v]
    audio = [np.asarray(adec(c).value().data()[0]) for c in out_a]
    return frames, audio, counts["in"], counts["out"], host_s, len(out_v)


def station_phase(dev, rng, smi):
    """Phase 19: the codec-fed station on the card against the same graph
    on the CPU."""
    from swiftvideo_tpu_torch.codec import (bitstream_backend,
                                            ffmpeg_available,
                                            libav_available)
    from swiftvideo_tpu_torch.ops import composite, frame
    print(f"[19 codec backends] libav_available() {libav_available()}, "
          f"ffmpeg_available() {ffmpeg_available()}, bitstream_backend() "
          f"{bitstream_backend()}", flush=True)
    host_cams = camera_planes(rng, 3)
    ov_rgba = overlay_plane(rng)
    t = np.arange(441 * STATION_AUDIO) / 44100.0
    tone = (np.sin(2 * np.pi * 440.0 * t) * 9000).astype(np.int16)
    pcm = [np.stack([tone, tone // 3], axis=1)[441 * i:441 * (i + 1)]
           .reshape(-1).copy() for i in range(STATION_AUDIO)]
    frame.launches = composite.calls = 0
    card = codec_station(dev, host_cams, ov_rgba, pcm)
    k1, plain_calls = frame.launches, composite.calls
    cpu = codec_station(torch.device("cpu"), host_cams, ov_rgba, pcm)
    frames, audio, n_in, n_out, host_s, ticks = card
    if ticks < STATION_FRAMES or k1 < ticks or plain_calls:
        fail(f"station: {ticks} program frames, {k1} K1+K2 launches, "
             f"{plain_calls} plain composites on the card")
    if len(frames) != len(cpu[0]) or len(audio) != len(cpu[1]):
        fail(f"station: {len(frames)} frames / {len(audio)} audio packets on "
             f"the card, {len(cpu[0])} / {len(cpu[1])} on the CPU")
    pix = sum(int((a != b).sum()) for fa, fb in zip(frames, cpu[0])
              for a, b in zip(fa, fb))
    d = [np.abs(a.astype(np.int32) - b.astype(np.int32))
         for a, b in zip(audio, cpu[1])]
    pcm_diff, pcm_max = sum(int((x > 0).sum()) for x in d), max(
        (int(x.max()) for x in d), default=0)
    # both runs take the SRC's device route, so the PCM is held exactly
    if pix or pcm_diff or not audio:
        fail(f"station: the card's program differs from the CPU run's in "
             f"{pix} pixels and {pcm_diff} samples (max {pcm_max})")
    mid = frames[-1][0]
    print(f"[19 codec-fed station] {ticks} program frames {W}x{H} y420p, "
          f"{len(audio)} audio packets of 1024; packets in {n_in} out {n_out};"
          f" K1+K2 launches {k1}; against the CPU run: 0 pixels and 0 of "
          f"{sum(x.size for x in d)} samples differ (exact); host "
          f"{host_s / ticks * 1e3:.2f} ms "
          f"per video tick (card),"
          f" {cpu[4] / max(cpu[5], 1) * 1e3:.2f} (CPU); luma mean "
          f"{float(mid.mean()):.2f} | {smi}", flush=True)


# --- phases 20-23: the CLI and the network layer ------------------------------
# phase 20: `mix` of a 1080p30 manifest (a full-canvas background and four
# 960x540 quadrants at transparency 0.1); phase 21: 64 RTMP publishers into
# the wall (config 5's host shape); phase 22: `serve --record` with 16
# publishers of 1080p30 AVC at ~6 Mbit/s (25 KB frames, a 150 KB keyframe
# every 60) and 1024-sample AAC at ~128 kbit/s; phase 23: four of those
# streams through a flavor push
MIX_FRAMES, MIX_EVERY = 30, 10
INGEST_PUBLISHERS, INGEST_SECONDS, INGEST_FPS = 16, 5, 30
INGEST_SIZE = (1920, 1080)
AU_BYTES, KEY_BYTES, GOP = 25_000, 150_000, 60
AAC_BYTES, AAC_SAMPLES, AAC_RATE = 341, 1024, 48000
FLAVOR_STREAMS = 4


def cli_env(cpu: bool) -> dict:
    """The environment of a ``python -m swiftvideo_tpu_torch`` child: the
    checkout on its path, the CPU routes only when asked for."""
    import os
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(
        __file__)))
    env.pop("SV_DEVICE", None)
    if cpu:
        env["SV_DEVICE"] = "cpu"
    return env


def read_png(path) -> np.ndarray:
    """The (h, w, 4) RGBA pixels of a PNG that ``cli.write_png`` wrote
    (colour type 6, 8 bits, filter 0 on every row)."""
    import struct
    import zlib
    data = open(path, "rb").read()
    pos, idat, w, h = 8, b"", 0, 0
    while pos < len(data):
        n, tag = struct.unpack_from(">I4s", data, pos)
        body = data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack_from(">IIBB", body)
            if (depth, ctype) != (8, 6):
                fail(f"{path}: PNG depth {depth}, colour type {ctype}")
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    rows = np.frombuffer(bytearray(zlib.decompress(idat)), np.uint8).reshape(
        h, 1 + 4 * w)
    if rows[:, 0].any():
        fail(f"{path}: a PNG row has a filter other than 0")
    return rows[:, 1:].reshape(h, w, 4)


def mix_manifest(path) -> None:
    from swiftvideo_tpu_torch.compose import composition_to_json
    from swiftvideo_tpu_torch.core import TimePoint
    from swiftvideo_tpu_torch.scene import (Composition, Element,
                                            ElementState, Scene)
    # pic_origin is top-left by default: pic_pos is each quadrant's corner
    quads = tuple(Element(name=f"cam{s}", z_index=s + 1,
                          initial_state=ElementState(
                              pic_pos=((s % 2) * W / 2, (s // 2) * H / 2),
                              size=(W / 2, H / 2), transparency=0.1))
                  for s in range(4))
    comp = Composition(
        name="mix", canvas_size=(W, H), frame_duration=TimePoint(1000, 30000),
        audio_frame_duration=TimePoint(480, 48000),
        scenes=(Scene(name="main", elements=(Element(
            name="background", initial_state=ElementState(
                size=(float(W), float(H)))),) + quads),),
        initial_scene="main")
    with open(path, "w", encoding="utf-8") as fh:
        fh.write(composition_to_json(comp))


def mix_phase(dev, smi, work):
    """Phase 20: ``mix`` at 1920x1080 through ``cli.main`` in this process,
    then as ``python -m swiftvideo_tpu_torch mix`` on the card and under
    ``SV_DEVICE=cpu``.  Returns the K1 and K3 rows of the kernels line."""
    import contextlib
    import io
    import os
    from swiftvideo_tpu_torch import cli
    from swiftvideo_tpu_torch.media import PixelFormat
    from swiftvideo_tpu_torch.mix import video_mixer
    from swiftvideo_tpu_torch.ops import composite, frame
    manifest = os.path.join(work, "mix.json")
    mix_manifest(manifest)
    argv = ["mix", manifest, "--frames", str(MIX_FRAMES), "--every",
            str(MIX_EVERY), "--out"]
    want_pngs = [f"frame_{i:05d}.png" for i in range(0, MIX_FRAMES, MIX_EVERY)]

    def pngs(d):
        return sorted(os.listdir(d)) if os.path.isdir(d) else []

    # the in-process run: its ticks and its PNG writes timed apart
    calls, png_s = [], [0.0]
    mixer_composite, write_png, rgba_frame = (video_mixer.composite_frame,
                                              cli.write_png, cli.rgba_frame)

    def spy(ctx_, fmt, size, sources, target=None):
        calls.append((ctx_, fmt, size, sources, target))
        return mixer_composite(ctx_, fmt, size, sources, target)

    def timed_png(path, rgba):
        t = time.perf_counter()
        write_png(path, rgba)
        png_s[0] += time.perf_counter() - t

    def timed_rgba(ctx_, sample):
        t = time.perf_counter()
        out = rgba_frame(ctx_, sample)
        png_s[0] += time.perf_counter() - t
        return out

    video_mixer.composite_frame = spy
    cli.write_png, cli.rgba_frame = timed_png, timed_rgba
    out_in = os.path.join(work, "mix_in")
    stdout = io.StringIO()
    torch.cuda.synchronize()
    for kern in frame.kernel_launches:
        frame.kernel_launches[kern] = 0
    frame.launches = composite.calls = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(stdout):
        rc = cli.main(argv + [out_in])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1 = frame.kernel_launches[frame.YUV_KERNEL]
    k3 = frame.kernel_launches[frame.RGBA_KERNEL]
    plain_calls = composite.calls
    video_mixer.composite_frame = mixer_composite
    cli.write_png, cli.rgba_frame = write_png, rgba_frame
    said = stdout.getvalue().strip()
    want_said = f"mixed {MIX_FRAMES} frames, wrote {len(want_pngs)} PNGs"
    if rc != 0 or want_said not in said or pngs(out_in) != want_pngs:
        fail(f"mix in-process: rc {rc}, said {said!r}, PNGs {pngs(out_in)}")
    if k1 != len(calls) or k1 != MIX_FRAMES or k3 != len(want_pngs) \
            or plain_calls:
        fail(f"mix in-process: {len(calls)} ticks composited, {k1} K1 "
             f"launches, {k3} K3 launches for {len(want_pngs)} PNGs, "
             f"{plain_calls} plain composites")
    # the same command in two children, on the card and under SV_DEVICE=cpu
    # (one after the other: two torch processes at once contend for cores)
    runs, child_s = {}, {}
    for name, cpu in (("card", False), ("cpu", True)):
        out = os.path.join(work, f"mix_{name}")
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "swiftvideo_tpu_torch", *argv, out],
            env=cli_env(cpu), capture_output=True, text=True, timeout=300)
        child_s[name] = time.perf_counter() - t
        runs[name] = (out, proc)
        if proc.returncode != 0 or pngs(out) != want_pngs \
                or want_said not in proc.stdout:
            fail(f"mix {name} child: rc {proc.returncode}, PNGs {pngs(out)}, "
                 f"stdout {proc.stdout.strip()!r}, stderr "
                 f"{proc.stderr.strip()[-2000:]!r}")
    same_bytes = all(open(os.path.join(out_in, p), "rb").read()
                     == open(os.path.join(runs["card"][0], p), "rb").read()
                     for p in want_pngs)
    png_err = max(max_err([torch.from_numpy(read_png(os.path.join(d, p)))
                           for d in (out_in,)],
                          [torch.from_numpy(read_png(os.path.join(
                              runs["cpu"][0], p)))])[0] for p in want_pngs)
    if not same_bytes or png_err > LSB:
        fail(f"mix: child PNGs byte-identical {same_bytes}; against "
             f"SV_DEVICE=cpu max abs err {png_err}")
    # the last tick's composite and the last PNG's conversion, against their
    # plain versions on the same inputs, then timed
    ctx, fmt, size, sources, target = calls[-1]
    got = mixer_composite(ctx, fmt, size, sources, target)
    ref = composite.composite_stack_torch(fmt, size, sources, dev,
                                          target=target)
    k1_err, k1_above = max_err(got, ref)
    from swiftvideo_tpu_torch.media import BufferType, create_picture_sample
    sample = create_picture_sample(size, fmt, asset_id="mix",
                                   workspace_id="cli")
    sample = sample.with_(img=sample.img.with_buffers(got, BufferType.gpu))
    rgba = torch.from_numpy(cli.rgba_frame(ctx, sample))
    from swiftvideo_tpu_torch.ops import identity_uniforms
    k3_srcs = [(got, fmt, identity_uniforms(size, size))]
    rgba_ref = composite.composite_stack_torch(PixelFormat.RGBA, size,
                                               k3_srcs, dev)
    k3_err, k3_above = max_err([rgba], [rgba_ref[0].cpu()])
    if k1_err > LSB or k1_above or k3_err > LSB or k3_above:
        fail(f"mix: last tick K1 vs plain err {k1_err} ({k1_above} px), its "
             f"RGBA K3 vs plain err {k3_err} ({k3_above} px)")

    def k1_call():
        return mixer_composite(ctx, fmt, size, sources, target)

    def k3_call():
        return frame.composite_frame_cuda(size, k3_srcs, PixelFormat.RGBA)

    rows = []
    for key, name, call, kern, srcs, ofmt, n, err in (
            ("K1", "mix tick, 1080p, 5 y420p sources", k1_call,
             frame.YUV_KERNEL, sources, fmt, k1, k1_err),
            ("K3", "mix PNG, 1080p y420p -> RGBA", k3_call,
             frame.RGBA_KERNEL, k3_srcs, PixelFormat.RGBA, k3, k3_err)):
        bms, by = bound(frame_bytes(size, srcs, ofmt), 0, 1.0)
        rows.append({"name": f"frame_composite ({key}: {name})",
                     "route": "cuda",
                     "source": "swiftvideo_tpu_torch/csrc/frame_composite.cu",
                     "replaces": REPLACES[key], "launches": n,
                     "max_abs_err": err, "ms": timed_ms(call),
                     "device_ms": device_ms(call, kern),
                     "plain_ms": timed_ms(
                         lambda s=srcs, f=ofmt: composite.composite_stack_torch(
                             f, size, s, dev), reps=5, batch=2),
                     "bound_ms": bms, "bound_by": by, "library_ms": None})
    print(f"[20 mix, the CLI] {MIX_FRAMES} frames of {W}x{H}, PNG every "
          f"{MIX_EVERY}: in-process {wall:.3f} s = {MIX_FRAMES / wall:.2f} "
          f"ticks/s for the whole command; host {(wall - png_s[0]) / MIX_FRAMES * 1e3:.2f} "
          f"ms per tick without the PNGs; {len(want_pngs)} PNGs {png_s[0]:.3f} s "
          f"(K3 + download + zlib, {png_s[0] / wall:.1%} of the command); K1 "
          f"launches {k1} for {len(calls)} ticks, K3 launches {k3} for "
          f"{len(want_pngs)} PNGs, 0 plain composites; `python -m "
          f"swiftvideo_tpu_torch mix` PNGs byte-identical to in-process; "
          f"against SV_DEVICE=cpu err {png_err} (children {child_s['card']:.1f}"
          f" s on the card, {child_s['cpu']:.1f} s on the CPU) | K1 device "
          f"{rows[0]['device_ms']:.4f} ms/launch (call {rows[0]['ms']:.4f}), "
          f"K3 device {rows[1]['device_ms']:.4f} ms/launch (call "
          f"{rows[1]['ms']:.4f}); last tick vs plain err {k1_err}, its RGBA "
          f"{k3_err} | {smi}", flush=True)
    return rows


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def wall_ingest_phase(dev, smi):
    """Phase 21: 64 RTMP publishers into the port's server; each session's
    latest sample seeds a 1920x1080 stream made on the card; one per-cell
    wall tick and one plan tick, each straight onto the canvas with the
    kept plan's launches (one of the row kernel for 64 streams), no tile
    assembled.
    Returns the kernels-line row of K1 on one RTMP-fed cell."""
    import asyncio
    from swiftvideo_tpu_torch.core import EventBox, StepClock, TimePoint, Tx
    from swiftvideo_tpu_torch.media.coded import (CodedMediaSample,
                                                  MediaFormat, MediaType)
    from swiftvideo_tpu_torch.net.rtmp import Rtmp, chunks
    from swiftvideo_tpu_torch.ops import composite, frame, matscale
    from swiftvideo_tpu_torch.media import PixelFormat
    from swiftvideo_tpu_torch.parallel import MixingWall
    n, port = WALL_STREAMS, free_port()

    async def ingest():
        clock = StepClock(TimePoint(16, 1000))
        latest, keep = {}, []

        async def on_connection(pub, sub):
            if sub is not None:
                keep.append(sub >> Tx(
                    lambda s, name=sub.play_path(): (
                        latest.__setitem__(name, s),
                        EventBox.nothing(None))[1]))
            return True

        server = Rtmp(clock, on_connection=on_connection)
        await server.serve("127.0.0.1", port)
        pubs = []
        for k in range(n):
            pub, _ = await Rtmp(clock).connect(
                f"rtmp://127.0.0.1:{port}/wall/cam{k}", publish_to_peer=True,
                max_attempts=3, retry_delay=0.2)
            pubs.append(pub)
        for _ in range(14):          # the publishers' 200 ms metadata grace
            clock.step()
            await asyncio.sleep(0)
        ts = TimePoint(0, 1000)
        for _ in range(3):
            for k, pub in enumerate(pubs):
                body = bytearray(200)
                body[4], body[5] = 0x65, 3 * k + 2
                pub.apply(EventBox.just(CodedMediaSample(
                    buffer=bytes(body), pts_value=ts, dts_value=ts,
                    media_type=MediaType.video, media_format=MediaFormat.avc,
                    id_asset=f"cam{k}", id_workspace="w",
                    side={"config": bytes(48)})))
            ts = ts + TimePoint(16, 1000)
            clock.step()
            await asyncio.sleep(0)
        deadline = asyncio.get_running_loop().time() + 30.0
        while len(latest) < n and asyncio.get_running_loop().time() < deadline:
            await asyncio.sleep(0.001)
        for pub in pubs:
            pub.close()
        await server.close()
        return latest

    t0 = time.perf_counter()
    latest = asyncio.run(ingest())
    accept_s = time.perf_counter() - t0
    if sorted(latest) != sorted(f"cam{k}" for k in range(n)):
        fail(f"wall ingest: {len(latest)} of {n} sessions arrived")
    seeds = [latest[f"cam{k}"].data()[5] for k in range(n)]
    if seeds != [3 * k + 2 for k in range(n)]:
        fail(f"wall ingest: seeds {seeds} do not trace back to the sessions")
    # each session's stream made on the card from its seed
    planes = []
    for seed in seeds:
        gen = torch.Generator(device=dev).manual_seed(seed)
        planes.append([torch.randint(0, 256, shape, dtype=torch.uint8,
                                     device=dev, generator=gen)
                       for shape in ((H, W), (H // 2, W // 2),
                                     (H // 2, W // 2))])
    ys, us, vs = (torch.stack([p[i] for p in planes]) for i in range(3))
    pcm = np.stack([np.random.default_rng(s).integers(
        -20000, 20000, 2 * WALL_SAMPLES, np.int64).astype(np.int16)
        for s in seeds])
    wall = MixingWall(n_streams=n, stream_size=(W, H), canvas_size=WALL_CANVAS,
                      audio_samples=WALL_SAMPLES, device=dev)
    tw, th = wall.tile
    audio_t = wall.shard(pcm)
    unis = wall.default_uniforms()
    gains = wall.default_gains().cpu().numpy().astype(np.float64)
    want_audio = np.clip(np.trunc((pcm.astype(np.float64)
                                   * gains[:, None]).sum(0)), -32768, 32767)

    def tick_cells():
        return wall.step(ys, us, vs, audio_t, uniforms=unis)

    def tick_plan():
        return wall.step(ys, us, vs, audio_t)

    # the C call's count: the tick's two FrameParams of 32 identity cells as
    # one launch of the row kernel
    tick_launches = 1
    torch.cuda.synchronize()
    for kern in frame.kernel_launches:
        frame.kernel_launches[kern] = 0
    frame.launches = composite.calls = matscale.calls = 0
    with counting_assembly() as assembly:
        cell_out = tick_cells()
        torch.cuda.synchronize()
        k1, cell_plain = (frame.kernel_launches[frame.YUV_KERNEL],
                          composite.calls)
        plan_out = tick_plan()
        torch.cuda.synchronize()
    if (k1 != tick_launches or frame.launches != 2 * tick_launches
            or cell_plain or composite.calls or matscale.calls or assembly):
        fail(f"RTMP-fed wall: {k1} K1 launches in the per-cell tick (want "
             f"{tick_launches}), {frame.launches} after the plan tick (want "
             f"{2 * tick_launches}), {composite.calls} plain composites, "
             f"{matscale.calls} product calls, tile-assembly calls "
             f"{dict(assembly)}")
    plan_k1 = frame.launches - k1
    gw = wall.grid_wh[0]

    def cell(out, s):
        r, c = divmod(s, gw)
        return [p[r * h:(r + 1) * h, c * w:(c + 1) * w] for p, (w, h) in zip(
            out, ((tw, th), (tw // 2, th // 2), (tw // 2, th // 2)))]

    cell_err = plan_vs_cell = 0
    for s in range(n):
        ref = composite.composite_stack_torch(
            PixelFormat.y420p, (tw, th), [(planes[s], PixelFormat.y420p,
                                           unis[s])], dev)
        cell_err = max(cell_err, max_err(cell(cell_out, s), ref)[0])
    plan_vs_cell = max_err(plan_out[:3], cell_out[:3])[0]
    audio_ok = all(np.array_equal(o[3].cpu().numpy(), want_audio)
                   for o in (cell_out, plan_out))
    if cell_err > LSB or plan_vs_cell > LSB or not audio_ok:
        fail(f"RTMP-fed wall: per-cell tiles vs their sessions' streams err "
             f"{cell_err}, plan vs per-cell {plan_vs_cell}, audio exact "
             f"{audio_ok}")
    cell_ms = timed_ms(tick_cells, reps=10, batch=3)
    cell_dev, cell_acts = device_total_ms(tick_cells, n=10)
    cell_srcs = [(planes[1], PixelFormat.y420p, unis[1])]
    grids = sample_grids(wall._plan, (H, W), dev)

    def cell_call():
        return frame.composite_frame_cuda((tw, th), cell_srcs)

    def cell_library():
        return grid_sample_y420p(planes[1], grids)

    def cell_plain():
        return composite.composite_stack_torch(PixelFormat.y420p, (tw, th),
                                               cell_srcs, dev)

    one_want = cell_plain()
    one_k1_err = max_err(cell_call(), one_want)[0]
    lib_err = max_err(cell_library(), cell(cell_out, 1))[0]
    if one_k1_err > LSB or lib_err > 1:
        fail(f"RTMP-fed wall: one cell alone, the one-cell launch err "
             f"{one_k1_err} vs plain, grid_sample err {lib_err} vs the "
             f"per-cell tile")
    cell_taps = tap_bytes([wall._plan], (H, W))
    bms, by = bound(cell_taps + y420p_bytes(tw, th), 0, 1.0)
    row = {"name": f"frame_composite (K1: one RTMP-fed wall cell alone, "
                   f"{W}x{H} -> {tw}x{th}, a one-cell launch timed for "
                   f"comparison; launches: the per-cell tick's)",
           "route": "cuda", "source": "swiftvideo_tpu_torch/csrc/frame_composite.cu",
           "replaces": REPLACES["K1"], "launches": k1,
           "max_abs_err": one_k1_err,
           "ms": timed_ms(cell_call),
           "device_ms": device_ms(cell_call, "frame_composite_kernel"),
           "plain_ms": timed_ms(cell_plain, reps=5, batch=2),
           "bound_ms": bms, "bound_by": by,
           "library_ms": timed_ms(cell_library)}
    print(f"[21 RTMP ingest -> wall, config 5's host shape] {n} publishers "
          f"into one port Rtmp server (dechunker native "
          f"{chunks.native_available()}): sessions and their 3 samples each "
          f"accepted in {accept_s:.3f} s; {n} streams {W}x{H} made on the card "
          f"from the sessions' seeds; per-cell tick: {k1} K1 launches (cell "
          f"grid, straight onto the canvas), no product, plain or tile-"
          f"assembly call, every tile err {cell_err} vs the "
          f"plain composite of its session's stream; plan tick "
          f"{plan_k1} K1 launches, within {plan_vs_cell} LSB of "
          f"it; audio fold "
          f"exact | per-cell tick call {cell_ms:.4f} ms, device {cell_dev:.4f} "
          f"ms ({cell_acts:.0f} device activities); one cell alone (a "
          f"one-cell launch, comparison only): err {one_k1_err} vs plain, "
          f"device {row['device_ms']:.4f} ms | {smi}", flush=True)
    return row


def h264_sps_1080p() -> bytes:
    """A Baseline H.264 SPS for 1920x1080 (120x68 macroblocks, 8 rows
    cropped at the bottom), bit-packed as the standard lays it out."""
    bits = []

    def u(v, n):
        bits.extend((v >> (n - 1 - i)) & 1 for i in range(n))

    def ue(v):
        v += 1
        n = v.bit_length()
        u(0, n - 1)
        u(v, n)

    u(66, 8), u(0xC0, 8), u(40, 8)       # profile, constraints, level 4.0
    ue(0), ue(0), ue(2), ue(1), u(0, 1)  # sps id, frame_num, poc type 2, refs
    ue(119), ue(67), u(1, 1), u(1, 1)    # 120x68 mbs, frame_mbs_only, 8x8
    u(1, 1), ue(0), ue(0), ue(0), ue(4)  # cropping: bottom 4 x 2 rows
    u(0, 1), u(1, 1)                     # no VUI, stop bit
    bits.extend([0] * (-len(bits) % 8))
    body = bytes(int("".join(map(str, bits[i:i + 8])), 2)
                 for i in range(0, len(bits), 8))
    return b"\x67" + body


def ingest_streams(n_pub: int):
    """n_pub publishers' samples (the port's CodedMediaSample), each stream
    from its own seed: 1080p30 AVC in AVCC framing and AAC-LC 48 kHz
    stereo, interleaved in pts order.  The pts are exact in flavor's track
    time bases (1/600600 s for video, 1/96000 s for audio)."""
    from swiftvideo_tpu_torch.codec import bitstream
    from swiftvideo_tpu_torch.core import TimePoint
    from swiftvideo_tpu_torch.media.coded import (CodedMediaSample,
                                                  MediaFormat, MediaType)
    sps, pps = h264_sps_1080p(), b"\x68\xce\x3c\x80"
    if bitstream.h264_sps_frame_size(sps) != INGEST_SIZE:
        fail(f"the 1080p SPS parses as {bitstream.h264_sps_frame_size(sps)}")
    avcc = bytes([1, 66, 0xC0, 40, 0xFF, 0xE1]) + len(sps).to_bytes(2, "big") \
        + sps + b"\x01" + len(pps).to_bytes(2, "big") + pps
    asc = b"\x11\x90"                    # AAC-LC, 48 kHz, 2 channels
    n_video = INGEST_SECONDS * INGEST_FPS
    n_audio = INGEST_SECONDS * AAC_RATE // AAC_SAMPLES
    streams = []
    for k in range(n_pub):
        rng = np.random.default_rng(22_000 + k)
        out = []
        for i in range(n_video):
            key = i % GOP == 0
            body = (b"\x65" if key else b"\x41") + rng.bytes(
                (KEY_BYTES if key else AU_BYTES) - 5)
            ts = TimePoint(i, INGEST_FPS)
            out.append((i / INGEST_FPS, CodedMediaSample(
                buffer=len(body).to_bytes(4, "big") + body, pts_value=ts,
                dts_value=ts, media_type=MediaType.video,
                media_format=MediaFormat.avc, id_asset=f"cam{k}",
                id_workspace="live", side={"config": avcc})))
        for j in range(n_audio):
            ts = TimePoint(j * AAC_SAMPLES, AAC_RATE)
            out.append((j * AAC_SAMPLES / AAC_RATE, CodedMediaSample(
                buffer=rng.bytes(AAC_BYTES), pts_value=ts, dts_value=ts,
                media_type=MediaType.audio, media_format=MediaFormat.aac,
                id_asset=f"cam{k}", id_workspace="live",
                side={"config": asc})))
        out.sort(key=lambda t: (t[0], t[1].media_type.value))
        streams.append([s for _, s in out])
    return streams


async def push_all(pubs, streams):
    """Push every stream through its publisher as fast as the loop takes
    them; a publisher whose socket is full is waited for, so that nothing
    is dropped.  Returns the samples each publisher did not write."""
    import asyncio
    from swiftvideo_tpu_torch.core import EventBox
    dropped = [0] * len(pubs)
    for i in range(max(len(s) for s in streams)):
        for k, (pub, stream) in enumerate(zip(pubs, streams)):
            if i < len(stream):
                while not pub.conn.writable:
                    await asyncio.sleep(0.001)
                if not pub.apply(EventBox.just(stream[i])).is_just():
                    dropped[k] += 1
        if i % 8 == 7:
            await asyncio.sleep(0)
    return dropped


def serve_run(streams, work, workers):
    """One ``python -m swiftvideo_tpu_torch serve --record`` child with
    ``workers`` processes, every stream pushed into it over RTMP; stopped
    (SIGINT to its process group) once every session has ended.  Returns
    (record dir, stdout, wall s until every session ended, s until the
    publishers had handed over their last sample, pids announced,
    drops)."""
    import asyncio
    import os
    import re
    import signal
    import threading
    from swiftvideo_tpu_torch.core import WallClock
    from swiftvideo_tpu_torch.net.rtmp import Rtmp
    port, rec = free_port(), os.path.join(work, f"rec_{workers}")
    proc = subprocess.Popen(
        [sys.executable, "-m", "swiftvideo_tpu_torch", "serve", "--host",
         "127.0.0.1", "--port", str(port), "--record", rec, "--max-seconds",
         "120", "--workers", str(workers)],
        env=cli_env(False), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        start_new_session=True)
    out, lock = [], threading.Lock()

    def reader():
        for line in iter(proc.stdout.readline, b""):
            with lock:
                out.append(line.decode())

    thread = threading.Thread(target=reader, daemon=True)
    thread.start()

    def text():
        with lock:
            return "".join(out)

    try:
        deadline = time.time() + 60
        while len(set(re.findall(r"pid (\d+)", text()))) < workers:
            if proc.poll() is not None or time.time() > deadline:
                fail(f"serve --workers {workers}: announced "
                     f"{text()!r}, stderr {proc.stderr.read().decode()[-2000:]!r}")
            time.sleep(0.05)

        async def publish():
            clock = WallClock()
            pubs = []
            for k in range(len(streams)):
                pub, _ = await Rtmp(clock).connect(
                    f"rtmp://127.0.0.1:{port}/live/cam{k}",
                    publish_to_peer=True, max_attempts=3, retry_delay=0.2)
                pubs.append(pub)
            await asyncio.sleep(0.3)     # the 200 ms metadata grace timer
            t = time.perf_counter()
            dropped = await push_all(pubs, streams)
            pushed = time.perf_counter() - t
            for pub in pubs:
                pub.close()
            await asyncio.sleep(0)
            return t, pushed, dropped

        t0, pushed_s, dropped = asyncio.run(publish())
        while text().count("ended:") < len(streams):
            if proc.poll() is not None or time.time() > deadline + 120:
                fail(f"serve --workers {workers}: {text().count('ended:')} "
                     f"of {len(streams)} sessions ended")
            time.sleep(0.005)
        push_s = time.perf_counter() - t0
        os.killpg(proc.pid, signal.SIGINT)
        proc.wait(timeout=60)
        thread.join(timeout=10)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    return (rec, text(), push_s, pushed_s,
            set(re.findall(r"pid (\d+)", text())), dropped)


def serve_phase(smi, work):
    """Phase 22: ``serve --record`` with 16 publishers of 5 s of 1080p30,
    one worker and then two; every recorded file byte for byte the Annex-B
    / ADTS form of what its publisher sent.  Returns the streams."""
    import os
    import re
    from swiftvideo_tpu_torch.codec import bitstream
    from swiftvideo_tpu_torch.codec.ffmpeg_subprocess import (
        adts_header, avcc_to_annexb, sps_pps_from_avcdcr)
    from swiftvideo_tpu_torch.media.coded import MediaType
    from swiftvideo_tpu_torch.net.rtmp import chunks
    t0 = time.perf_counter()
    streams = ingest_streams(INGEST_PUBLISHERS)
    make_s = time.perf_counter() - t0
    want = {}
    for k, stream in enumerate(streams):
        video = [s for s in stream if s.media_type == MediaType.video]
        audio = [s for s in stream if s.media_type == MediaType.audio]
        sps, pps = sps_pps_from_avcdcr(video[0].side_data()["config"])
        channels, rate, _ = bitstream.aac_parse_asc(
            audio[0].side_data()["config"])
        want[f"live_cam{k}.h264"] = b"".join(
            b"\x00\x00\x00\x01" + p for p in sps + pps) + b"".join(
            avcc_to_annexb(s.data()) for s in video)
        want[f"live_cam{k}.adts"] = b"".join(
            adts_header(rate, channels, len(s.data())) + s.data()
            for s in audio)
        want[f"live/cam{k}"] = (len(video), len(audio),
                                sum(len(s.data()) for s in stream))
    total = sum(v[2] for k, v in want.items() if "/" in k)
    media_s = INGEST_PUBLISHERS * INGEST_SECONDS
    parts = []
    for workers in (1, 2):
        rec, said, push_s, pushed_s, pids, dropped = serve_run(streams, work,
                                                               workers)
        if any(dropped):
            fail(f"serve --workers {workers}: publishers dropped {dropped}")
        files = sorted(os.listdir(rec))
        bad = [f for f in files if "." in f and
               open(os.path.join(rec, f), "rb").read() != want.get(f)]
        if files != sorted(f for f in want if "." in f) or bad:
            fail(f"serve --workers {workers}: recorded {files}, differing "
                 f"{bad}")
        counts = {m[0]: tuple(int(x) for x in m[1:]) for m in re.findall(
            r"^(live/cam\d+): (\d+) video / (\d+) audio samples, (\d+) bytes",
            said, re.M)}
        # two workers share one stdout pipe, through which their buffered
        # count lines may interleave: those are checked for one worker only
        if len(pids) != workers or (workers == 1 and counts != {
                k: v for k, v in want.items() if "/" in k}):
            fail(f"serve --workers {workers}: pids {pids}, counts printed "
                 f"{counts}")
        parts.append(f"--workers {workers}: {len(pids)} worker(s) announced, "
                     f"{len(files)} files byte-exact"
                     + (", per-path counts match; " if workers == 1 else "; ") +
                     f"{total / 1e6:.1f} MB in {push_s:.3f} s = "
                     f"{total / 1e6 / push_s:.1f} MB/s, "
                     f"{sum(len(s) for s in streams) / push_s:.0f} samples/s, "
                     f"real-time factor {media_s / push_s:.2f} (the "
                     f"publishers' loop handed over its last sample at "
                     f"{pushed_s:.3f} s)")
    print(f"[22 serve --record] {INGEST_PUBLISHERS} publishers x "
          f"{INGEST_SECONDS} s of {INGEST_SIZE[0]}x{INGEST_SIZE[1]}@"
          f"{INGEST_FPS} AVC ({AU_BYTES} B "
          f"frames, {KEY_BYTES} B keyframe every {GOP}) + AAC "
          f"{AAC_SAMPLES}-sample packets of {AAC_BYTES} B (made in "
          f"{make_s:.2f} s); dechunker native {chunks.native_available()} | "
          + " | ".join(parts) + f" | {smi}", flush=True)
    return streams


def flavor_phase(smi, streams):
    """Phase 23: four of phase 22's streams through a flavor push over
    loopback, back byte-identical with their pts, dts and track info."""
    import asyncio
    from swiftvideo_tpu_torch.core import EventBox, Tx
    from swiftvideo_tpu_torch.net import flavor
    streams = streams[:FLAVOR_STREAMS]
    port = free_port()

    async def relay():
        received, keep = {}, []

        def on_subscriber(sub):
            keep.append(sub)
            keep.append(sub >> Tx(lambda s: (received.setdefault(
                s.workspace_token(), []).append(s), EventBox.nothing(None))[1]))

        server = flavor.Flavor(on_subscriber=on_subscriber)
        await server.serve("127.0.0.1", port)
        pubs = [await flavor.Flavor().connect(
            f"flavor://127.0.0.1:{port}/live/cam{k}", push=True)
            for k in range(len(streams))]
        t = time.perf_counter()
        dropped = await push_all(pubs, streams)
        want = sum(len(s) for s in streams)
        deadline = asyncio.get_running_loop().time() + 60
        while (sum(len(v) for v in received.values()) < want
               and asyncio.get_running_loop().time() < deadline):
            await asyncio.sleep(0.001)
        relay_s = time.perf_counter() - t
        for pub in pubs:
            pub.close()
        await server.close()
        return received, relay_s, dropped

    received, relay_s, dropped = asyncio.run(relay())
    bad = []
    for k, stream in enumerate(streams):
        got = received.get(f"live/cam{k}", [])
        if len(got) != len(stream):
            bad.append(f"cam{k}: {len(got)} of {len(stream)}")
            continue
        for s, r in zip(stream, got):
            if (r.data() != s.data() or r.pts() != s.pts()
                    or r.dts() != s.dts() or r.media_format != s.media_format
                    or r.media_type != s.media_type
                    or r.side_data().get("config")
                    != s.side_data().get("config")):
                bad.append(f"cam{k}: sample at {s.pts()} differs")
                break
    if any(dropped) or bad:
        fail(f"flavor relay: dropped {dropped}, {bad}")
    total = sum(len(s.data()) for st in streams for s in st)
    print(f"[23 flavor relay] {len(streams)} of phase 22's streams pushed "
          f"over loopback: {sum(len(s) for s in streams)} samples byte-"
          f"identical with their pts, dts, format and config; "
          f"{total / 1e6:.1f} MB in {relay_s:.3f} s = "
          f"{total / 1e6 / relay_s:.1f} MB/s | {smi}", flush=True)


def network_phases(dev, smi):
    """Phases 20-23 in one scratch directory, removed afterwards."""
    import tempfile
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        rows = mix_phase(dev, smi, work)
        rows.append(wall_ingest_phase(dev, smi))
        t0 = time.perf_counter()
        streams = serve_phase(smi, work)
        t1 = time.perf_counter()
        flavor_phase(smi, streams)
        print(f"[22-23 time] serve {t1 - t0:.1f} s, flavor "
              f"{time.perf_counter() - t1:.1f} s", flush=True)
    return rows


# --- phases 4, 8, 24 and 25: the live station through the Composer ---------

class LiveStation:
    """The live scene through the port's Composer on a StepClock of 10 ms:
    a 1920x1080 ``out_fmt`` canvas at 30 fps, four 1080p y420p cameras
    (``host_sets``: two sets of numpy planes, alternating) scaled 2:1 into
    the quadrants at opacity 0.9 with new frames every third step (every
    video tick), the RGBA lower third ``ov_host`` (``start``), and 48 kHz
    stereo s16 audio in 10 ms frames from four assets (``tone``).  The
    mixer's composite call is recorded in ``last_call``; ``mixed`` counts
    the mixed frames, and ``frames`` and ``mixed_audio`` hold every one, or
    with ``keep=False`` the last, as a station that sends its frames on
    and drops them holds no more on the card.  With ``record=True``
    ``audio_log`` holds (clock step, sample) for every sample the audio
    mixer digests and ``audio_out`` every mixed audio frame, for
    ``audio_replay``."""

    def __init__(self, out_fmt, host_sets, ov_host, tone, keep=True,
                 record=False):
        from swiftvideo_tpu_torch import core, media
        from swiftvideo_tpu_torch.compose import Composer
        from swiftvideo_tpu_torch.core import (Bus, EventBox, StepClock,
                                               TimePoint, Tx)
        from swiftvideo_tpu_torch.mix import video_mixer
        from swiftvideo_tpu_torch.scene import (Composition, Element,
                                                ElementState, Scene)
        # the port's modules, imported once: feed() runs in the timed steps
        self.core, self.media = core, media
        self.host_sets, self.ov_host, self.tone = host_sets, ov_host, tone
        self.audio_frame = TimePoint(480, 48000)
        self.clock = StepClock(self.audio_frame)
        self.audio_bus, self.picture_bus = Bus(self.clock), Bus(self.clock)
        elements = tuple(
            Element(name=f"cam{s}", z_index=s, initial_state=ElementState(
                pic_pos=((s % 2) * W / 2, (s // 2) * H / 2),
                size=(W / 2, H / 2), transparency=0.1))
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
        self.composer = Composer(self.clock, workspace_id="w",
                                 composition=comp, audio_bus=self.audio_bus,
                                 picture_bus=self.picture_bus,
                                 output_format=out_fmt)
        if self.composer.ctx.device.type != "cuda":
            fail(f"the Composer's default device is {self.composer.ctx.device}")
        self.frames, self.mixed_audio, self.mixed = [], [], 0

        def hold(out, sample):
            if not keep:
                out.clear()
            out.append(sample)

        def on_frame(s):
            if s.asset_id() != "live":
                return EventBox.nothing(None)
            self.mixed += 1
            hold(self.frames, s)
            return EventBox.just(s)

        self.audio_log, self.audio_out, self._stepping = [], [], False

        def on_audio(s):
            if s.asset_id() != "live":
                return EventBox.nothing(None)
            hold(self.mixed_audio, s)
            if record:
                self.audio_out.append(s)
            return EventBox.just(s)

        if record:
            mixer = self.composer.audio_mixer
            digest = mixer._fn

            def recording(sample):
                if self._stepping:
                    fail("the audio mixer digested a sample inside a clock "
                         "step: the replay feeds samples between steps")
                self.audio_log.append((self.steps, sample))
                return digest(sample)

            mixer.set(recording)

        # the buses hold their subscribers weakly
        self._keep = [self.picture_bus.subscribe(Tx(on_frame)),
                      self.audio_bus.subscribe(Tx(on_audio))]
        for s in range(4):
            self.composer.bind(f"cam{s}", f"cam{s}")
        self.composer.bind("lt", "lower_third")
        self.last_call = {}
        self._mixer = video_mixer
        self._composite = video_mixer.composite_frame

        def spy(ctx_, fmt, size, sources, target=None):
            self.last_call.update(out_fmt=fmt, size=size, sources=sources)
            return self._composite(ctx_, fmt, size, sources, target)

        video_mixer.composite_frame = spy
        self.audio_pts = TimePoint(0, 48000)
        self.steps = 0

    def picture(self, asset, fmt, planes):
        m = self.media
        h, w = planes[0].shape[:2]
        img = m.ImageBuffer(pixel_format=fmt, buffer_type=m.BufferType.cpu,
                            size=(w, h), planes=tuple(m.planes_for_format(
                                fmt, (w, h))), buffers=tuple(planes))
        return m.PictureSample(img, asset, "w",
                               time_point=self.clock.current(),
                               pts_value=self.clock.current())

    def start(self):
        """Publish the lower third (once: its Repeater holds it)."""
        self.picture_bus.append(self.core.EventBox.just(self.picture(
            "lt", self.media.PixelFormat.RGBA, [self.ov_host])))

    def feed(self):
        """Publish this step's inputs: the four cameras' next frames every
        third step, and a 10 ms frame from each audio asset."""
        if self.steps % 3 == 0:
            self.feed_pictures()
        self.feed_audio()

    def feed_pictures(self):
        c, m = self.core, self.media
        for s, planes in enumerate(self.host_sets[(self.steps // 3) % 2]):
            self.picture_bus.append(c.EventBox.just(
                self.picture(f"cam{s}", m.PixelFormat.y420p, planes)))

    def audio(self, asset, k):
        """A 10 ms frame of tone ``k`` from ``asset`` at the next pts."""
        m = self.media
        return m.AudioSample(
            buffers=(np.repeat(self.tone[k], 2),), frequency=48000,
            channels=2, format=m.AudioFormat.s16i, sample_count=480,
            pts_value=self.audio_pts, id_asset=asset, id_workspace="w")

    def feed_audio(self):
        c = self.core
        for k in range(4):
            self.audio_bus.append(c.EventBox.just(self.audio(f"cam{k}", k)))
        self.audio_pts = self.audio_pts + c.TimePoint(480, 48000)

    def step(self) -> bool:
        """One clock step; True when it mixed a video frame."""
        n = self.mixed
        self._stepping = True
        self.clock.step()
        self._stepping = False
        self.steps += 1
        return self.mixed > n

    def close(self):
        self._mixer.composite_frame = self._composite
        self.composer.close()
        self._keep = None


def audio_replay(station) -> int:
    """Fail unless every mixed audio frame of a ``record=True`` station
    equals a plain replay's: the samples its mixer digested, each fed in
    its clock step, through a fresh AudioMixer of the same settings on its
    own StepClock (no cache of the station's mixer carries over), compared
    sample for sample with their pts and constituents.  Returns the number
    of frames compared."""
    from swiftvideo_tpu_torch.core import EventBox, StepClock, Tx
    from swiftvideo_tpu_torch.mix import AudioMixer
    src = station.composer.audio_mixer
    clock = StepClock(station.audio_frame)
    mixer = AudioMixer(clock, workspace_id=src.id_workspace,
                       frame_duration=src.frame_duration,
                       sample_rate=src.sample_rate,
                       channel_count=src.channel_count, delay=src.delay,
                       output_format=src.output_format, asset_id=src.id_asset,
                       compute_context=src.compute_context)
    out = []

    def take(sample):
        out.append(sample)
        return EventBox.nothing(None)

    keep = mixer >> Tx(take)
    log = iter(station.audio_log)
    pending = next(log, None)
    for step in range(station.steps):
        while pending is not None and pending[0] == step:
            mixer(pending[1])
            pending = next(log, None)
        clock.step()
    mixer.close()
    del keep

    def frame(a):
        return ([np.asarray(b) for b in a.data()],
                (a.pts().value, a.pts().scale),
                [(c.id_asset, c.pts.value, c.pts.scale, c.duration.value,
                  c.duration.scale, c.normalized_pts.value,
                  c.normalized_pts.scale) for c in a.constituents()])

    got = station.audio_out
    if len(out) != len(got) or not got:
        fail(f"audio replay: {len(out)} mixed frames, the station "
             f"{len(got)}")
    for k, (a, b) in enumerate(zip(got, out)):
        (da, pa, ca), (db, pb, cb) = frame(a), frame(b)
        if pa != pb or ca != cb or len(da) != len(db) or not all(
                np.array_equal(x, y) for x, y in zip(da, db)):
            fail(f"audio replay: mixed frame {k} of {len(got)} differs "
                 f"(pts {pa} / {pb}, constituents {ca} / {cb})")
    return len(got)


def check_station(station, out_fmt, launches, plain_calls, dev):
    """Fail unless every video tick was one frame-kernel launch, no tick took
    the plain composite, every frame holds CUDA tensors, and the last tick's
    five sources give the last frame within LSB of the plain version.
    Returns (max abs error, pixels above 0) of that frame."""
    from swiftvideo_tpu_torch.media import BufferType
    from swiftvideo_tpu_torch.ops import composite
    frames, last_call = station.frames, station.last_call
    if launches != station.mixed:
        fail(f"{out_fmt.value}: frame kernel launches {launches} != video "
             f"ticks {station.mixed}")
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
    err, above = max_err(frames[-1].planes(), ref)
    if err > LSB:
        fail(f"{out_fmt.value}: last mixed frame vs plain max abs err {err}")
    return err, above


# phase 25: the stages whose host time the live tick's profile reports, as
# (label, module of the port, attribute path); a tree that lacks one prints
# it as absent
TICK_STAGES = (
    ("clock.step", "core.clock", "StepClock.step"),
    ("Bus.append", "core.bus", "Bus.append"),
    ("GPUBarrierUpload._impl", "ops.barriers", "GPUBarrierUpload._impl"),
    ("upload", "ops.barriers", "upload"),
    ("Repeater._tick", "mix.repeater", "Repeater._tick"),
    ("PictureAnimator._impl", "mix.animator", "PictureAnimator._impl"),
    ("VideoMixer._mix", "mix.video_mixer", "VideoMixer._mix"),
    ("registry.composite_frame", "ops.registry", "composite_frame"),
    ("frame.composite_frame_cuda", "ops.frame", "composite_frame_cuda"),
    ("frame._check", "ops.frame", "_check"),
    ("frame.descriptors", "ops.frame", "descriptors"),
    ("frame.pack_params", "ops.frame", "pack_params"),
    ("nvcc.launch", "ops.nvcc", "launch"),
    ("AudioSampleRateConversion._impl", "mix.src_audio",
     "AudioSampleRateConversion._impl"),
    ("SoundAnimator._impl", "mix.animator", "SoundAnimator._impl"),
    ("SoundAnimator.computed_matrix", "mix.animator",
     "SoundAnimator.computed_matrix"),
    ("AudioMixer._mix", "mix.audio_mixer", "AudioMixer._mix"),
    ("AudioMixer._run_mix", "mix.audio_mixer", "AudioMixer._run_mix"),
    ("audio_peak_rms", "ops.audio", "audio_peak_rms"),
    ("StatsReport.add_sample", "core.stats", "StatsReport.add_sample"),
    ("StatsReport._bucket_index", "core.stats", "StatsReport._bucket_index"))
TICK_WARM, TICK_WINDOW = 10, 60
FANOUT_APPENDS = 2000


def stage_keys():
    """{label: pstats key (file, first line, name)} of each TICK_STAGES
    function the imported port has."""
    import importlib
    keys = {}
    for label, mod, path in TICK_STAGES + (
            ("TimePoint.__post_init__", "core.time",
             "TimePoint.__post_init__"),):
        obj = importlib.import_module(f"swiftvideo_tpu_torch.{mod}")
        for part in path.split("."):
            obj = getattr(obj, part, None)
        code = getattr(obj, "__code__", None)
        if code is not None:
            keys[label] = (code.co_filename, code.co_firstlineno, code.co_name)
    return keys


def union_ms(spans):
    """Milliseconds covered by the union of (start us, end us) spans."""
    total, end = 0.0, -float("inf")
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


def tick_profile(dev, host_sets, ov_host, tone, warm=TICK_WARM,
                 window=TICK_WINDOW):
    """The live station's y420p tick on the card, three windows of
    ``window`` video ticks after ``warm``: the host clock around every step
    (no sync inside; the inputs' publishing timed apart), cProfile over the
    second, torch.profiler's CUDA activities over the third.  Fails as
    phase 4 does (launches != ticks, a plain composite, the last frame off
    the plain version).  Returns a dict of the results."""
    import cProfile
    import pstats
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from swiftvideo_tpu_torch.media import PixelFormat
    from swiftvideo_tpu_torch.ops import composite, frame
    station = LiveStation(PixelFormat.y420p, host_sets, ov_host, tone,
                          keep=False, record=True)

    def run(n_ticks):
        """(video-tick step ms, other step ms, feed ms) over n_ticks."""
        tick, other, feed = [], [], []
        got = 0
        while got < n_ticks:
            t0 = time.perf_counter()
            station.feed()
            t1 = time.perf_counter()
            mixed = station.step()
            t2 = time.perf_counter()
            feed.append((t1 - t0) * 1e3)
            (tick if mixed else other).append((t2 - t1) * 1e3)
            got += mixed
        return tick, other, feed

    frame.launches = composite.calls = 0
    station.start()
    run(warm)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tick, other, feed = run(window)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    prof = cProfile.Profile()
    prof.enable()
    run(window)
    prof.disable()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as tprof:
        t1 = time.perf_counter()
        run(window)
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t1) * 1e3
    launches, plain_calls, ticks = (frame.launches, composite.calls,
                                    station.mixed)
    # the Composer's fan-out: an audio frame every binding's filter turns
    # away, against an append to a bus with no observer
    stray = station.core.EventBox.just(station.audio("nobody", 0))
    idle_bus = station.core.Bus(station.clock)
    fanout = {}
    for name, bus in (("filtered", station.audio_bus), ("bare", idle_bus)):
        t1 = time.perf_counter()
        for _ in range(FANOUT_APPENDS):
            bus.append(stray)
        fanout[name] = (time.perf_counter() - t1) / FANOUT_APPENDS * 1e6
    station.close()
    err, above = check_station(station, PixelFormat.y420p, launches,
                               plain_calls, dev)
    replayed = audio_replay(station)
    spans = [(e.name, e.time_range.start, e.time_range.end)
             for e in tprof.events() if e.device_type == DeviceType.CUDA]
    busy = union_ms([(a, b) for _n, a, b in spans])
    h2d = sum(b - a for n, a, b in spans if "HtoD" in n) / 1e3
    kern = sum(b - a for n, a, b in spans if frame.YUV_KERNEL in n) / 1e3
    stats = pstats.Stats(prof).stats
    keys = stage_keys()
    tp_key = keys.pop("TimePoint.__post_init__", None)
    stages = {label: stats[key][3] / window * 1e6 if key in stats else 0.0
              for label, key in keys.items()}
    # the inputs' bus appends by the LiveStation method that made them
    callers = stats.get(keys.get("Bus.append"), (0, 0, 0, 0, {}))[4]
    for kind, method in (("audio", LiveStation.feed_audio),
                         ("picture", LiveStation.feed_pictures)):
        code = method.__code__
        got = callers.get((code.co_filename, code.co_firstlineno,
                           code.co_name))
        stages[f"Bus.append ({kind} inputs)"] = (
            got[3] / window * 1e6 if got else 0.0)
    audio_ticks = stats.get(keys.get("AudioMixer._mix"), (0, 0))[1]
    timepoints = stats.get(tp_key, (0, 0))[1]
    top = sorted(stats.items(), key=lambda kv: -kv[1][2])[:12]
    self_us = [(f"{os.path.basename(k[0])}:{k[1]}({k[2]})",
                v[2] / window * 1e6) for k, v in top]
    return {"window": window, "ticks": ticks, "launches": launches,
            "plain": plain_calls,
            "err": err, "above": above,
            "tick_p50_ms": float(np.percentile(tick, 50)),
            "tick_p99_ms": float(np.percentile(tick, 99)),
            "host_ms_per_tick": (sum(tick) + sum(other) + sum(feed)) / window,
            "feed_ms_per_tick": sum(feed) / window,
            "audio_step_ms_per_tick": sum(other) / window,
            "wall_ms_per_tick": wall / window,
            "busy_ms_per_tick": busy / window,
            "h2d_ms_per_tick": h2d / window,
            "kernel_ms_per_tick": kern / window,
            "idle_share": 1.0 - busy / prof_wall,
            "device_activities": len(spans),
            "audio_ticks": audio_ticks,
            "timepoints_per_audio_tick": (timepoints / audio_ticks
                                          if audio_ticks else 0.0),
            "audio_replayed": replayed,
            "fanout_us": fanout,
            "stage_us": stages, "self_us": self_us}


def tick_line(r, smi) -> str:
    """Phase 25's line from ``tick_profile``'s dict."""
    return (f"host ms per video tick: step p50 {r['tick_p50_ms']:.4f} p99 "
            f"{r['tick_p99_ms']:.4f}, all host work {r['host_ms_per_tick']:.4f}"
            f" (inputs' publishing {r['feed_ms_per_tick']:.4f}, audio-only "
            f"steps {r['audio_step_ms_per_tick']:.4f}), wall "
            f"{r['wall_ms_per_tick']:.4f} | device busy "
            f"{r['busy_ms_per_tick']:.4f} ms a tick, "
            f"{r['busy_ms_per_tick'] * r['window']:.2f} over the window (H2D "
            f"{r['h2d_ms_per_tick']:.4f}, frame kernel "
            f"{r['kernel_ms_per_tick']:.4f}; {r['device_activities']} "
            f"activities), idle share {r['idle_share']:.1%} | host us a tick "
            f"(cProfile, cumulative): " + ", ".join(
                f"{k} {v:.1f}" for k, v in r["stage_us"].items())
            + " | top self us a tick: " + ", ".join(
                f"{k} {v:.1f}" for k, v in r["self_us"])
            + f" | TimePoints built an audio tick "
            f"{r['timepoints_per_audio_tick']:.1f} (cProfile's count over "
            f"{r['audio_ticks']} audio ticks) | an audio frame no binding "
            f"takes: {r['fanout_us']['filtered']:.2f} us an append to the "
            f"station's audio bus, {r['fanout_us']['bare']:.2f} to a bus with "
            f"no observer | launches {r['launches']} for "
            f"{r['ticks']} ticks, plain composites {r['plain']}, last frame "
            f"vs plain err {r['err']} above0 {r['above']} | mixed audio "
            f"equal to a plain replay: {r['audio_replayed']} frames | {smi}")


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this run needs a CUDA card")
    from swiftvideo_tpu_torch.media import (BufferType, PixelFormat,
                                            create_picture_sample)
    from swiftvideo_tpu_torch.ops import (audio, composite, frame, motion, nvcc,
                                          registry)
    from swiftvideo_tpu_torch.ops.uniforms import ImageUniforms, rect_uniforms
    from swiftvideo_tpu_torch.utils import matrix as m4
    from swiftvideo_tpu_torch import compose, mix, scene  # noqa: F401 (guarded below)

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
    nvcc.build_all([frame.SOURCE, motion.SOURCE, audio.SOURCE])
    frame.build()
    motion.build()
    audio.build()
    # the frame and audio kernels' registers here, the motion kernels' below
    regs = [f"{name}: {ln.split(':', 1)[1].strip()}"
            for name, log in sorted(nvcc.build_logs.items())
            if name != motion.SOURCE.stem
            for ln in log.splitlines() if "registers" in ln]
    print(f"[2 build] frame_composite.cu, motion_search.cu and audio_mix.cu "
          f"built and loaded "
          f"in {time.perf_counter() - t0:.2f} s; {'; '.join(regs) or 'cached'}",
          flush=True)
    sass = kernel_sass(nvcc.library_path(motion.SOURCE))
    ptxas = ptxas_lines(nvcc.build_logs.get(motion.SOURCE.stem, ""))
    parts, sad_terms_per_op = [], 0
    instances = {"sad": "ILi2E", "ssd": "ILi4ELb0E", "dense coarse": "ILi4ELb1E",
                 "coarse": "ILi4E", "refine": f"ILi{REFINE}E"}
    names = dict(motion.KERNELS, coarse="motion_coarse_kernel",
                 refine="motion_refine_kernel")
    names["dense coarse"] = "motion_ssd_kernel"
    for metric, kname in names.items():
        # the instantiation the wrapper launches: kname<GROUP[metric]> (the
        # SSD kernel's exhaustive and stride-1 coarse modes, <4, false> and
        # <4, true>; the stride-2 coarse kernel <4>), the refine kernel's
        # for the main path's refine radius, <REFINE>
        inst = f"{kname}{instances[metric]}"
        found = [k for k in sass if inst in k]
        if len(found) != 1:
            fail(f"cuobjdump shows {len(found)} functions named {inst}")
        ops = sass[found[0]]
        tensor = {o: ops[o] for o in TENSOR_OPCODES if ops[o]}
        byte_sad = {o: ops[o] for o in BYTE_SAD_OPCODES if ops[o]}
        byte_dot = {o: ops[o] for o in BYTE_DOT_OPCODES if ops[o]}
        if metric in ("ssd", "coarse", "dense coarse") and not tensor:
            fail(f"{kname}'s SASS holds no tensor-core instruction")
        if metric == "refine" and not (byte_sad and byte_dot):
            fail(f"{kname} scores without byte-SIMD instructions: SAD "
                 f"{byte_sad or 'none'}, dot products {byte_dot or 'none'}")
        if metric == "sad" and byte_sad:
            sad_terms_per_op = 4  # one lane-instruction: 4 bytes' |c - r|, accumulated
        parts.append(f"{kname} ({metric}): "
                     f"{ptxas.get(found[0], 'ptxas line not in the log')}; "
                     f"SASS {sum(ops.values())} instructions, tensor-core "
                     f"{tensor or 'none'}, byte-SIMD SAD {byte_sad or 'none'}, "
                     f"dot {byte_dot or 'none'}, LDS {ops['LDS']}, top "
                     f"{ops.most_common(6)}")
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
        clock steps, host wall s, the last frame's max abs error against
        the plain version and its pixels above 0)."""
        station = LiveStation(out_fmt, host_sets, ov_host, tone)
        frames, mixed_audio = station.frames, station.mixed_audio
        frame.launches = 0
        motion.launches = 0
        composite.calls = 0
        t0 = time.perf_counter()
        station.start()
        while len(frames) < n_ticks:
            station.feed()
            station.step()
            if station.steps > 10 * n_ticks:
                fail(f"only {len(frames)} frames after {station.steps} clock "
                     "steps")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, plain_calls = frame.launches, composite.calls
        station.close()
        err, above = check_station(station, out_fmt, launches, plain_calls,
                                   dev)
        return (frames, mixed_audio, launches, plain_calls, station.steps,
                wall, err, above)

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
    # search 48 through the entry point: the u8 emit's float32 table (the JAX
    # device routes') differs from the oracles' float64 one at |m| = 16; a
    # current frame moved 16 columns right puts the winners at m = 16
    moved = torch.roll(base_ref, 16, dims=1).contiguous()
    table48 = motion.tables(BLOCK, 48)[3]
    for key, metric in (("K4", "sad"), ("K5", "ssd")):
        for name, (cur, ref) in (("1080p", me_frames["1080p"]),
                                 ("1080p moved 16", (moved, base_ref))):
            motion.launches = 0
            motion.route_launches.update(dict.fromkeys(motion.route_launches,
                                                       0))
            got = motion.me_fullsearch(cur, ref, BLOCK, 48, metric)
            torch.cuda.synchronize()
            routes = {k: n for k, n in motion.route_launches.items() if n}
            want = motion.me_fullsearch_torch(cur, ref, BLOCK, 48, metric)
            if routes != {motion.KERNELS[metric]: 1} or not (
                    got.is_cuda and torch.equal(got, want)):
                fail(f"{key} {name} 16/48: launches {routes}, "
                     f"{int((got != want).any(-1).sum())} blocks differ from "
                     f"the plain version's")
            at16 = int((got[..., 0] == int(table48[24 + 16])).sum())
            parts.append(f"{key} {metric} {name} 16/48 equal, {at16} blocks "
                         f"at m = 16 (u8 {int(table48[24 + 16])})")
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

    yuv_rows = yuv_targets_phase(dev, ctx, smi, cam_srcs, ov_srcs,
                                 drive_composer)
    batch_rows = batch_phases(dev, smi, rng)
    pyramid_rows = pyramid_phase(dev, ctx, smi, luma_sample)
    packed_phase(dev, ctx, rng)
    station_phase(dev, rng, smi)
    net_rows = network_phases(dev, smi)

    # phase 25: the live tick's host profile (phase 4's station)
    t0 = time.perf_counter()
    tick = tick_profile(dev, host_sets, ov_host, tone)
    print(f"[25 live tick host profile, {TICK_WINDOW} video ticks a window "
          f"after {TICK_WARM}; {time.perf_counter() - t0:.1f} s] "
          + tick_line(tick, smi), flush=True)

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
    kernels.extend(yuv_rows)
    kernels.extend(batch_rows)
    kernels.extend(pyramid_rows)
    kernels.extend(net_rows)
    print("[16 profiler] " + ("; ".join(profiler_notes) or "every profile "
                              "recorded every launch and activity"),
          flush=True)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
