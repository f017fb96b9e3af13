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
  shifted by a known vector; at search 48 through the entry point too,
  on a frame moved 16 columns (where the u8 emit's float32 table, the one
  every route reads, differs from the float64 oracles').  Phase 2 prints
  each motion kernel's registers and shared memory (ptxas) and what its
  SASS holds (``cuobjdump -sass``): the SSD and coarse kernels must hold an
  integer tensor-core instruction, the refine kernel byte-SIMD SAD and dot
  products, and the SAD kernel's byte-SIMD opcode sets its bound;
* the batch paths (phases 12-15): the transcode ladder (config 4, a 1080p
  frame to 1280x720, 854x480 and 640x360 through ``matscale.scale_y420p``,
  within 1 LSB of the plain composite; the same rungs through the frame
  kernel are timed for comparison only), the device resampler (config 2,
  128 channels of 44 100 samples, 44.1 -> 48 kHz, within 1e-4 of the host
  route with equal counts), the SRC stage's device route (pts and counts
  equal to the host route's), and the mixing wall (config 5, 64 1080p
  streams onto a 1920x1088 canvas of 240x136 tiles with 800 stereo samples
  each): its plan path within 1 LSB of the plain composite of every
  stream, its per-cell path (one frame-kernel launch per stream, exactly
  64 a tick) at 0 LSB, the audio equal to the host sum, and 60 streams on
  the same grid (blank excess cells);
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
  sessions seed the 64 1080p streams of the wall (per-cell tick: 64 K1
  launches, each tile equal to its session's stream); ``serve --record``
  as a child (one worker, then two) taking 16 publishers of 5 s of 1080p30
  AVC at ~6 Mbit/s and AAC at ~128 kbit/s, every recorded file byte for
  byte what its publisher sent; and four of those streams through a flavor
  push, back byte-identical.  ``serve`` is host-only and runs in a child,
  so nothing forks this process after CUDA is initialised.

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
RESAMPLE_CHANNELS, RESAMPLE_IN = 128, 44100
WALL_STREAMS, WALL_CANVAS, WALL_SAMPLES = 64, (1920, 1088), 800
REPLACES = {"K1": "swiftvideo_tpu/ops/pallas_frame.py:127",
            "K2": "swiftvideo_tpu/ops/pallas_frame.py:1100",
            "K3": "swiftvideo_tpu/ops/pallas_frame.py:1524",
            "K4": "swiftvideo_tpu/ops/motion.py:260",
            "K5": "swiftvideo_tpu/ops/motion.py:982",
            # the pyramid's two stages: the grouped-conv coarse program and
            # the refine program (both XLA, around no Pallas kernel)
            "coarse": "swiftvideo_tpu/ops/motion.py:537",
            "refine": "swiftvideo_tpu/ops/motion.py:1265"}
# the two-stage search (phase 17) and the codec-fed station (phase 19): the
# refine's half-width, and the station's video frames and 10 ms audio
# packets at 44.1 kHz
REFINE = 2
PYRAMID_SIZES = (("1080p", (1080, 1920)), ("4K", (2160, 3840)))
STATION_FRAMES, STATION_AUDIO = 8, 30


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


def batch_phases(dev, smi, rng):
    """Phases 12-15: the batch paths of configs 4, 2 and 5 through the
    port's entry points on ``dev``.  Returns the wall's per-cell K1 row
    for the kernels line."""
    from swiftvideo_tpu_torch.core import TimePoint
    from swiftvideo_tpu_torch.media import AudioFormat, AudioSample, PixelFormat
    from swiftvideo_tpu_torch.mix import AudioSampleRateConversion
    from swiftvideo_tpu_torch.ops import composite, frame, matscale, resample
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

    def ladder_k1():
        return [frame.composite_frame_cuda(r, [(src, y420p, identity_uniforms(
            (W, H), r))]) for r in LADDER_RUNGS]

    frame.launches = composite.calls = 0
    outs = ladder()
    if (frame.launches, composite.calls) != (0, 0):
        fail(f"the ladder launched {frame.launches} frame kernels and "
             f"{composite.calls} plain composites")
    parts = []
    for r, out, k1 in zip(LADDER_RUNGS, outs, ladder_k1()):
        want = plain_scale(src, (W, H), r)
        err, at1 = max_err(out, want)
        k1_err, _ = max_err(k1, want)
        if err > 1 or k1_err > LSB or not all(
                o.device == dev and o.dtype == torch.uint8 for o in out):
            fail(f"ladder {r}: products vs plain err {err}, K1 vs plain "
                 f"{k1_err}")
        parts.append(f"{r[0]}x{r[1]} err {err} ({at1} px at 1 LSB)")
    lad_ms = timed_ms(ladder, reps=10, batch=5)
    lad_dev, lad_acts = device_total_ms(ladder)
    lad_k1_ms = timed_ms(ladder_k1, reps=10, batch=5)
    lad_k1_dev, _ = device_total_ms(ladder_k1)
    lad_flops = sum(scale_flops(p, (H, W)) for p in plans)
    lad_bytes = y420p_bytes(W, H) + sum(y420p_bytes(*r) for r in LADDER_RUNGS)
    lad_bound, lad_by = bound(lad_bytes, lad_flops, NONTENSOR_OPS)
    lad_taps = tap_bytes(plans, (H, W)) + sum(y420p_bytes(*r)
                                              for r in LADDER_RUNGS)
    lad_fn, _ = bound(lad_taps, 0, 1.0)
    print(f"[12 ladder, config 4: {W}x{H} y420p -> {len(plans)} rungs by "
          f"matscale.scale_y420p, tol 1 LSB vs plain] " + "; ".join(parts)
          + f" | call {lad_ms:.4f} ms, device {lad_dev:.4f} ms "
          f"({lad_acts:.0f} device activities a call) | dense form: "
          f"{lad_flops / 1e9:.3f} GFLOP, {lad_bytes / 1e6:.3f} MB, bound "
          f"{lad_bound:.4f} ms ({lad_by}), share of the dense form's bound "
          f"{lad_bound / lad_dev:.1%} | the function: {lad_taps / 1e6:.3f} MB "
          f"of tap sectors and targets, byte bound {lad_fn:.6f} ms, share "
          f"{lad_fn / lad_dev:.2%} | same rungs through K1 (comparison "
          f"only): call {lad_k1_ms:.4f} ms, device {lad_k1_dev:.4f} ms, "
          f"share of the function's bound {lad_fn / lad_k1_dev:.1%} | {smi}",
          flush=True)

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

    # phase 15: the mixing wall (config 5), every stream, both paths
    gen = torch.Generator(device=dev).manual_seed(15)
    n = WALL_STREAMS
    ys = torch.randint(0, 256, (n, H, W), dtype=torch.uint8, device=dev,
                       generator=gen)
    us, vs = (torch.randint(0, 256, (n, H // 2, W // 2), dtype=torch.uint8,
                            device=dev, generator=gen) for _ in range(2))
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

    def tick_plan():
        return wall.step(ys, us, vs, audio_t, gains_t)

    unis = wall.default_uniforms()
    unis[0] = identity_uniforms((W, H), (tw, th), opacity=0.5).pack()

    def tick_cells():
        return wall.step(ys, us, vs, audio_t, gains_t, uniforms=unis)

    frame.launches = composite.calls = 0
    plan_out = tick_plan()
    torch.cuda.synchronize()
    if (frame.launches, composite.calls) != (0, 0):
        fail(f"wall plan path: {frame.launches} frame launches, "
             f"{composite.calls} plain composites")
    frame.launches = composite.calls = 0
    cell_out = tick_cells()
    torch.cuda.synchronize()
    cell_launches, cell_plain = frame.launches, composite.calls
    if (cell_launches, cell_plain) != (n, 0):
        fail(f"wall per-cell path: {cell_launches} frame launches (want {n}),"
             f" {cell_plain} plain composites")
    plan_err = plan_at1 = cell_err = 0
    for s in range(n):
        planes = [ys[s], us[s], vs[s]]
        e, at1 = max_err(cells(plan_out, s), plain_scale(planes, (W, H),
                                                         (tw, th)))
        plan_err, plan_at1 = max(plan_err, e), plan_at1 + at1
        e, _ = max_err(cells(cell_out, s), plain_scale(planes, (W, H),
                                                       (tw, th), unis[s]))
        cell_err = max(cell_err, e)
    audio_ok = all(np.array_equal(o[3].cpu().numpy(), want_audio)
                   for o in (plan_out, cell_out))
    if plan_err > 1 or cell_err > LSB or not audio_ok:
        fail(f"wall: plan path err {plan_err}, per-cell err {cell_err}, "
             f"audio equal {audio_ok}")
    # 60 streams on the same 8x8 grid: the blank-fill assembly
    n60 = n - 4
    wall60 = MixingWall(n_streams=n60, stream_size=(W, H),
                        canvas_size=WALL_CANVAS, audio_samples=WALL_SAMPLES,
                        device=dev)
    out60 = wall60.step(ys[:n60], us[:n60], vs[:n60], audio_t[:n60],
                        gains_t[:n60])
    same = all(torch.equal(a, b) for s in range(n60)
               for a, b in zip(cells(out60, s), cells(plan_out, s)))
    blank = all(int(c[0].max()) == 0 and all(bool((p == 128).all())
                                             for p in c[1:])
                for s in range(n60, n) for c in [cells(out60, s)])
    if wall60.aligned or not (same and blank):
        fail(f"wall of {n60}: aligned {wall60.aligned}, tiles equal {same}, "
             f"excess cells blank {blank}")
    plan_ms = timed_ms(tick_plan, reps=10, batch=3)
    plan_dev, plan_acts = device_total_ms(tick_plan, n=10)
    cell_ms = timed_ms(tick_cells, reps=5, batch=2, warmup=1)
    cell_dev, cell_acts = device_total_ms(tick_cells, n=5)
    wall_flops = n * scale_flops(wall._plan, (H, W))
    wall_bytes = n * (y420p_bytes(W, H) + 2 * 2 * WALL_SAMPLES) \
        + y420p_bytes(*WALL_CANVAS) + 2 * 2 * WALL_SAMPLES
    wall_bound, wall_by = bound(wall_bytes, wall_flops, NONTENSOR_OPS)
    # the function's least bytes: each stream's tap sectors, the canvas,
    # the audio in and out; both paths compute it
    cell_taps = tap_bytes([wall._plan], (H, W))
    wall_taps = wall_bytes - n * y420p_bytes(W, H) + n * cell_taps
    cell_bound, cell_by = bound(wall_taps, 0, 1.0)
    print(f"[15 wall, config 5: {n} streams {W}x{H} -> {WALL_CANVAS[0]}x"
          f"{WALL_CANVAS[1]}, {tw}x{th} tiles, {WALL_SAMPLES} stereo samples "
          f"a stream] plan path: every tile err <= {plan_err} vs plain "
          f"({plan_at1} px at 1 LSB), 0 frame launches; per-cell path (tile 0 "
          f"at opacity 0.5): err {cell_err} vs plain, {cell_launches} K1 "
          f"launches, {cell_plain} plain composites; audio equal to the host "
          f"sum; {n60} streams: not aligned, tiles equal, 4 excess cells "
          f"blank | the function: {wall_taps / 1e6:.3f} MB of tap sectors, "
          f"canvas and audio, byte bound {cell_bound:.6f} ms | plan tick: call "
          f"{plan_ms:.4f} ms, device {plan_dev:.4f} ms ({plan_acts:.0f} device "
          f"activities), share of the function's bound "
          f"{cell_bound / plan_dev:.2%}; dense form: {wall_flops / 1e9:.3f} "
          f"GFLOP, {wall_bytes / 1e6:.3f} MB, bound {wall_bound:.4f} ms "
          f"({wall_by}), share of the dense form's bound "
          f"{wall_bound / plan_dev:.1%} | per-cell tick: call {cell_ms:.4f} "
          f"ms, device {cell_dev:.4f} ms ({cell_acts:.0f} device activities), "
          f"share of the function's bound {cell_bound / cell_dev:.1%} | {smi}",
          flush=True)

    # the per-cell path's K1 call, alone, for the kernels line
    cell_srcs = [([ys[1], us[1], vs[1]], y420p, unis[1])]

    def cell_call():
        return frame.composite_frame_cuda((tw, th), cell_srcs)

    k1_bms, k1_by = bound(cell_taps + y420p_bytes(tw, th), 0, 1.0)
    return {"name": f"frame_composite (K1: wall cell, {W}x{H} -> {tw}x{th})",
            "route": "cuda",
            "source": "swiftvideo_tpu_torch/csrc/frame_composite.cu",
            "replaces": REPLACES["K1"], "launches": cell_launches,
            "max_abs_err": cell_err, "ms": timed_ms(cell_call),
            "device_ms": device_ms(cell_call, "frame_composite_kernel"),
            "plain_ms": timed_ms(lambda: composite.composite_stack_torch(
                y420p, (tw, th), cell_srcs, dev), reps=5, batch=2),
            "bound_ms": k1_bms, "bound_by": k1_by, "library_ms": None}


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
    wall tick (64 K1 launches) and one plan tick.  Returns the kernels-line
    row of the per-cell K1 launches."""
    import asyncio
    from swiftvideo_tpu_torch.core import EventBox, StepClock, TimePoint, Tx
    from swiftvideo_tpu_torch.media.coded import (CodedMediaSample,
                                                  MediaFormat, MediaType)
    from swiftvideo_tpu_torch.net.rtmp import Rtmp, chunks
    from swiftvideo_tpu_torch.ops import composite, frame
    from swiftvideo_tpu_torch.ops.uniforms import identity_uniforms
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

    torch.cuda.synchronize()
    for kern in frame.kernel_launches:
        frame.kernel_launches[kern] = 0
    frame.launches = composite.calls = 0
    cell_out = tick_cells()
    torch.cuda.synchronize()
    k1, cell_plain = frame.kernel_launches[frame.YUV_KERNEL], composite.calls
    plan_out = tick_plan()
    torch.cuda.synchronize()
    if k1 != n or frame.launches != n or cell_plain or composite.calls:
        fail(f"RTMP-fed wall: {k1} K1 launches (want {n}), {frame.launches} "
             f"frame launches after the plan tick, {composite.calls} plain "
             f"composites")
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
    if cell_err > LSB or plan_vs_cell > 1 or not audio_ok:
        fail(f"RTMP-fed wall: per-cell tiles vs their sessions' streams err "
             f"{cell_err}, plan vs per-cell {plan_vs_cell}, audio exact "
             f"{audio_ok}")
    cell_ms = timed_ms(tick_cells, reps=3, batch=2, warmup=1)
    cell_dev, cell_acts = device_total_ms(tick_cells, n=3)
    cell_srcs = [(planes[1], PixelFormat.y420p, unis[1])]

    def cell_call():
        return frame.composite_frame_cuda((tw, th), cell_srcs)

    cell_taps = tap_bytes([wall._plan], (H, W))
    bms, by = bound(cell_taps + y420p_bytes(tw, th), 0, 1.0)
    row = {"name": f"frame_composite (K1: RTMP-fed wall cell, {W}x{H} -> "
                   f"{tw}x{th})",
           "route": "cuda", "source": "swiftvideo_tpu_torch/csrc/frame_composite.cu",
           "replaces": REPLACES["K1"], "launches": k1, "max_abs_err": cell_err,
           "ms": timed_ms(cell_call),
           "device_ms": device_ms(cell_call, "frame_composite_kernel"),
           "plain_ms": timed_ms(lambda: composite.composite_stack_torch(
               PixelFormat.y420p, (tw, th), cell_srcs, dev), reps=5, batch=2),
           "bound_ms": bms, "bound_by": by, "library_ms": None}
    print(f"[21 RTMP ingest -> wall, config 5's host shape] {n} publishers "
          f"into one port Rtmp server (dechunker native "
          f"{chunks.native_available()}): sessions and their 3 samples each "
          f"accepted in {accept_s:.3f} s; {n} streams {W}x{H} made on the card "
          f"from the sessions' seeds; per-cell tick: {k1} K1 launches, every "
          f"tile err {cell_err} vs the plain composite of its session's "
          f"stream; plan tick within {plan_vs_cell} LSB of it; audio fold "
          f"exact | per-cell tick call {cell_ms:.4f} ms, device {cell_dev:.4f} "
          f"ms ({cell_acts:.0f} device activities); K1 cell device "
          f"{row['device_ms']:.4f} ms | {smi}", flush=True)
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
    wall_k1 = batch_phases(dev, smi, rng)
    pyramid_rows = pyramid_phase(dev, ctx, smi, luma_sample)
    packed_phase(dev, ctx, rng)
    station_phase(dev, rng, smi)
    net_rows = network_phases(dev, smi)

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
    kernels.append(wall_k1)
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
