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
  instruction, and the SAD kernel's byte-SIMD opcode sets its bound;
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
  the same grid (blank excess cells).

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

    wall_k1 = batch_phases(dev, smi, rng)

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
    kernels.append(wall_k1)
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
