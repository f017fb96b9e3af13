"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the frame kernel from ``swiftvideo_tpu_torch/csrc``, holds it
against the plain torch version at the live-station size (a 1080p canvas,
four full-1080p y420p cameras scaled 2:1 into its quadrants at opacity
0.9, and a 1920x216 RGBA lower third), drives the port's Composer for 60+
video ticks of that scene with four stereo s16 audio assets, checks the
audio fold on the card against the host loop, and times the kernel and the
plain version per tick.  Each phase prints one line; any failure exits
non-zero.  The last line is the run's JSON summary.  Needs a CUDA device;
imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

W, H = 1920, 1080
OV_H = 216
LSB = 1  # tolerance of every pixel comparison, in u8 steps
FRAME_REPLACES = {"K1": "swiftvideo_tpu/ops/pallas_frame.py:127",
                  "K2": "swiftvideo_tpu/ops/pallas_frame.py:1100"}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def max_err(a, b):
    """(max abs error, pixels above 0) over paired plane lists."""
    d = [(x.int() - y.int()).abs() for x, y in zip(a, b)]
    return max(int(t.max()) for t in d), sum(int((t > 0).sum()) for t in d)


def camera_planes(rng, n):
    return [[rng.integers(0, 256, (H, W), np.int64).astype(np.uint8),
             rng.integers(0, 256, (H // 2, W // 2), np.int64).astype(np.uint8),
             rng.integers(0, 256, (H // 2, W // 2), np.int64).astype(np.uint8)]
            for _ in range(n)]


def overlay_plane(rng):
    """A 1920x216 RGBA lower third: random colour, alpha ramping 0..255
    across the width."""
    rgba = rng.integers(0, 256, (OV_H, W, 4), np.int64).astype(np.uint8)
    rgba[..., 3] = np.linspace(0, 255, W).astype(np.uint8)[None, :]
    return rgba


def timed_ms(fn, reps=20, batch=10):
    """Median device time per call over ``reps`` batches of ``batch``
    back-to-back calls, from CUDA events."""
    for _ in range(3):
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


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this run needs a CUDA card")
    from swiftvideo_tpu.core import Bus, EventBox, StepClock, TimePoint, Tx
    from swiftvideo_tpu.media import (AudioFormat, AudioSample, BufferType,
                                      ImageBuffer, PictureSample, PixelFormat,
                                      planes_for_format)
    from swiftvideo_tpu.scene import Composition, Element, ElementState, Scene
    from swiftvideo_tpu_torch.compose import Composer
    from swiftvideo_tpu_torch.mix import video_mixer
    from swiftvideo_tpu_torch.ops import audio, composite, frame
    from swiftvideo_tpu_torch.ops.registry import make_compute_context
    from swiftvideo_tpu_torch.ops.uniforms import rect_uniforms

    if any(m == "jax" or m.startswith("jax.") for m in sys.modules):
        fail("jax was imported")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    # phase 1: device
    print(smi)
    print(f"[1 device] {torch.cuda.get_device_name(0)} | torch "
          f"{torch.__version__} | cuda {torch.version.cuda}", flush=True)

    # phase 2: build
    t0 = time.perf_counter()
    frame.build()
    regs = [ln.strip() for ln in frame.build_log.splitlines()
            if "registers" in ln]
    print(f"[2 build] frame_composite.cu built and loaded in "
          f"{time.perf_counter() - t0:.2f} s; {'; '.join(regs) or 'cached'}",
          flush=True)

    # phase 3: kernel vs plain on the card, entry() geometry + lower third
    rng = np.random.default_rng(0)
    cams = [[torch.from_numpy(p).to(dev) for p in planes]
            for planes in camera_planes(rng, 4)]
    cam_srcs = [(cams[s], PixelFormat.y420p,
                 rect_uniforms((W, H), (W, H), x=(s % 2) * 960,
                               y=(s // 2) * 540, w=960, h=540, opacity=0.9))
                for s in range(4)]
    ov_srcs = [([torch.from_numpy(overlay_plane(rng)).to(dev)], PixelFormat.RGBA,
                rect_uniforms((W, OV_H), (W, H), x=0, y=H - OV_H - 40, w=W,
                              h=OV_H))]
    stacks = {"K1": cam_srcs, "K2": ov_srcs, "K1+K2": cam_srcs + ov_srcs}
    errs = {}
    parts = []
    for name, srcs in stacks.items():
        for fmt in (PixelFormat.y420p, PixelFormat.nv12, PixelFormat.nv21):
            got = frame.composite_frame_cuda((W, H), srcs, fmt)
            ref = composite.composite_stack_torch(fmt, (W, H), srcs, dev)
            torch.cuda.synchronize()
            err, n_above = max_err(got, ref)
            if err > LSB:
                fail(f"{name} {fmt.value}: kernel vs plain max abs err {err}")
            errs[name] = max(errs.get(name, 0), err)
            parts.append(f"{name}/{fmt.value} err {err} above0 {n_above}")
    print(f"[3 kernel vs plain, tol {LSB} LSB] " + "; ".join(parts), flush=True)

    # phase 4: the main path — Composer ticks on a StepClock
    clock = StepClock(TimePoint(480, 48000))
    audio_bus, picture_bus = Bus(clock), Bus(clock)
    elements = tuple(
        Element(name=f"cam{s}", z_index=s, initial_state=ElementState(
            pic_pos=((s % 2) * 960.0, (s // 2) * 540.0), size=(960.0, 540.0),
            transparency=0.1))
        for s in range(4)) + (
        Element(name="lower_third", z_index=10, initial_state=ElementState(
            pic_pos=(0.0, float(H - OV_H - 40)), size=(float(W), float(OV_H)))),)
    comp = Composition(name="live", canvas_size=(W, H),
                       frame_duration=TimePoint(1000, 30000),
                       audio_frame_duration=TimePoint(480, 48000),
                       sample_rate=48000, channel_count=2,
                       scenes=(Scene(name="main", elements=elements),),
                       initial_scene="main")
    ctx = make_compute_context(dev)
    composer = Composer(clock, workspace_id="w", composition=comp,
                        audio_bus=audio_bus, picture_bus=picture_bus,
                        compute_context=ctx, output_format=PixelFormat.y420p)
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

    def spy(ctx_, out_fmt, size, sources, target=None):
        last_call.update(out_fmt=out_fmt, size=size, sources=sources)
        return mixer_composite(ctx_, out_fmt, size, sources, target)

    video_mixer.composite_frame = spy
    host_sets = [camera_planes(rng, 4) for _ in range(2)]
    ov_host = overlay_plane(rng)

    def picture(asset, fmt, planes):
        h, w = planes[0].shape[:2]
        img = ImageBuffer(pixel_format=fmt, buffer_type=BufferType.cpu,
                          size=(w, h), planes=tuple(planes_for_format(
                              fmt, (w, h))), buffers=tuple(planes))
        return PictureSample(img, asset, "w", time_point=clock.current(),
                             pts_value=clock.current())

    audio_pts = TimePoint(0, 48000)
    tone = [(np.sin(np.arange(480) * (k + 1) * 0.05) * 3000).astype(np.int16)
            for k in range(4)]
    n_ticks, step = 60, 0
    frame.launches = 0
    composite.calls = 0
    t0 = time.perf_counter()
    picture_bus.append(EventBox.just(picture("lt", PixelFormat.RGBA, [ov_host])))
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
    if launches != len(frames):
        fail(f"frame kernel launches {launches} != video ticks {len(frames)}")
    if plain_calls != 0:
        fail(f"{plain_calls} ticks took the plain composite")
    if not all(isinstance(p, torch.Tensor) and p.is_cuda
               and f.buffer_type() == BufferType.gpu
               for f in frames for p in f.planes()):
        fail("a mixed frame does not hold CUDA tensors")
    last = frames[-1].planes()
    ref = composite.composite_stack_torch(last_call["out_fmt"],
                                          last_call["size"],
                                          last_call["sources"], dev)
    if len(last_call["sources"]) != 5:
        fail(f"last tick composited {len(last_call['sources'])} sources, not 5")
    main_err, main_above = max_err(last, ref)
    if main_err > LSB:
        fail(f"last mixed frame vs plain max abs err {main_err}")
    if [tuple(p.shape) for p in last] != [(H, W), (H // 2, W // 2),
                                          (H // 2, W // 2)]:
        fail(f"mixed frame shapes {[tuple(p.shape) for p in last]}")
    counts = {a.number_samples() for a in mixed_audio}
    if counts != {480} or not all(a.data()[0].shape == (960,)
                                  for a in mixed_audio):
        fail(f"mixed audio sample counts {counts}")
    if not np.any(mixed_audio[-1].data()[0]):
        fail("mixed audio is silent")
    print(f"[4 main path] {len(frames)} video ticks in {wall:.2f} s host wall "
          f"({step} clock steps); frame kernel launches {launches}; plain "
          f"composites {plain_calls}; last frame vs plain err {main_err} "
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

    # phase 6: per-tick times at the main-path shape
    full = stacks["K1+K2"]
    times = {
        "K1": timed_ms(lambda: frame.composite_frame_cuda((W, H), cam_srcs)),
        "K2": timed_ms(lambda: frame.composite_frame_cuda((W, H), ov_srcs)),
        "K1+K2": timed_ms(lambda: frame.composite_frame_cuda((W, H), full)),
    }
    plain = {
        "K1": timed_ms(lambda: composite.composite_stack_torch(
            PixelFormat.y420p, (W, H), cam_srcs, dev), batch=2),
        "K2": timed_ms(lambda: composite.composite_stack_torch(
            PixelFormat.y420p, (W, H), ov_srcs, dev), batch=2),
        "K1+K2": timed_ms(lambda: composite.composite_stack_torch(
            PixelFormat.y420p, (W, H), full, dev), batch=2),
    }
    print("[6 timings, median of 20 reps, ms per 1080p tick] " + "; ".join(
        f"{k}: kernel {times[k]:.4f} plain {plain[k]:.4f}" for k in times)
        + f" | {smi}", flush=True)

    kernels = [{"name": f"frame_composite ({k}: "
                        f"{'planar-yuv cameras' if k == 'K1' else 'RGBA overlay'})",
                "route": "cuda",
                "source": "swiftvideo_tpu_torch/csrc/frame_composite.cu",
                "replaces": FRAME_REPLACES[k], "launches": launches,
                "max_abs_err": errs[k], "ms": times[k], "plain_ms": plain[k]}
               for k in ("K1", "K2")]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
