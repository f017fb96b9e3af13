"""Time the ladder and the mixing wall of one checkout of the port on a
CUDA card.

    python tools/wall_compare.py ROOT

Imports ``swiftvideo_tpu_torch`` from the checkout at ROOT (this repo, or
an unpacked ``git archive`` of another commit), builds its frame kernels,
and drives ``chip_smoke.py``'s batch shapes through the checkout's own
entry points: the transcode ladder (``matscale.scale_y420p``, a 1080p y420p
frame to the three rungs of ``LADDER_RUNGS``) and the 64-stream wall
(``MixingWall.step``, 1080p streams onto 240x136 tiles of a 1920x1088
canvas, 800 stereo samples a stream): the default-cell tick, the per-cell
tick with cell 0 at opacity 0.5, the animated tick (the per-cell tick
with cell 0's opacity new every tick, from ``ANIMATED_SETS`` sets of
uniforms taken in turn: more than a kept layout's cache holds, so no tick
repeats a kept layout), and the default-cell tick of 60 streams on the
same grid (4 blank cells).  The wall's streams are a ring of
``WALL_RING`` batches made on the card (batch k from seed 15 + k), and
each tick takes the next batch, so every tick composites new frames at
new addresses, as a live wall does.  Each result, on every batch of the
ring, is held against the checkout's plain composite first: within 1 LSB
(a checkout whose ladder and default cells are float32 products is 1 LSB
off in places), blank cells blank, and the audio exactly.  For each it
prints the call
(CUDA events, median of batches of back-to-back calls), the device time
(every device activity torch.profiler records, summed, and their count a
call) and the host microseconds a call (``chip_smoke.py``'s helpers), as
one JSON line with the card's name and power limit.  To compare two
commits, run it for each on one card, in turns (A, B, B, A).
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

# chip_smoke.py imports the port only inside its functions, so the port
# these use is the checkout's at ROOT
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import (W, H, LADDER_RUNGS, WALL_CANVAS,  # noqa: E402
                        WALL_RING, WALL_SAMPLES, WALL_STREAMS, camera_planes,
                        device_total_ms, host_us, max_err, ring_of,
                        timed_ms, wall_batches)

# the animated tick's sets of uniforms, taken in turn
ANIMATED_SETS = 199


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    root = Path(sys.argv[1]).resolve()
    sys.path.insert(0, str(root))
    from swiftvideo_tpu_torch.media import PixelFormat as PF
    from swiftvideo_tpu_torch.ops import composite, frame, matscale
    from swiftvideo_tpu_torch.ops.uniforms import identity_uniforms
    from swiftvideo_tpu_torch.parallel import MixingWall
    if not Path(frame.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"imported {frame.__file__}, not the checkout at {root}")
    frame.build()
    dev = torch.device("cuda", 0)
    y420p = PF.y420p

    def plain(planes, out_size, uni):
        return composite.composite_stack_torch(y420p, out_size,
                                               [(planes, y420p, uni)], dev)

    def check(name, got, want):
        err = max_err(got, want)[0]
        if err > 1:
            raise SystemExit(f"{name}: {err} LSB off the plain composite")
        return err

    # the ladder
    src = [torch.from_numpy(p).to(dev)
           for p in camera_planes(np.random.default_rng(0), 1, W, H)[0]]
    plans = [matscale.plan_scale(identity_uniforms((W, H), r), r, (H, W))
             for r in LADDER_RUNGS]

    def ladder():
        return [matscale.scale_y420p(src, p) for p in plans]

    errs = {"ladder": max(check(f"ladder {r}", out, plain(
        src, r, identity_uniforms((W, H), r))) for r, out in zip(
            LADDER_RUNGS, ladder()))}

    # the wall, over a ring of input batches
    n = WALL_STREAMS
    ring = wall_batches(dev, n, 15, WALL_RING)
    pcm = np.random.default_rng(15).integers(
        -32768, 32768, (n, 2 * WALL_SAMPLES), np.int64).astype(np.int16)
    wall = MixingWall(n_streams=n, stream_size=(W, H), canvas_size=WALL_CANVAS,
                      audio_samples=WALL_SAMPLES, device=dev)
    n60 = n - 4
    wall60 = MixingWall(n_streams=n60, stream_size=(W, H),
                        canvas_size=WALL_CANVAS, audio_samples=WALL_SAMPLES,
                        device=dev)
    ring60 = [tuple(p[:n60] for p in batch) for batch in ring]
    tw, th = wall.tile
    gw = wall.grid_wh[0]
    audio = wall.shard(pcm)
    unis = wall.default_uniforms()
    unis[0] = identity_uniforms((W, H), (tw, th), opacity=0.5).pack()
    animated = [unis.copy() for _ in range(ANIMATED_SETS)]
    for k, u in enumerate(animated):
        u[0] = identity_uniforms((W, H), (tw, th),
                                 opacity=0.25 + 0.5 * k / ANIMATED_SETS).pack()
    next_plan, next_cells, next60 = ring_of(ring), ring_of(ring), ring_of(ring60)
    next_animated, next_unis = ring_of(ring), ring_of(animated)
    last_unis = [None]

    def tick_plan(batch=None):
        return wall.step(*(batch or next_plan()), audio)

    def tick_cells(batch=None):
        return wall.step(*(batch or next_cells()), audio, uniforms=unis)

    def tick_animated(batch=None):
        last_unis[0] = next_unis()
        return wall.step(*(batch or next_animated()), audio,
                         uniforms=last_unis[0])

    def tick60(batch=None):
        return wall60.step(*(batch or next60()), audio[:n60])

    def cell(out, s):
        r, c = divmod(s, gw)
        return [p[r * h:(r + 1) * h, c * w:(c + 1) * w]
                for p, (w, h) in zip(out[:3], ((tw, th), (tw // 2, th // 2),
                                               (tw // 2, th // 2)))]

    for name, tick, count, cell_unis in (
            ("wall plan tick", tick_plan, n, None),
            ("wall per-cell tick", tick_cells, n, unis),
            ("wall animated tick", tick_animated, n, last_unis),
            ("wall 60-stream tick", tick60, n60, None)):
        want_audio = np.clip(pcm[:count].astype(np.int64).sum(0), -32768, 32767)
        err = 0
        for k in range(WALL_RING):
            batch = ring[k] if count == n else ring60[k]
            out = tick(batch)
            tick_unis = last_unis[0] if cell_unis is last_unis else cell_unis
            if not np.array_equal(out[3].cpu().numpy(), want_audio):
                raise SystemExit(f"{name}: the audio differs from the host sum")
            for s in range(count):
                uni = (identity_uniforms((W, H), (tw, th)) if tick_unis is None
                       else tick_unis[s])
                err = max(err, check(f"{name} batch {k} cell {s}", cell(out, s),
                                     plain([p[s] for p in batch], (tw, th),
                                           uni)))
            for s in range(count, n):
                c = cell(out, s)
                if int(c[0].max()) or not all(bool((p == 128).all())
                                              for p in c[1:]):
                    raise SystemExit(f"{name} batch {k}: cell {s} not blank")
        errs[name] = err

    result = {}
    for name, fn in (("ladder", ladder), ("wall plan tick", tick_plan),
                     ("wall per-cell tick", tick_cells),
                     ("wall animated tick", tick_animated),
                     ("wall 60-stream tick", tick60)):
        dev_ms, acts = device_total_ms(fn, n=10)
        result[name] = {"ms": timed_ms(fn, reps=10, batch=3),
                        "device_ms": dev_ms, "device_activities": acts,
                        "host_us": host_us(fn, n=20), "max_abs_err": errs[name]}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"root": str(root), "card": smi, "batch": result}))


if __name__ == "__main__":
    main()
