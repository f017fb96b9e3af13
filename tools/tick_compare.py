"""Profile the live station's tick of one or more checkouts of the port on a
CUDA card.

    python tools/tick_compare.py ROOT [ROOT ...]

For one ROOT it imports ``swiftvideo_tpu_torch`` from the checkout there
(this repo, or an unpacked ``git archive`` of another commit), builds its
frame kernels and runs ``chip_smoke.py``'s phase 25 on it
(``tick_profile``: the live station's y420p tick through the checkout's
Composer, seed 0): host ms per video tick (p50 and p99 of the steps that
mix a frame, all host work a tick, and the audio-only steps'), host
microseconds a tick of each stage (cProfile), the TimePoints built an audio
tick (cProfile's count), device busy ms a tick and the device's idle share
(torch.profiler), with the launch, plain-call and 0 LSB checks of phase 4
and the mixed audio held equal to a plain replay.
Then it times four routes of the tick's uploads, 4 cameras of 1080p y420p
planes from numpy, alternating two frames, 60 ticks each with no sync
between them: the checkout's ``barriers.upload``, a page-locked copy per
plane (``pin_memory`` then a ``non_blocking`` copy), a pageable
``.to(device)``, and a reused ring of page-locked staging slots
(``StagingRing``, three a plane shape); the last 8 ticks' device tensors
are held, and each is held equal to its source after the window.  It prints one JSON line with the card's name and power
limit.  Given several ROOTs it runs itself once per ROOT, in the order
given, each in its own process, and prints their lines and a summary; to
compare two commits, give them in turns (A B B A).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from collections import deque
from pathlib import Path

import numpy as np
import torch

# chip_smoke.py imports the port only inside its functions, so the port
# these use is the checkout's at ROOT
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import (camera_planes, overlay_plane,  # noqa: E402
                        tick_line, tick_profile)

# ticks of uploads a route makes, and the last of them held (and checked)
# as a tick's frames are held downstream while their copies are in flight
UPLOAD_TICKS, UPLOAD_HELD = 60, 8


class StagingRing:
    """Page-locked staging slots for host-to-device copies, ``depth`` slots
    per (shape, dtype), reused in turn.  A slot is refilled only after the
    copy that last read it has run (a CUDA event recorded after each copy
    is waited on first), and each copy makes a new device tensor, so
    nothing handed on aliases a slot."""

    def __init__(self, depth: int = 3):
        self.depth = depth
        self._rings = {}

    def upload(self, t: torch.Tensor, device: torch.device) -> torch.Tensor:
        key = (tuple(t.shape), t.dtype)
        ring = self._rings.get(key)
        if ring is None:
            ring = self._rings[key] = [
                [torch.empty(key[0], dtype=t.dtype, pin_memory=True), None]
                for _ in range(self.depth)]
        slot = ring.pop(0)
        ring.append(slot)
        staged, done = slot
        if done is not None:
            done.synchronize()
        staged.copy_(t)
        out = torch.empty(key[0], dtype=t.dtype, device=device)
        out.copy_(staged, non_blocking=True)
        slot[1] = done = done or torch.cuda.Event()
        done.record(torch.cuda.current_stream(device))
        return out


def upload_routes(dev, host_sets, barriers) -> dict:
    """{route: {host_ms_p50, host_ms_mean, wall_ms}} per tick of the live
    tick's camera uploads by each route."""
    routes = {
        "upload": lambda a: barriers.upload(a, dev),
        "pin_memory": lambda a: torch.from_numpy(a).pin_memory().to(
            dev, non_blocking=True),
        "pageable": lambda a: torch.from_numpy(a).to(dev),
        "ring": lambda a: ring.upload(torch.from_numpy(a), dev)}
    ring = StagingRing()
    out = {}
    for name, route in routes.items():
        for planes in host_sets[0]:  # warm: allocations, rings
            [route(p) for p in planes]
        torch.cuda.synchronize()
        host, kept = [], deque(maxlen=UPLOAD_HELD)
        t0 = time.perf_counter()
        for k in range(UPLOAD_TICKS):
            t = time.perf_counter()
            got = [[route(p) for p in planes]
                   for planes in host_sets[k % 2]]
            host.append((time.perf_counter() - t) * 1e3)
            kept.append((k, got))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / UPLOAD_TICKS
        for k, got in kept:
            for dev_planes, planes in zip(got, host_sets[k % 2]):
                for d, p in zip(dev_planes, planes):
                    if not np.array_equal(d.cpu().numpy(), p):
                        raise SystemExit(f"{name}: tick {k}'s upload differs "
                                         "from its source")
        out[name] = {"host_ms_p50": float(np.median(host)),
                     "host_ms_mean": float(np.mean(host)), "wall_ms": wall}
    return out


def one(root: Path) -> dict:
    sys.path.insert(0, str(root))
    from swiftvideo_tpu_torch.ops import barriers, frame
    if not Path(frame.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"imported {frame.__file__}, not the checkout at {root}")
    frame.build()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    host_sets = [camera_planes(rng, 4) for _ in range(2)]
    ov_host = overlay_plane(rng)
    tone = [(np.sin(np.arange(480) * (k + 1) * 0.05) * 3000).astype(np.int16)
            for k in range(4)]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    r = tick_profile(dev, host_sets, ov_host, tone)
    print(f"[{root}] {tick_line(r, smi)}", file=sys.stderr, flush=True)
    return {"root": str(root), "card": smi, "tick": r,
            "upload_routes": upload_routes(dev, host_sets, barriers)}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    roots = [Path(a).resolve() for a in sys.argv[1:]]
    if len(roots) == 1:
        print(json.dumps(one(roots[0])), flush=True)
        return
    rows = []
    for root in roots:
        run = subprocess.run([sys.executable, __file__, str(root)],
                             capture_output=True, text=True)
        sys.stderr.write(run.stderr)
        if run.returncode != 0:
            raise SystemExit(f"{root}: exit {run.returncode}")
        rows.append(json.loads(run.stdout.strip().splitlines()[-1]))
        print(json.dumps(rows[-1]), flush=True)
    for r in rows:
        t, u = r["tick"], r["upload_routes"]
        print(f"{r['root']}: step p50 {t['tick_p50_ms']:.4f} p99 "
              f"{t['tick_p99_ms']:.4f} ms, host {t['host_ms_per_tick']:.4f} "
              f"ms a tick, audio-only steps "
              f"{t['audio_step_ms_per_tick']:.4f} ms a tick, AudioMixer._mix "
              f"{t['stage_us']['AudioMixer._mix']:.1f} us a tick (cProfile), "
              f"TimePoints {t['timepoints_per_audio_tick']:.1f} an audio "
              f"tick, busy {t['busy_ms_per_tick']:.4f} ms, idle "
              f"{t['idle_share']:.1%}; uploads (host p50 / wall ms a tick) "
              + ", ".join(f"{k} {v['host_ms_p50']:.4f} / {v['wall_ms']:.4f}"
                          for k, v in u.items()) + f" | {r['card']}")


if __name__ == "__main__":
    main()
