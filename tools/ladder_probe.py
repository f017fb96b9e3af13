"""K1's device time on the HLS ladder, rung by rung, on a CUDA card.

    python tools/ladder_probe.py [--channels 16] [--ring 8]

Scales a ring of batches of 1080p y420p frames (``--channels`` frames a
batch, ``--ring`` batches on the card, each call the next batch, as the
ladder cell feeds them) to the five rungs of the HLS ladder, and prints one
JSON line with the card's name and power limit and, in microseconds a
call:

* ``device_us``: the frame kernel's device time by CUDA events, for each
  rung alone (its cell plan through ``frame.composite_cells_cuda``: one
  row-kernel launch), each launch of the row kernel that the ladder makes
  (the rows of the ladder's kept plan that ``sv_frame_cells`` merges, in
  its launch order, launched alone onto the ladder's canvases), and the
  whole ladder (``frame.composite_ladder_cuda``: three launches).  The
  stream is held by a spin kernel while the host enqueues ``REPS`` calls
  between two events, so the events time the launches back to back with no
  host gap between them (``held`` says whether the spin outlasted every
  enqueue); the median of ``TRIES``.
* ``host_us``: the host's time in one ``matscale.scale_ladder`` call (the
  enqueue alone), the median of 200 calls.
* ``tick_us``: a tick as the ladder cell times it, one
  ``matscale.scale_ladder`` call to an event on the card waited for, the
  median of 200 ticks.

Every rung of the ladder call is first checked bit for bit against the
rung's own ``matscale.scale_y420p_batch``.
"""

from __future__ import annotations

import argparse
import copy
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

HD = (1920, 1080)
HLS = [(1280, 720), (960, 540), (768, 432), (640, 360), (416, 234)]
REPS, TRIES = 20, 7
# launches sv_frame_cells merges into one launch of the row kernel
# (frame_composite.cu kMerge)
MERGE = 2
# the spin kernel's clock cycles: ~25 ms at the H100's ~2 GHz, far above
# REPS ladder enqueues
SPIN_CYCLES = 50_000_000


def _ring(dev, channels, ring, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    w, h = HD
    return [[torch.randint(0, 256, s, dtype=torch.uint8, generator=gen,
                           device=dev)
             for s in ((channels, h, w), (channels, h // 2, w // 2),
                       (channels, h // 2, w // 2))] for _ in range(ring)]


def device_us(fn, ring):
    """(device us a call of ``fn(batch)``, whether the spin held the stream
    through every try's enqueues)."""
    for batch in ring:
        fn(batch)
    torch.cuda.synchronize()
    times, held = [], True
    for _ in range(TRIES):
        spin0, a, b = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        spin0.record()
        torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        t0 = time.perf_counter_ns()
        for k in range(REPS):
            fn(ring[k % len(ring)])
        enqueue_ms = (time.perf_counter_ns() - t0) / 1e6
        b.record()
        b.synchronize()
        held &= enqueue_ms < spin0.elapsed_time(a)
        times.append(a.elapsed_time(b) * 1e3 / REPS)
    return statistics.median(times), held


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--channels", type=int, default=16)
    ap.add_argument("--ring", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    from swiftvideo_tpu_torch.media import PixelFormat as PF
    from swiftvideo_tpu_torch.ops import frame, matscale
    from swiftvideo_tpu_torch.ops.uniforms import identity_uniforms
    dev = torch.device("cuda", 0)
    frame.build()
    ring = _ring(dev, args.channels, args.ring)
    n = args.channels
    plans = [matscale.plan_scale(identity_uniforms(HD, r), r, HD[::-1])
             for r in HLS]
    steps = [(p.out_size, p.uniform) for p in plans]
    unis = [np.broadcast_to(p.uniform, (n, 29)) for p in plans]

    batch = ring[0]
    for plan, got in zip(plans, matscale.scale_ladder(*batch, plans)):
        want = matscale.scale_y420p_batch(*batch, plan)
        if not all(torch.equal(g, e) for g, e in zip(got, want)):
            raise SystemExit(f"rung {plan.out_size} differs from its batch "
                             f"scale")

    cases = {}
    for (w, h), u in zip(HLS, unis):
        cases[f"{w}x{h}"] = (lambda b, s=(w, h), u=u:
                             frame.composite_cells_cuda(s, b, PF.y420p, u))
    ladder = frame.ladder_plan(batch, PF.y420p, steps)
    flats = [torch.empty(s, dtype=torch.uint8, device=dev)
             for s in ladder.sizes]
    # the rung of each row of the ladder's table (a rung of more than
    # frame.CAPACITY frames has a row a CAPACITY of them)
    rung_of = [k for k in ladder.order for _ in ladder.plans[k].table]
    for a in range(0, len(rung_of), MERGE):
        part = copy.copy(ladder)
        part._keep(ladder.table[a:a + MERGE].copy())
        name = "launch " + "+".join("{}x{}".format(*HLS[k])
                                    for k in rung_of[a:a + MERGE])
        cases[name] = (lambda b, p=part:
                       frame._launch_cells(p, flats, b, dev))
    cases["ladder"] = lambda b: frame.composite_ladder_cuda(b, PF.y420p, steps)
    device, held = {}, True
    for name, fn in cases.items():
        device[name], ok = device_us(fn, ring)
        held &= ok

    host, tick = [], []
    for k in range(200):
        batch = ring[k % len(ring)]
        t0 = time.perf_counter_ns()
        matscale.scale_ladder(*batch, plans)
        t1 = time.perf_counter_ns()
        ev = torch.cuda.Event()
        ev.record()
        ev.synchronize()
        t2 = time.perf_counter_ns()
        host.append((t1 - t0) / 1e3)
        tick.append((t2 - t0) / 1e3)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    print(json.dumps({
        "card": smi[0] if smi else torch.cuda.get_device_name(0),
        "torch": torch.__version__, "channels": n, "ring": args.ring,
        "launch_order": ["{}x{}".format(*HLS[k]) for k in ladder.order],
        "device_us": device,
        "rungs_alone_sum_us": sum(device["{}x{}".format(*r)] for r in HLS),
        "held": held, "host_us": statistics.median(host),
        "tick_us": statistics.median(tick)}))


if __name__ == "__main__":
    main()
