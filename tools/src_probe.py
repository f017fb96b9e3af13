"""The audio ingest's SRC stages on both of the resampler's routes, on a
CUDA card.

    python tools/src_probe.py [--seconds 10] [--seed 1] [--ticks 300]

Builds the ``resample128-aac`` cell of the benchmark (64 stereo 44.1 kHz
publishers, 1024-sample f32p frames from its host ring) three times and
runs each in a closed loop for ``--seconds``: with every stream's
``AudioSampleRateConversion`` on the card route, as the cell runs it,
then with each replaced by a host-route stage (``use_device=False``: the
product in numpy) before the warm-up, then on the card route again.  It
prints one JSON line with the card's name and power limit and, under
``routes``, for each run of each route:

* ``frames_per_s``: input frames converted a second, as the cell counts
  them, and ``us_per_frame``;
* ``correct``: the cell's check of what that route emitted;
* ``top``: the ``--ticks`` ticks after the window under cProfile, the
  functions with the most time of their own, in us a frame (cProfile's
  overhead inflates the Python-heavy ones).

The host-route run is a comparison, not a cell: the benchmark and the
CLI's ``transcode`` on a card run the card route.
"""

from __future__ import annotations

import argparse
import cProfile
import json
import pstats
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

WORKLOAD = "resample128-aac"
TOP = 14


def _route(route: str, seed: int, seconds: float, ticks: int,
           device="cuda", overrides=None) -> dict:
    from svbench import cells
    from swiftvideo_tpu_torch.mix.src_audio import AudioSampleRateConversion
    spec = cells.resolve(cells.load_benchmark(), WORKLOAD,
                         overrides=overrides)
    cell = spec.driver.Cell(spec.config, spec.traffic, seed,
                            torch.device(device))
    if route == "host":
        c = spec.config
        cell.stages = [AudioSampleRateConversion(
            c["out_rate"], c["channels"], c["out_format"])
            for _ in range(cell.n)]
    cell.warm()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        cell.tick()
    rate = cell.frames / (time.perf_counter() - t0)
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(ticks):
        cell.tick()
    prof.disable()
    frames = ticks * cell.n
    stats = pstats.Stats(prof).stats
    top = sorted(((tt, f"{Path(f).name}:{line}:{fn}")
                  for (f, line, fn), (_cc, _nc, tt, _ct, _c) in stats.items()),
                 reverse=True)[:TOP]
    cell.release()
    checks = cell.check(torch.float32)
    return {"frames_per_s": rate, "us_per_frame": 1e6 / rate,
            "correct": all(v <= lim for v, lim in checks.values()),
            "checks": {k: v for k, (v, _lim) in checks.items()},
            "top": [[name, tt * 1e6 / frames] for tt, name in top]}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--ticks", type=int, default=300)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    routes: dict = {}
    for route in ("card", "host", "card"):
        routes.setdefault(route, []).append(
            _route(route, args.seed, args.seconds, args.ticks))
    print(json.dumps({
        "card": smi[0] if smi else torch.cuda.get_device_name(0),
        "torch": torch.__version__, "seed": args.seed, "routes": routes}))


if __name__ == "__main__":
    main()
