"""Time the motion search of one checkout of the port on a CUDA card.

    python tools/motion_compare.py ROOT

Imports ``swiftvideo_tpu_torch`` from the checkout at ROOT (this repo, or
an unpacked ``git archive`` of another commit), builds its motion kernels,
and runs ``motion.me_fullsearch`` on ``chip_smoke.py``'s motion frames
(``motion_frames``, same seeds) at 1080p and 4K with 16x16 blocks and a
64-pixel window, SAD and SSD; then, where the checkout has the two-stage
search, its coarse stage (``me_coarse``), its refine (``me_refine``, SSD,
refine 2, around the plain coarse vectors) and the whole
``me_fullsearch_pyramid`` on ``chip_smoke.py``'s ``pyramid_frames`` at
1080p and 4K.  Each case must equal the checkout's plain version byte for
byte.  For each it prints the call as the stream sees it (CUDA events,
median of 10 batches of 5 back-to-back calls) and the kernel's device time
(torch.profiler, mean over 60 launches), as one JSON line with the card's
name and power limit.  To compare two commits, run it for each on one
card, in turns (A, B, B, A).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

# chip_smoke.py imports the port only inside its functions, so the port
# these use is the checkout's at ROOT
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import (device_ms, motion_frames, pyramid_frames,  # noqa: E402
                        timed_ms)

SIZES = {"1080p": (1080, 1920, 1), "4K": (2160, 3840, 2)}
BLOCK, SEARCH, REFINE = 16, 64, 2


def exhaustive(motion, dev, out):
    # the kernel's name as the profiler shows it: one per metric, or the
    # one template of commits before the kernels were split
    names = getattr(motion, "KERNELS", dict.fromkeys(motion.METRICS,
                                                     "motion_search_kernel"))
    for res, (h, w, seed) in SIZES.items():
        cur, ref = motion_frames(h, w, seed, dev)
        for metric in motion.METRICS:
            def call(metric=metric):
                return motion.me_fullsearch(cur, ref, BLOCK, SEARCH, metric)
            want = motion.me_fullsearch_torch(cur, ref, BLOCK, SEARCH, metric)
            if not torch.equal(call(), want):
                raise SystemExit(f"{metric} {res}: the kernel differs from the "
                                 "plain version")
            out[f"{metric} {res}"] = {
                "ms": timed_ms(call, reps=10, batch=5, warmup=2),
                "device_ms": device_ms(call, names[metric])}


def pyramid(motion, dev, out):
    for res, (h, w, _seed) in SIZES.items():
        cur, ref = pyramid_frames(h, w, 17, dev)
        stride = motion.coarse_stride(w)
        # the coarse stage's kernel: its own since the stride-2 grid got one,
        # before that the SSD kernel's coarse mode
        coarse_kernel = getattr(motion, "COARSE_KERNELS",
                                {stride: "motion_ssd_kernel"})[stride].split()[0]
        raw = motion.me_coarse_torch(cur, ref, BLOCK, SEARCH, stride)

        def coarse():
            return motion.me_coarse(cur, ref, BLOCK, SEARCH, stride)

        def refine():
            return motion.me_refine(cur, ref, raw, BLOCK, SEARCH, REFINE, "ssd")

        def whole():
            return motion.me_fullsearch_pyramid(cur, ref, BLOCK, SEARCH, REFINE,
                                                "ssd")
        plain = {"coarse": raw,
                 "refine": motion.refine_torch(cur, ref, raw, BLOCK, SEARCH,
                                               REFINE, "ssd"),
                 "pyramid": motion.me_fullsearch_pyramid_torch(
                     cur, ref, BLOCK, SEARCH, REFINE, "ssd")}
        for stage, fn, kernel in (("coarse", coarse, coarse_kernel),
                                  ("refine", refine, "motion_refine_kernel"),
                                  ("pyramid", whole, None)):
            if not torch.equal(fn(), plain[stage]):
                raise SystemExit(f"{stage} {res}: the kernels differ from the "
                                 "plain version")
            row = {"ms": timed_ms(fn, reps=10, batch=5, warmup=2)}
            if kernel:
                row["device_ms"] = device_ms(fn, kernel)
            out[f"{stage} {res}"] = row


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    ap = argparse.ArgumentParser()
    ap.add_argument("root")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    from swiftvideo_tpu_torch.ops import motion
    if not Path(motion.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"imported {motion.__file__}, not the checkout at {root}")
    motion.build()
    dev = torch.device("cuda", 0)
    out = {}
    exhaustive(motion, dev, out)
    if hasattr(motion, "me_coarse"):
        pyramid(motion, dev, out)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"root": str(root), "group": getattr(motion, "GROUP", None),
                      "card": smi, "motion": out}))


if __name__ == "__main__":
    main()
