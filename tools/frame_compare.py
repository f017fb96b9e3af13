"""Time the frame composite of one checkout of the port on a CUDA card.

    python tools/frame_compare.py ROOT

Imports ``swiftvideo_tpu_torch`` from the checkout at ROOT (this repo, or
an unpacked ``git archive`` of another commit), builds its frame kernels,
and runs ``frame.composite_frame_cuda`` on ``chip_smoke.py``'s live-station
stack (``live_stack``, same seed): K1 (cameras), K2 (lower third), K1+K2
(both) onto a 1080p y420p target, K3 (both) onto a 1080p RGBA target, and
``up2``, a 960x540 y420p camera upscaled 2x onto the whole 1080p canvas
(the case where a tile re-reads texels most).  Each case must equal the
checkout's plain version bit for bit.  For each it prints the call as the
stream sees it (CUDA events, median of 20 batches of 10 back-to-back
calls), the kernel's device time (torch.profiler, mean over 60 launches)
and the host microseconds per call (``chip_smoke.py``'s helpers), as one
JSON line with the card's name and power limit.  To compare two commits,
run it for each on one card, in turns (A, B, B, A).
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
from chip_smoke import (W, H, camera_planes, device_ms, host_us,  # noqa: E402
                        live_stack, timed_ms)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    root = Path(sys.argv[1]).resolve()
    sys.path.insert(0, str(root))
    from swiftvideo_tpu_torch.media import PixelFormat as PF
    from swiftvideo_tpu_torch.ops import composite, frame
    from swiftvideo_tpu_torch.ops.uniforms import rect_uniforms
    if not Path(frame.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"imported {frame.__file__}, not the checkout at {root}")
    frame.build()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    cams, ovs = live_stack(rng, dev)
    up = [([torch.from_numpy(p).to(dev) for p in camera_planes(rng, 1, 960, 540)[0]],
           PF.y420p, rect_uniforms((960, 540), (W, H), x=0, y=0, w=W, h=H))]
    cases = {"K1": (cams, PF.y420p), "K2": (ovs, PF.y420p),
             "K1+K2": (cams + ovs, PF.y420p), "K3": (cams + ovs, PF.RGBA),
             "up2": (up, PF.y420p)}
    out = {}
    for name, (srcs, fmt) in cases.items():
        def call(srcs=srcs, fmt=fmt):
            return frame.composite_frame_cuda((W, H), srcs, fmt)
        ref = composite.composite_stack_torch(fmt, (W, H), srcs, dev)
        if not all(torch.equal(g, r) for g, r in zip(call(), ref)):
            raise SystemExit(f"{name}: the kernel differs from the plain version")
        kernel = ("frame_composite_rgba_kernel" if fmt == PF.RGBA
                  else "frame_composite_kernel")
        out[name] = {"ms": timed_ms(call), "device_ms": device_ms(call, kernel),
                     "host_us": host_us(call)}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"root": str(root), "card": smi, "frame": out}))


if __name__ == "__main__":
    main()
