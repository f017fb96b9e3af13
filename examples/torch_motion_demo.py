"""Motion estimation demo on the PyTorch/CUDA port: recover the motion
field of a panning scene.

The flow of ``examples/motion_demo.py``: both search metrics on a
synthetic translating texture, printing the dominant motion vector:

* ``metric="sad"``: exact integer SAD, scan-order ties (K4's kernel on the
  card);
* ``metric="ssd"``: the SSD search with its cross term on the int8 tensor
  cores (K5's kernel on the card).

Run: python examples/torch_motion_demo.py
(on the CUDA card; ``SV_DEVICE=cpu`` runs the plain torch versions)
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def main() -> None:
    from swiftvideo_tpu_torch.cli import compute_context
    from swiftvideo_tpu_torch.ops import motion

    ctx = compute_context()
    rng = np.random.default_rng(7)
    h, w, shift = 128, 256, 5
    ref = rng.integers(0, 255, (h, w), np.uint8)
    cur = np.roll(ref, (shift, shift), axis=(0, 1))   # camera pans by +5,+5
    cur_t, ref_t = (torch.from_numpy(a).to(ctx.device) for a in (cur, ref))

    for metric in ("sad", "ssd"):
        mvs = motion.me_fullsearch(cur_t, ref_t, 16, 64, metric).cpu().numpy()
        # decode the normalized RGBA motion field (r=mvx, b=mvy)
        max_mv = 32
        mvx = (mvs[..., 0].astype(np.float32) / 255.0 - 0.5) * 2 * max_mv
        mvy = (mvs[..., 2].astype(np.float32) / 255.0 - 0.5) * 2 * max_mv
        inner = (slice(2, -2), slice(2, -2))          # clamped-window edges
        print(f"{metric}: dominant mv = "
              f"({np.median(mvx[inner]):+.1f}, {np.median(mvy[inner]):+.1f})"
              f"  [expected (+{shift}.0, +{shift}.0)]  "
              f"field {mvs.shape[1]}x{mvs.shape[0]} blocks on {ctx.device}")
        if not (abs(np.median(mvx[inner]) - shift) < 0.6
                and abs(np.median(mvy[inner]) - shift) < 0.6):
            raise SystemExit(f"{metric}: the pan was not recovered")
    print("motion demo OK")


if __name__ == "__main__":
    main()
