"""Multiview wall example on the PyTorch/CUDA port: nine 1080p cameras
tiled onto one 1080p program output, each with a translucent RGBA label.

The flow of ``examples/multiview_demo.py``: all 18 sources go to the
registry's composite in one call, which on the card is one launch of the
frame kernel (cameras and labels in the same launch); on the CPU the plain
torch version computes the same frame.  The wall is written as a PNG.

Run: python examples/torch_multiview_demo.py [out_dir]
(on the CUDA card; ``SV_DEVICE=cpu`` runs the plain torch versions)
"""

import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from swiftvideo_tpu_torch.cli import compute_context, rgba_frame, write_png
from swiftvideo_tpu_torch.media import (BufferType, PixelFormat,
                                        create_picture_sample)
from swiftvideo_tpu_torch.ops import frame, rect_uniforms, registry


def camera(seed: int, w: int, h: int):
    y, x = np.mgrid[0:h, 0:w]
    return [((x * (seed + 1) // 8 + y // 4) % 200 + 28).astype(np.uint8),
            np.full((h // 2, w // 2), 128 + (seed % 5) * 18, np.uint8),
            np.full((h // 2, w // 2), 128 - (seed % 7) * 12, np.uint8)]


def label(seed: int, w: int, h: int):
    """A tinted translucent strip standing in for a TextRenderer label."""
    a = np.zeros((h, w, 4), np.uint8)
    a[..., seed % 3] = 230
    a[..., 3] = 200
    return [a]


def main(out_dir: str = os.path.join(tempfile.gettempdir(),
                                     "torch_multiview_demo")) -> None:
    os.makedirs(out_dir, exist_ok=True)
    ctx = compute_context()
    W, H = 1920, 1080
    tw, th = W // 3, H // 3

    def dev(planes):
        return [torch.from_numpy(p).to(ctx.device) for p in planes]

    srcs = []
    for s in range(9):
        x, y = (s % 3) * tw, (s // 3) * th
        srcs.append((dev(camera(s, W, H)), PixelFormat.y420p,
                     rect_uniforms((W, H), (W, H), x=x + 0.4, y=y + 0.3,
                                   w=tw, h=th, opacity=1.0)))
        srcs.append((dev(label(s, tw, 32)), PixelFormat.RGBA,
                     rect_uniforms((tw, 32), (W, H), x=x + 8.3,
                                   y=y + th - 40.7, w=tw - 16, h=32,
                                   opacity=0.85)))
    launches = frame.launches
    planes = registry.composite_frame(ctx, PixelFormat.y420p, (W, H), srcs)
    print("composited 3x3 wall:", [tuple(p.shape) for p in planes],
          "path:", f"kernel ({frame.launches - launches} launch)"
          if ctx.kind == "cuda" else "plain torch")
    wall = create_picture_sample((W, H), PixelFormat.y420p, asset_id="wall",
                                 workspace_id="demo")
    wall = wall.with_(img=wall.img.with_buffers(
        planes, BufferType.gpu if ctx.kind == "cuda" else BufferType.cpu))
    path = os.path.join(out_dir, "wall.png")
    write_png(path, rgba_frame(ctx, wall))
    print("wrote", path)


if __name__ == "__main__":
    main(*sys.argv[1:2])
