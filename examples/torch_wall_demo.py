"""64-stream mixing wall on the PyTorch/CUDA port: one card (or the CPU).

The flow of ``examples/wall_demo.py``: 64 random 96x54 streams onto a
256x128 wall with their audio summed, on the plan path, then the wall
written as a PNG through the registry's ``img_y420p_rgba`` kernel.

Run: python examples/torch_wall_demo.py [out_png]
(on the CUDA card; ``SV_DEVICE=cpu`` runs the plain torch versions)
"""

import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(out: str = os.path.join(tempfile.gettempdir(),
                                 "torch_wall_demo.png")) -> None:
    import numpy as np

    from swiftvideo_tpu_torch.cli import compute_context, rgba_frame, write_png
    from swiftvideo_tpu_torch.media import (BufferType, PixelFormat,
                                            create_picture_sample)
    from swiftvideo_tpu_torch.parallel import MixingWall

    ctx = compute_context()
    wall = MixingWall(n_streams=64, stream_size=(96, 54),
                      canvas_size=(256, 128), audio_samples=48,
                      device=ctx.device)
    rng = np.random.default_rng(0)
    ys = wall.shard(rng.integers(0, 256, (64, 54, 96),
                                 np.int64).astype(np.uint8))
    us = wall.shard(np.full((64, 27, 48), 128, np.uint8))
    vs = wall.shard(np.full((64, 27, 48), 128, np.uint8))
    audio = wall.shard(np.full((64, 96), 25, np.int16))
    wy, wu, wv, mixed = wall.step(ys, us, vs, audio)
    print("wall:", tuple(wy.shape), "on", wy.device)
    print("mixed audio head:", mixed.cpu().numpy()[:4], "(expect 25*64=1600)")
    sample = create_picture_sample((wy.shape[1], wy.shape[0]),
                                   PixelFormat.y420p, asset_id="wall",
                                   workspace_id="demo")
    sample = sample.with_(img=sample.img.with_buffers(
        [wy, wu, wv], BufferType.gpu if ctx.kind == "cuda" else BufferType.cpu))
    write_png(out, rgba_frame(ctx, sample))
    print("wrote", out)


if __name__ == "__main__":
    main(*sys.argv[1:2])
