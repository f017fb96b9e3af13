"""Rotating-element example on the PyTorch/CUDA port: an animated rotation
through the Composer.

The flow of ``examples/rotation_demo.py``: PictureAnimator lerps the
element's rotation, and the frame kernel samples the rotated source exactly
(the port keeps no warp approximation).  The first and last frames are
written as PNGs.

Run: python examples/torch_rotation_demo.py [out_dir]
(on the CUDA card; ``SV_DEVICE=cpu`` runs the plain torch versions)
"""

import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from swiftvideo_tpu_torch.cli import compute_context, rgba_frame, write_png
from swiftvideo_tpu_torch.compose import (Composer, Composition, Element,
                                          ElementState, Scene)
from swiftvideo_tpu_torch.core import Bus, EventBox, StepClock, TimePoint, Tx
from swiftvideo_tpu_torch.media import PixelFormat, create_picture_sample


def smooth_source(name: str, size):
    s = create_picture_sample(size, PixelFormat.y420p, asset_id=name,
                              workspace_id="demo")
    y, x = np.mgrid[0:size[1], 0:size[0]]
    s.planes()[0][:] = np.clip(127 + 90 * np.sin(x / 23.0)
                               * np.cos(y / 17.0), 0, 255).astype(np.uint8)
    s.planes()[1][:] = 96
    s.planes()[2][:] = 170
    return s


def main(out_dir: str = os.path.join(tempfile.gettempdir(),
                                     "torch_rotation_demo")) -> None:
    os.makedirs(out_dir, exist_ok=True)
    ctx = compute_context()
    clock = StepClock(TimePoint(480, 48000))
    audio_bus = Bus(clock)
    picture_bus = Bus(clock)
    comp = Composition(
        name="demo", canvas_size=(640, 360),
        frame_duration=TimePoint(1000, 30000),
        audio_frame_duration=TimePoint(480, 48000),
        scenes=(Scene(name="main", elements=(
            Element(name="card", initial_state=ElementState(
                pic_pos=(160, 90), size=(320, 180), rotation=0.0)),
        )),),
        initial_scene="main")
    composer = Composer(clock, workspace_id="demo", composition=comp,
                        audio_bus=audio_bus, picture_bus=picture_bus,
                        compute_context=ctx)
    frames = []
    sub = picture_bus.subscribe(Tx(  # noqa: F841 (weak emit chain)
        lambda s: (frames.append(s), EventBox.just(s))[1]
        if s.asset_id() == "demo" else EventBox.nothing(None)))
    composer.bind("card-src", "card")
    picture_bus.append(EventBox.just(smooth_source("card-src", (320, 180))))
    # animate a half-second spin to 35 degrees
    composer.set_state("card", ElementState(
        pic_pos=(160, 90), size=(320, 180), rotation=0.6),
        duration=TimePoint(24000, 48000))
    for _ in range(60):
        clock.step()
    composer.close()
    print(f"mixed {len(frames)} frames (rotation animated) on {ctx.device}")
    for tag, f in (("first", frames[:1]), ("last", frames[-1:])):
        if f:
            path = os.path.join(out_dir, f"{tag}.png")
            write_png(path, rgba_frame(ctx, f[0]))
            print("wrote", path)


if __name__ == "__main__":
    main(*sys.argv[1:2])
