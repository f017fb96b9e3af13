"""Mixing example on the PyTorch/CUDA port: synthetic sources composited by
a Composer, the last frame written as a PNG.

The flow of ``examples/mixing_demo.py``: sources feed a picture bus, a
Composer binds them to scene elements, the VideoMixer emits composited
frames (one frame-kernel launch a tick on the card), and the last one goes
to RGBA through the registry's ``img_y420p_rgba`` kernel.

Run: python examples/torch_mixing_demo.py [out_dir]
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


def synthetic_source(name: str, size, pattern: int):
    s = create_picture_sample(size, PixelFormat.y420p, asset_id=name,
                              workspace_id="demo")
    y, x = np.mgrid[0:size[1], 0:size[0]]
    s.planes()[0][:] = ((x * (pattern + 1) + y) % 256).astype(np.uint8)
    s.planes()[1][:] = 128 + pattern * 30
    s.planes()[2][:] = 128 - pattern * 30
    return s


def main(out_dir: str = os.path.join(tempfile.gettempdir(),
                                     "torch_mixing_demo")) -> None:
    os.makedirs(out_dir, exist_ok=True)
    ctx = compute_context()
    clock = StepClock(TimePoint(480, 48000))  # 10 ms steps
    audio_bus = Bus(clock)
    picture_bus = Bus(clock)
    comp = Composition(
        name="demo", canvas_size=(640, 360),
        frame_duration=TimePoint(1000, 30000),
        audio_frame_duration=TimePoint(480, 48000),
        scenes=(Scene(name="main", elements=(
            Element(name="background", initial_state=ElementState(
                pic_pos=(0, 0), size=(640, 360))),
            Element(name="pip", initial_state=ElementState(
                pic_pos=(400, 20), size=(220, 124)), z_index=1),
        )),),
        initial_scene="main")
    composer = Composer(clock, workspace_id="demo", composition=comp,
                        audio_bus=audio_bus, picture_bus=picture_bus,
                        compute_context=ctx)
    frames = []
    sub = picture_bus.subscribe(Tx(  # noqa: F841 (weak emit chain)
        lambda s: (frames.append(s), EventBox.just(s))[1]
        if s.asset_id() == "demo" else EventBox.nothing(None)))
    composer.bind("camA", "background")
    composer.bind("camB", "pip")
    picture_bus.append(EventBox.just(synthetic_source("camA", (320, 180), 0)))
    picture_bus.append(EventBox.just(synthetic_source("camB", (160, 90), 2)))
    for _ in range(40):
        clock.step()
    composer.close()
    print(f"mixed {len(frames)} frames on {ctx.device}")
    if frames:
        rgba = rgba_frame(ctx, frames[-1])
        path = os.path.join(out_dir, "frame.png")
        write_png(path, rgba)
        print("wrote", path, rgba.shape)


if __name__ == "__main__":
    main(*sys.argv[1:2])
