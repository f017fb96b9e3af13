"""Transcoding example on the PyTorch/CUDA port: file source -> transcode
-> publish.  The flow of ``examples/transcoding_demo.py``; the codecs run
on the host.

Role parity with Examples/Transcoding/main.swift: a paced
FileSource feeds a coded bus; media-type filters route video/audio through
transcoders into a publisher (collected locally here; swap the sink for an
Rtmp/Flavor publisher for network output).

Run: python examples/torch_transcoding_demo.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from swiftvideo_tpu_torch.codec import (SyntheticSource, VideoEncoder,
                                  make_video_transcoder)
from swiftvideo_tpu_torch.core import Bus, EventBox, StepClock, TimePoint, Tx, mix
from swiftvideo_tpu_torch.media import (MediaFormat, MediaType, PixelFormat,
                                  create_picture_sample, media_type_filter)


def main() -> None:
    clock = StepClock(TimePoint(100, 1000))
    coded_bus = Bus(clock)
    outputs = []
    publisher = Tx(lambda s: (outputs.append(s), EventBox.just(s))[1])
    chain = coded_bus.subscribe(
        media_type_filter(MediaType.video)
        >> make_video_transcoder("file.out", MediaFormat.uncompressed)
        >> publisher)

    enc = VideoEncoder(MediaFormat.uncompressed)

    def puller(i):
        if i >= 30:
            return None
        pict = create_picture_sample((320, 180), PixelFormat.y420p,
                                     asset_id="file", workspace_id="demo")
        pict.planes()[0][:] = (i * 8) % 256
        return enc(pict).value()

    src = SyntheticSource(clock, puller, frame_duration=TimePoint(100, 1000),
                          asset_id="file")
    pipe = src >> mix() >> coded_bus
    src.play()
    for _ in range(60):
        clock.step()
    print(f"transcoded {len(outputs)} samples; "
          f"asset={outputs[0].asset_id() if outputs else None}, "
          f"provenance={[c.id_asset for c in outputs[0].constituents()] if outputs else None}")


if __name__ == "__main__":
    main()
