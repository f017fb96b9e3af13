"""Live mixing station on the PyTorch/CUDA port: RTMP ingest -> decode ->
Composer -> encode -> RTMP.  The flow of ``examples/live_station_demo.py``;
the Composer mixes on the CUDA card (``SV_DEVICE=cpu``: the plain torch
versions), the codecs and the network run on the host.

The reference's production topology in one process (Examples/RtmpServer
ingest + composer.swift element chains + rtmp.swift publish): two loopback
cameras publish AVC+AAC over RTMP, the station decodes them onto the media
buses, a Composer mixes picture-in-picture video and sums the audio, and
the mixed program re-encodes and publishes to a second RTMP server, which
writes what it receives.

Run: SWIFTVIDEO_FFMPEG=tests/mock_ffmpeg.py python examples/torch_live_station_demo.py
(or with a real ffmpeg binary on PATH for real codecs).
"""

import asyncio
import os
import socket
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from swiftvideo_tpu_torch.cli import compute_context
from swiftvideo_tpu_torch.codec.codecs import (AudioDecoder, AudioEncoder,
                                         VideoDecoder, VideoEncoder)
from swiftvideo_tpu_torch.codec.transcode import flat
from swiftvideo_tpu_torch.compose import Composer
from swiftvideo_tpu_torch.core import (Bus, EventBox, StepClock, TimePoint, Tx,
                                 asset_filter)
from swiftvideo_tpu_torch.media import (MediaFormat, MediaType, PixelFormat,
                                  create_picture_sample)
from swiftvideo_tpu_torch.media.audio import AudioFormat, AudioSample
from swiftvideo_tpu_torch.net.rtmp import Rtmp
from swiftvideo_tpu_torch.scene import Composition, Element, ElementState, Scene

TICK = TimePoint(480, 48000)
FRAME = TimePoint(1000, 30000)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def encode_cam(luma: int, asset: str, n: int):
    """Moving-gradient frames + a tone through the codec layer."""
    venc = VideoEncoder(MediaFormat.avc)
    aenc = AudioEncoder(MediaFormat.aac, frame_size=1024)
    video, audio = [], []
    ramp = np.arange(64, dtype=np.uint8)
    for i in range(n):
        pict = create_picture_sample((64, 36), PixelFormat.y420p,
                                     asset_id=asset, workspace_id="demo")
        pict.planes()[0][:] = np.roll(
            np.minimum(255, luma + ramp), i)[None, :]
        pict.planes()[1][:] = 128
        pict.planes()[2][:] = 128
        box = venc(pict.with_(pts=TimePoint(i * 33, 1000)))
        if box.is_just():
            v = box.value()
            video.extend(v if isinstance(v, list) else [v])
        pcm = (np.sin(np.arange(i * 1024, (i + 1) * 1024) * 0.05)
               * 4000).astype(np.int16).repeat(2)
        abox = aenc(AudioSample(buffers=(pcm,), frequency=48000, channels=2,
                                format=AudioFormat.s16i, sample_count=1024,
                                id_asset=asset, id_workspace="demo",
                                pts_value=TimePoint(i * 1024, 48000)))
        if abox.is_just():
            v = abox.value()
            audio.extend(v if isinstance(v, list) else [v])
    video.extend(venc.flush())
    venc.close()
    aenc.close()
    return video, audio


async def main() -> None:
    clock = StepClock(TICK)
    audio_bus, picture_bus = Bus(clock), Bus(clock)
    comp = Composition(
        name="program", canvas_size=(128, 72), frame_duration=FRAME,
        audio_frame_duration=TICK, sample_rate=48000, channel_count=2,
        scenes=(Scene(name="main", elements=(
            Element(name="full", z_index=0,
                    initial_state=ElementState(size=(128, 72))),
            Element(name="pip", z_index=1,
                    initial_state=ElementState(pic_pos=(84, 8),
                                               size=(36, 20))),
        )),), initial_scene="main")
    composer = Composer(clock, workspace_id="demo", composition=comp,
                        audio_bus=audio_bus, picture_bus=picture_bus,
                        compute_context=compute_context())
    keep, decoders, received = [], [], []

    async def on_ingest(pub, sub):
        if sub is not None:
            name = sub.play_path()
            vdec, adec = VideoDecoder(), AudioDecoder()
            decoders.extend([vdec, adec])

            def route(s, name=name, vdec=vdec, adec=adec):
                box, bus = ((adec(s), audio_bus)
                            if s.media_type == MediaType.audio
                            else (vdec(s), picture_bus))
                if box.is_just():
                    v = box.value()
                    for item in (v if isinstance(v, list) else [v]):
                        bus.append(EventBox.just(item.with_(asset_id=name)))
                return EventBox.nothing(None)

            keep.append(sub >> Tx(route))
            print(f"[station] ingest: {name}")
        return True

    async def on_egress(pub, sub):
        if sub is not None:
            keep.append(sub >> Tx(
                lambda s: (received.append(s), EventBox.nothing(None))[1]))
            print("[monitor] program stream attached")
        return True

    port_in, port_out = free_port(), free_port()
    ingest = Rtmp(clock, on_connection=on_ingest)
    await ingest.serve("127.0.0.1", port_in)
    egress = Rtmp(clock, on_connection=on_egress)
    await egress.serve("127.0.0.1", port_out)

    out_pub, _ = await (Rtmp(clock)).connect(
        f"rtmp://127.0.0.1:{port_out}/live/program",
        publish_to_peer=True, max_attempts=3, retry_delay=0.2)
    venc = VideoEncoder(MediaFormat.avc)
    aenc = AudioEncoder(MediaFormat.aac, frame_size=1024)

    def to_egress(s):
        out_pub.apply(EventBox.just(s))
        return EventBox.nothing(None)

    keep.append(picture_bus.subscribe(
        asset_filter(comp.name) >> flat(venc) >> flat(Tx(to_egress))))
    keep.append(audio_bus.subscribe(
        asset_filter(comp.name) >> flat(aenc) >> flat(Tx(to_egress))))

    composer.bind("cam1", "full")
    composer.bind("cam2", "pip")

    pubs = []
    for name, luma in (("cam1", 40), ("cam2", 160)):
        video, audio = encode_cam(luma, name, 60)
        pub, _ = await (Rtmp(clock)).connect(
            f"rtmp://127.0.0.1:{port_in}/live/{name}",
            publish_to_peer=True, max_attempts=3, retry_delay=0.2)
        pubs.append((pub, video, audio, [0]))

    for _ in range(24):                   # publisher metadata grace (200 ms)
        clock.step()
        await asyncio.sleep(0)
    for i in range(60):
        for pub, video, audio, aidx in pubs:
            pub.apply(EventBox.just(video[i]))
            while (aidx[0] < len(audio)
                   and aidx[0] * 1024 * 1000 <= (i + 1) * 33 * 48000):
                pub.apply(EventBox.just(audio[aidx[0]]))
                aidx[0] += 1
        for _ in range(3):
            clock.step()
            await asyncio.sleep(0.002)
    deadline = asyncio.get_event_loop().time() + 20.0
    while (sum(s.media_type == MediaType.video for s in received) < 30
           and asyncio.get_event_loop().time() < deadline):
        clock.step()
        await asyncio.sleep(0.01)

    nv = sum(s.media_type == MediaType.video for s in received)
    na = sum(s.media_type == MediaType.audio for s in received)
    print(f"[monitor] received {nv} mixed video frames, {na} audio packets")
    out_pub.close()
    for pub, _v, _a, _i in pubs:
        pub.close()
    await ingest.close()
    await egress.close()
    composer.close()
    for d in decoders:
        d.close()
    venc.close()
    aenc.close()
    if not (nv >= 30 and na >= 10):
        raise SystemExit("station did not produce a program stream")
    print("[station] ok")


if __name__ == "__main__":
    os.environ.setdefault(
        "SWIFTVIDEO_FFMPEG",
        os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "tests", "mock_ffmpeg.py"))
    asyncio.run(main())
