"""Twin of ``tests/test_live_station.py`` on the port, its Composer on the
CPU (the port's default device is the card), and pixel-exact: the probed
program pixels equal the cameras' luma and the clear background exactly.

Full live-mixing station over real sockets: RTMP ingest -> bitstream
decode -> Composer (mix) -> bitstream encode -> RTMP egress.

This is the reference's production topology end-to-end in one event loop
(Examples/RtmpServer ingest + composer.swift element chains + rtmp.swift
publish), with the codec legs running through the subprocess backend via
tests/mock_ffmpeg.py (lossless frame payloads, so the final assertion is
pixel-exact through FIVE hops: encode -> RTMP -> decode -> composite ->
encode -> RTMP -> decode).
"""

import asyncio
import os
import socket

import numpy as np
import pytest
import torch

from swiftvideo_tpu_torch.codec.codecs import (AudioDecoder, AudioEncoder,
                                         VideoDecoder, VideoEncoder)
from swiftvideo_tpu_torch.codec.transcode import flat
from swiftvideo_tpu_torch.compose import Composer
from swiftvideo_tpu_torch.core import Bus, EventBox, StepClock, TimePoint, Tx
from swiftvideo_tpu_torch.media import (MediaFormat, MediaType, PixelFormat,
                                  create_picture_sample)
from swiftvideo_tpu_torch.media.audio import AudioFormat, AudioSample
from swiftvideo_tpu_torch.ops import make_compute_context
from swiftvideo_tpu_torch.scene import Composition, Element, ElementState, Scene

MOCK_FFMPEG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "mock_ffmpeg.py")

TICK = TimePoint(480, 48000)           # 10 ms
FRAME = TimePoint(1000, 30000)         # 30 fps


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch ops here are many and small: one intra-op thread, so that an
    xdist worker sharing its cores with five others waits on no OpenMP
    barrier (with a thread per core a small op can wait a scheduler slice)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _encode_cam(luma: int, asset: str, n: int = 12):
    """Synthetic constant-luma 48x28 frames through the mock avc encoder."""
    enc = VideoEncoder(MediaFormat.avc)
    coded = []
    for i in range(n):
        pict = create_picture_sample((48, 28), PixelFormat.y420p,
                                     asset_id=asset, workspace_id="w")
        pict.planes()[0][:] = luma
        pict.planes()[1][:] = 128
        pict.planes()[2][:] = 128
        box = enc(pict.with_(pts=TimePoint(i * 33, 1000)))
        if box.is_just():
            v = box.value()
            coded.extend(v if isinstance(v, list) else [v])
    coded.extend(enc.flush())
    enc.close()
    assert len(coded) == n, f"{asset}: {len(coded)} coded frames"
    return coded


def _encode_cam_audio(amp: int, asset: str, n: int = 60):
    """Constant-amplitude 1024-sample stereo AAC packets via the mock."""
    enc = AudioEncoder(MediaFormat.aac, frame_size=1024)
    coded = []
    for i in range(n):
        pcm = np.full(1024 * 2, amp, np.int16)
        box = enc(AudioSample(
            buffers=(pcm,), frequency=48000, channels=2,
            format=AudioFormat.s16i, sample_count=1024,
            id_asset=asset, id_workspace="w",
            pts_value=TimePoint(i * 1024, 48000)))
        if box.is_just():
            v = box.value()
            coded.extend(v if isinstance(v, list) else [v])
    for s in enc.flush():
        coded.append(s)
    enc.close()
    assert len(coded) >= n - 2, f"{asset}: {len(coded)} coded audio packets"
    return coded


@pytest.fixture
def mock_ffmpeg(monkeypatch):
    monkeypatch.setenv("SWIFTVIDEO_FFMPEG", MOCK_FFMPEG)
    return MOCK_FFMPEG


def test_live_station_rtmp_mix_rtmp(mock_ffmpeg):
    from swiftvideo_tpu_torch.net.rtmp import Rtmp

    cam1 = _encode_cam(60, "cam1", 40)
    cam2 = _encode_cam(180, "cam2", 40)
    cam1_a = _encode_cam_audio(1000, "cam1")
    cam2_a = _encode_cam_audio(3000, "cam2")

    comp = Composition(
        name="program", canvas_size=(96, 56), frame_duration=FRAME,
        audio_frame_duration=TICK, sample_rate=48000, channel_count=2,
        scenes=(Scene(name="main", elements=(
            Element(name="left", z_index=0,
                    initial_state=ElementState(pic_pos=(0, 0),
                                               size=(48, 28))),
            Element(name="right", z_index=1,
                    initial_state=ElementState(pic_pos=(48, 28),
                                               size=(48, 28))),
        )),), initial_scene="main")

    port_in, port_out = _free_port(), _free_port()
    received = []            # mixed CodedMediaSamples arriving at egress

    async def run():
        clock = StepClock(TICK)
        audio_bus, picture_bus = Bus(clock), Bus(clock)
        composer = Composer(clock, workspace_id="w", composition=comp,
                            audio_bus=audio_bus, picture_bus=picture_bus,
                            compute_context=make_compute_context("cpu"))
        keep = []            # anchor weak emit chains
        decoders = []

        # --- ingest server: decode each publisher onto the A/V buses -----
        async def on_ingest(pub, sub):
            if sub is not None:
                name = sub.play_path()           # "cam1" / "cam2"
                vdec, adec = VideoDecoder(), AudioDecoder()
                decoders.extend([vdec, adec])

                def route(s, name=name, vdec=vdec, adec=adec):
                    if s.media_type == MediaType.audio:
                        box, bus = adec(s), audio_bus
                    else:
                        box, bus = vdec(s), picture_bus
                    if box.is_just():
                        v = box.value()
                        for item in (v if isinstance(v, list) else [v]):
                            bus.append(EventBox.just(
                                item.with_(asset_id=name)))
                    return EventBox.nothing(None)

                keep.append(sub >> Tx(route))
            return True

        ingest = Rtmp(clock, on_connection=on_ingest)
        await ingest.serve("127.0.0.1", port_in)

        # --- egress server: collect the mixed program stream --------------
        async def on_egress(pub, sub):
            if sub is not None:
                keep.append(sub >> Tx(
                    lambda s: (received.append(s),
                               EventBox.nothing(None))[1]))
            return True

        egress = Rtmp(clock, on_connection=on_egress)
        await egress.serve("127.0.0.1", port_out)

        # --- program output: composited frames -> encoder -> publisher ----
        out_client = Rtmp(clock)
        out_pub, _ = await out_client.connect(
            f"rtmp://127.0.0.1:{port_out}/live/program",
            publish_to_peer=True, max_attempts=3, retry_delay=0.2)
        out_enc = VideoEncoder(MediaFormat.avc)

        def to_egress(sample):
            out_pub.apply(EventBox.just(sample))
            return EventBox.nothing(None)

        from swiftvideo_tpu_torch.core import asset_filter
        keep.append(picture_bus.subscribe(
            asset_filter(comp.name) >> flat(out_enc) >> flat(Tx(to_egress))))
        out_aenc = AudioEncoder(MediaFormat.aac, frame_size=1024)
        keep.append(audio_bus.subscribe(
            asset_filter(comp.name) >> flat(out_aenc) >> flat(Tx(to_egress))))

        composer.bind("cam1", "left")
        composer.bind("cam2", "right")

        # --- publishers: feed the pre-encoded cams into ingest ------------
        pubs = []
        for name, coded, coded_a in (("cam1", cam1, cam1_a),
                                     ("cam2", cam2, cam2_a)):
            client = Rtmp(clock)
            pub, _ = await client.connect(
                f"rtmp://127.0.0.1:{port_in}/live/{name}",
                publish_to_peer=True, max_attempts=3, retry_delay=0.2)
            pubs.append((pub, coded, coded_a, [0]))

        # publishers drop media until their 200 ms (clock-time) metadata
        # grace timer fires (live semantics) — step past it first
        for _ in range(24):
            clock.step()
            await asyncio.sleep(0)

        for i in range(40):
            for pub, coded, coded_a, aidx in pubs:
                pub.apply(EventBox.just(coded[i]))
                # audio packets (1024 samples = 21.3 ms) keeping pace with
                # the 33 ms video pts
                while (aidx[0] < len(coded_a)
                       and aidx[0] * 1024 * 1000 <= (i + 1) * 33 * 48000):
                    pub.apply(EventBox.just(coded_a[aidx[0]]))
                    aidx[0] += 1
            # ~3.3 clock ticks per 33 ms frame
            for _ in range(3):
                clock.step()
                await asyncio.sleep(0.002)

        # drain: decoder reader threads + mixer ticks + egress delivery
        def n_video():
            return sum(1 for s in received
                       if s.media_type == MediaType.video)

        def n_audio():
            return sum(1 for s in received
                       if s.media_type == MediaType.audio)

        deadline = asyncio.get_event_loop().time() + 25.0
        while ((n_video() < 20 or n_audio() < 10)
               and asyncio.get_event_loop().time() < deadline):
            clock.step()
            await asyncio.sleep(0.01)

        out_pub.close()
        for pub, _c, _a, _i in pubs:
            pub.close()
        await ingest.close()
        await egress.close()
        composer.close()
        for d in decoders:
            d.close()
        out_enc.close()
        out_aenc.close()

    asyncio.run(run())
    vids = [s for s in received if s.media_type == MediaType.video]
    auds = [s for s in received if s.media_type == MediaType.audio]
    assert len(vids) >= 20, f"only {len(vids)} mixed frames egressed"
    assert len(auds) >= 10, f"only {len(auds)} mixed audio packets egressed"
    received = vids

    # decode the LAST mixed frame (both cams live by then) and check the
    # composited regions pixel-exactly (mock codec is lossless)
    dec = VideoDecoder()
    frames = []
    for s in received:
        box = dec(s)
        if box.is_just():
            v = box.value()
            frames.extend(v if isinstance(v, list) else [v])
    frames.extend(dec.flush())
    dec.close()
    assert frames, "egress stream did not decode"
    last = frames[-1]
    y = np.asarray(last.planes()[0])
    assert y.shape == (56, 96)
    # interior probes (away from bilinear borders)
    assert int(y[10, 10]) == 60, y[10, 10]               # cam1 in "left"
    assert int(y[42, 70]) == 180, y[42, 70]              # cam2 in "right"
    assert int(y[10, 70]) == 0                           # background clear
    assert int(y[42, 10]) == 0

    # decode the mixed audio: once both cams are live the saturating mix
    # is exactly 1000 + 3000 (unity gains, centered pan on stereo)
    adec = AudioDecoder()
    pcm = []
    for s in auds:
        box = adec(s)
        if box.is_just():
            v = box.value()
            pcm.extend(np.asarray(a.buffers[0]) for a in
                       (v if isinstance(v, list) else [v]))
    pcm.extend(np.asarray(a.buffers[0]) for a in adec.flush())
    adec.close()
    assert pcm, "egress audio did not decode"
    allpcm = np.concatenate(pcm)
    # steady state: both cams at unity gain mix to exactly 1000 + 3000.
    # RTMP FLV tags quantize pts to MILLISECONDS, so 1024-sample packets
    # (21.33 ms) re-time to 21 ms on the wire and periodically overlap by
    # ~16 samples.  The reference's window-overlap semantics mix both
    # copies (brief audible doubling, mix.audio.swift:142-153); the
    # mixer's span dedup (dedup_overlap, default on) clips each packet
    # to the not-yet-mixed region, so NO doubled levels may appear —
    # only the exact mix and join/leave transients.
    tail = allpcm[-4096:]
    assert (tail == 4000).mean() > 0.9, (tail == 4000).mean()
    assert set(np.unique(tail)) <= {0, 1000, 3000, 4000}, np.unique(tail)
