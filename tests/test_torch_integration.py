"""Twin of ``tests/test_integration.py`` on the port (``swiftvideo_tpu_torch``): the same
cases, with free ports in place of the fixed ones.

Cross-layer integration: RTMP ingest -> bus -> transcode -> flavor relay,
all over real sockets in one event loop — the reference's
Examples/Transcoding topology with a flavor egress leg."""

import asyncio
import socket

import numpy as np

from swiftvideo_tpu_torch.codec import VideoEncoder, make_video_transcoder
from swiftvideo_tpu_torch.core import Bus, EventBox, StepClock, TimePoint, Tx, mix
from swiftvideo_tpu_torch.media import (CodedMediaSample, MediaFormat, MediaType,
                                  PixelFormat, create_picture_sample,
                                  media_type_filter)
from swiftvideo_tpu_torch.net import flavor as fl
from swiftvideo_tpu_torch.net.rtmp import Rtmp


def _free_port() -> int:
    """A port no test of another worker holds (the JAX twins' fixed ports
    may be bound by a concurrent worker)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


async def _run(rtmp_port: int, flavor_port: int):
    clock = StepClock(TimePoint(16, 1000))
    coded_bus = Bus(clock)

    # flavor egress: server that collects relayed media
    relayed = []
    keep = []

    def on_subscriber(sub):
        keep.append(sub)
        keep.append(sub >> Tx(lambda s: (relayed.append(s),
                                         EventBox.nothing(None))[1]))

    flavor_server = fl.Flavor(on_subscriber=on_subscriber)
    await flavor_server.serve("127.0.0.1", flavor_port)
    flavor_client = fl.Flavor()
    flavor_pub = await flavor_client.connect(
        f"flavor://127.0.0.1:{flavor_port}/relay", push=True)

    # rtmp ingest: server subscribes published media into the coded bus
    ingest_chains = []

    async def on_connection(pub, sub):
        if sub is not None:
            ingest_chains.append(sub >> mix() >> coded_bus)
        return True

    rtmp_server = Rtmp(clock, on_connection=on_connection)
    await rtmp_server.serve("127.0.0.1", rtmp_port)

    # bus -> flavor relay (uncompressed passthrough: no bitstream codecs in
    # this image, so relay the coded AVC samples as-is)
    relay_chain = coded_bus.subscribe(
        media_type_filter(MediaType.video) >> flavor_pub)

    # rtmp publisher pushes synthetic AVC samples
    rtmp_client = Rtmp(clock)
    pub, _ = await rtmp_client.connect(
        f"rtmp://127.0.0.1:{rtmp_port}/app/cam", max_attempts=2,
        retry_delay=0.2)
    for _ in range(14):  # metadata grace timer (13 x 16 ms)
        clock.step()
        await asyncio.sleep(0)
    rng = np.random.default_rng(0)
    sent = []
    for i in range(30):
        payload = bytearray(rng.integers(0, 256, 2000, np.int64)
                            .astype(np.uint8).tobytes())
        payload[4] = 0x65
        sample = CodedMediaSample(
            buffer=bytes(payload), pts_value=TimePoint(i * 16, 1000),
            dts_value=TimePoint(i * 16, 1000), media_type=MediaType.video,
            media_format=MediaFormat.avc, id_asset="cam",
            side={"config": bytes(48)})
        box = pub.apply(EventBox.just(sample))
        if not box.is_error():
            sent.append(sample)
        clock.step()
        await asyncio.sleep(0)
    for _ in range(80):
        await asyncio.sleep(0.01)
        if len(relayed) >= len(sent):
            break
    pub.close()
    flavor_pub.close()
    await rtmp_server.close()
    await flavor_server.close()
    return sent, relayed


def test_rtmp_to_flavor_relay():
    sent, relayed = asyncio.run(_run(_free_port(), _free_port()))
    assert len(sent) > 25
    assert len(relayed) == len(sent)
    for s, r in zip(sent, relayed):
        assert r.data() == s.data()
        assert r.media_format == MediaFormat.avc


def test_bus_granularity_batches():
    """Granularity batching holds events until the window elapses
    (bus.swift:62-109)."""
    clock = StepClock(TimePoint(10, 1000))
    bus = Bus(clock)
    bus.set_granularity(TimePoint(30, 1000))
    seen = []
    sub = bus.subscribe(Tx(lambda e: (seen.append(e), EventBox.just(e))[1]))

    class E:
        def type(self): return "e"
        def time(self): return clock.current()
        def asset_id(self): return "a"
        def workspace_id(self): return "w"
        def workspace_token(self): return None
        def info(self): return None

    bus.append(EventBox.just(E()))   # t=0: 0-0=0 < 30 -> queued
    assert len(seen) == 0
    clock.step()                     # t=10
    bus.append(EventBox.just(E()))
    assert len(seen) == 0
    clock.step(); clock.step()       # t=30: window elapsed -> scheduled
    assert len(seen) == 2            # flush delivers the batch
    bus.append(EventBox.just(E()))   # t=30: new window -> queued
    assert len(seen) == 2
    clock.step(); clock.step(); clock.step()   # t=60
    assert len(seen) == 3
    assert bus.events_out == 3


def test_bus_granularity_tail_flush():
    """Beyond reference: a burst's tail must not stall in the queue when
    the producer goes quiet (bus.swift:81-109 only flushes on a LATER
    append) — the window-boundary clock flush delivers it."""
    clock = StepClock(TimePoint(10, 1000))
    bus = Bus(clock)
    bus.set_granularity(TimePoint(30, 1000))
    seen = []
    sub = bus.subscribe(Tx(lambda e: (seen.append(e), EventBox.just(e))[1]))

    class E:
        def type(self): return "e"
        def time(self): return clock.current()
        def asset_id(self): return "a"
        def workspace_id(self): return "w"
        def workspace_token(self): return None
        def info(self): return None

    for _ in range(3):               # burst at t=0, then silence
        bus.append(EventBox.just(E()))
    assert len(seen) == 0
    clock.step(); clock.step()       # t=20: window not elapsed
    assert len(seen) == 0
    clock.step()                     # t=30: scheduled flush fires
    assert len(seen) == 3
    clock.step(); clock.step(); clock.step()
    assert len(seen) == 3            # no re-fire, no duplicates


def test_protocol_cores_survive_garbage():
    """Random bytes must never raise out of the session cores (the
    reference resyncs with error codes, net.flavor.swift:673-721)."""
    from swiftvideo_tpu_torch.net.flavor import FlavorSessionCore
    from swiftvideo_tpu_torch.net.rtmp import RtmpSessionCore
    rng = np.random.default_rng(0)
    fcore = FlavorSessionCore(is_server=True, asset_id="s")
    rcore = RtmpSessionCore(is_server=True, asset_id="s")
    for i in range(50):
        blob = rng.integers(0, 256, int(rng.integers(1, 4000)),
                            np.int64).astype(np.uint8).tobytes()
        fcore.feed(blob)       # must not raise
        rcore.feed(blob)       # must not raise
    # a valid handshake after garbage still works on a fresh core
    from swiftvideo_tpu_torch.net.flavor import FlavorSessionCore as F
    srv, cli = F(is_server=True, asset_id="s"), F(is_server=False, asset_id="c")
    srv.feed(cli.feed(srv.start_bytes())[0])
    assert srv.established and cli.established
