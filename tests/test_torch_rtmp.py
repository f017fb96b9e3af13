"""Twin of ``tests/test_rtmp.py`` on the port (``swiftvideo_tpu_torch``): the same
cases, with free ports in place of the fixed ones.

RTMP tests: AMF0 roundtrip, chunk-layer roundtrip (incl. extended
timestamps + rollover), and full loopback over real sockets.

Ported strategy from the reference rtmpTests
(Tests/swiftVideoTests/rtmpTests.swift): prime-sized
buffers with a forced keyframe NAL pushed through
publish -> serialize -> TCP -> deserialize -> subscribe, byte- and
pts-compared on receipt; edge suites start pts near 0xFFFFFF (extended
timestamps) and near 2^32 (rollover).
"""

import asyncio
import socket

import numpy as np
import pytest

from swiftvideo_tpu_torch.core import StepClock, TimePoint
from swiftvideo_tpu_torch.media import (CodedMediaSample, MediaFormat, MediaType,
                                  is_keyframe)
from swiftvideo_tpu_torch.net.rtmp import (Chunk, ChunkDeserializer,
                                     ChunkSerializer, Rtmp, amf)


def _free_port() -> int:
    """A port no test of another worker holds (the JAX twins' fixed ports
    may be bound by a concurrent worker)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# --- AMF0 ------------------------------------------------------------------

def test_amf_roundtrip():
    values = ["connect", 1.0, {"app": "live", "tcUrl": "rtmp://x/live",
                               "nested": {"a": 1.5, "b": True}},
              None, [1.0, "two", False],
              amf.EcmaArray({"width": 1920.0, "height": 1080.0})]
    blob = amf.serialize(values)
    out = amf.parse(blob)
    assert out == values
    assert isinstance(out[5], amf.EcmaArray)


def test_amf_long_string():
    s = "x" * 70000
    assert amf.parse(amf.serialize([s])) == [s]


# --- chunk layer -----------------------------------------------------------

def _roundtrip(messages, chunk_size=128):
    ser = ChunkSerializer(chunk_size)
    des = ChunkDeserializer(chunk_size)
    out = []
    for msg in messages:
        out.extend(des.feed(ser.serialize(msg)))
    return out


def test_chunk_roundtrip_basic():
    msgs = [Chunk(msg_stream_id=1, msg_length=300, msg_type=0x9,
                  chunk_stream_id=6, timestamp=t * 33,
                  timestamp_delta=33 if t else 0,
                  data=bytes([t % 256]) * 300)
            for t in range(20)]
    got = _roundtrip(msgs)
    assert len(got) == 20
    for sent, rec in zip(msgs, got):
        assert rec.data == sent.data
        assert rec.timestamp == sent.timestamp
        assert rec.msg_type == sent.msg_type
        assert rec.msg_length == sent.msg_length


def test_chunk_roundtrip_extended_timestamps():
    """timestamps >= 0xFFFFFF use the extended field everywhere."""
    base = 0x1000000
    msgs = [Chunk(msg_stream_id=1, msg_length=100, msg_type=0x9,
                  chunk_stream_id=6, timestamp=base + t * 40,
                  timestamp_delta=40 if t else 0, data=bytes(100))
            for t in range(10)]
    got = _roundtrip(msgs)
    assert [c.timestamp for c in got] == [base + t * 40 for t in range(10)]


def test_chunk_roundtrip_rollover():
    """Serial-number arithmetic: crossing 2^32 keeps absolute timestamps
    monotonic (RFC1982 semantics, deserialize.swift:92-101)."""
    base = 4294966296  # 1 s before 2^32 ms
    msgs = [Chunk(msg_stream_id=1, msg_length=64, msg_type=0x9,
                  chunk_stream_id=6, timestamp=base + t * 100,
                  timestamp_delta=100 if t else 0, data=bytes(64))
            for t in range(30)]
    got = _roundtrip(msgs)
    assert [c.timestamp for c in got] == [base + t * 100 for t in range(30)]


def test_chunk_fragmented_delivery():
    """Parser must survive arbitrary byte fragmentation."""
    ser = ChunkSerializer(128)
    des = ChunkDeserializer(128)
    payload = bytes(range(256)) * 8  # 2048 bytes -> many 128-byte chunks
    blob = ser.serialize(Chunk(msg_stream_id=1, msg_length=len(payload),
                               msg_type=0x9, chunk_stream_id=6,
                               timestamp=1000, data=payload))
    got = []
    rng = np.random.default_rng(0)
    pos = 0
    while pos < len(blob):
        n = int(rng.integers(1, 77))
        got.extend(des.feed(blob[pos:pos + n]))
        pos += n
    assert len(got) == 1 and got[0].data == payload


def test_chunk_large_message_rechunked():
    """Messages above the chunk size split with type-3 continuations."""
    ser = ChunkSerializer(4096)
    des = ChunkDeserializer(4096)
    payload = np.random.default_rng(1).integers(0, 256, 111323,
                                                np.int64).astype(np.uint8).tobytes()
    blob = ser.serialize(Chunk(msg_stream_id=1, msg_length=len(payload),
                               msg_type=0x9, chunk_stream_id=6,
                               timestamp=0, data=payload))
    got = des.feed(blob)
    assert len(got) == 1 and got[0].data == payload


def test_chunk_extended_flag_tracks_wire_not_value():
    """A peer may use the extended-timestamp encoding for values below
    0xFFFFFF (sloppy but seen in the wild); type-3 continuations then
    carry a 4-byte extended field that the parser must skip.  The
    extended flag must reflect the WIRE encoding, not `value >= 0xFFFFFF`
    re-derivation (which would desync every continuation chunk)."""
    des = ChunkDeserializer(128)
    payload = bytes(range(200)) * 2           # 400 bytes -> 4 chunks @128
    ts = 1234                                  # < 0xFFFFFF, sent extended
    header = (bytes([0x06])                    # fmt 0, csid 6
              + b"\xff\xff\xff"                # ts field says "extended"
              + len(payload).to_bytes(3, "big") + bytes([0x9])
              + (1).to_bytes(4, "little")
              + ts.to_bytes(4, "big"))         # extended value < 0xFFFFFF
    cont = bytes([0xC6]) + ts.to_bytes(4, "big")  # type 3 with extended
    blob = (header + payload[:128] + cont + payload[128:256]
            + cont + payload[256:384] + cont + payload[384:])
    got = des.feed(blob)
    assert len(got) == 1
    assert got[0].data == payload
    assert got[0].timestamp == ts and got[0].extended


def test_chunk_desync_pending_cap():
    """A stalled parse (type-3 chunk on an unknown chunk stream) must not
    grow the inbound buffer unboundedly: past max_pending the deserializer
    raises and the session core flags fatal (the reference waits forever
    but NIO's transport backpressure bounds it; here the cap is explicit)."""
    des = ChunkDeserializer(max_pending=1 << 16)
    # format 3 on csid 9 with no prior type-0: permanently unparseable
    stall = bytes([0xC9]) + b"\x00" * 4000
    des.feed(stall)
    with pytest.raises(ValueError, match="inbound buffer exceeded"):
        for _ in range(64):
            des.feed(b"\x00" * 4096)

    from swiftvideo_tpu_torch.net.rtmp.session import RtmpSessionCore
    core = RtmpSessionCore(is_server=True, asset_id="a")
    core._hs_state = "established"      # skip handshake for the byte feed
    core.deserializer = ChunkDeserializer(max_pending=1 << 16)
    core.feed(stall)
    for _ in range(64):
        out, samples = core.feed(b"\x00" * 4096)
        if core.fatal:
            break
    assert core.fatal and "inbound buffer exceeded" in core.fatal


# --- full loopback over sockets -------------------------------------------

PRIMES = [1009, 2087, 1447, 2221, 2503, 3001, 4999, 2857, 9973, 8191, 7331,
          3539, 44701, 47701, 65537]


def _buffers():
    rng = np.random.default_rng(42)
    bufs = []
    for n in PRIMES:
        data = bytearray(rng.integers(0, 256, n, np.int64).astype(np.uint8)
                         .tobytes())
        data[4] = 0x65  # keyframe NAL in AVCC framing
        bufs.append(bytes(data))
    return bufs


async def _loopback(offset_ms: int, port: int, count: int = 120):
    clock = StepClock(TimePoint(16, 1000))
    received = []
    sent = []
    sub_box = {}

    async def on_connection(pub, sub):
        if sub is not None:
            sub_box["sub"] = sub
            sub_box["chain"] = sub >> __import__(
                "swiftvideo_tpu_torch.core", fromlist=["Tx"]).Tx(
                lambda s: (received.append(s),
                           __import__("swiftvideo_tpu_torch.core",
                                      fromlist=["EventBox"]).EventBox
                           .nothing(None))[1])
        return True

    server = Rtmp(clock, on_connection=on_connection)
    await server.serve("127.0.0.1", port)
    client = Rtmp(clock)
    pub, _ = await client.connect(f"rtmp://127.0.0.1:{port}/app/stream",
                                  publish_to_peer=True, max_attempts=2,
                                  retry_delay=0.2)
    assert pub is not None
    bufs = _buffers()
    # fire the 200 ms metadata grace timer (13 x 16 ms steps)
    for _ in range(14):
        clock.step()
        await asyncio.sleep(0)
    rng = np.random.default_rng(7)
    ts = TimePoint(0, 1000)
    config = bytes(48)
    for i in range(count):
        idx = int(rng.integers(0, len(bufs)))
        pts = ts + TimePoint(offset_ms, 1000)
        sample = CodedMediaSample(
            buffer=bufs[idx], pts_value=pts, dts_value=pts,
            media_type=MediaType.video, media_format=MediaFormat.avc,
            id_asset="test", id_workspace="test", side={"config": config})
        box = pub.apply(__import__("swiftvideo_tpu_torch.core",
                                   fromlist=["EventBox"]).EventBox
                        .just(sample))
        if not box.is_error():
            sent.append((pts, idx))
        ts = ts + TimePoint(16, 1000)
        clock.step()
        if i % 8 == 0:
            await asyncio.sleep(0)
    # drain
    for _ in range(50):
        await asyncio.sleep(0.01)
        if len(received) >= len(sent):
            break
    await server.close()
    pub.close()
    return sent, received, bufs


@pytest.mark.parametrize("offset_ms", [
    0,
    16777216,       # extended timestamps (>= 0xFFFFFF ms)
    4294966296,     # uint32 rollover
])
def test_rtmp_loopback(offset_ms):
    sent, received, bufs = asyncio.run(_loopback(offset_ms, _free_port()))
    assert len(sent) > 100
    assert len(received) == len(sent)
    for (pts, idx), sample in zip(sent, received):
        assert sample.pts() == pts, (sample.pts(), pts)
        assert sample.data() == bufs[idx]
        assert sample.media_format == MediaFormat.avc


def test_connect_reconnect_then_fail():
    """The client retries with backoff and raises after max_attempts
    (rtmp.swift:104-153 reconnect loop)."""
    import time as _t

    async def run():
        client = Rtmp()
        t0 = _t.monotonic()
        try:
            await client.connect(f"rtmp://127.0.0.1:{_free_port()}/app/x",
                                 max_attempts=3, retry_delay=0.05)
        except ConnectionError as exc:
            return _t.monotonic() - t0, str(exc)
        raise AssertionError("expected ConnectionError")

    elapsed, msg = asyncio.run(run())
    assert "3 attempts" in msg
    assert elapsed >= 0.1  # two backoff sleeps happened


async def _play_loopback(port: int):
    """Client plays; the server-side publisher sends media down."""
    from swiftvideo_tpu_torch.core import EventBox, Tx
    pubs = []

    async def on_connection(pub, sub):
        if pub is not None:
            pubs.append(pub)
        return True

    clock = StepClock(TimePoint(16, 1000))
    server = Rtmp(clock, on_connection=on_connection)
    await server.serve("127.0.0.1", port)
    client = Rtmp(clock)
    _, sub = await client.connect(f"rtmp://127.0.0.1:{port}/app/show",
                                  publish_to_peer=False, max_attempts=2,
                                  retry_delay=0.2)
    assert sub is not None
    # the client's conn->session chain must survive a full gc: emit chains
    # are weak, and connect()'s locals are gone by now (regression for the
    # chain being anchored only in a connect-helper local)
    import gc
    gc.collect()
    received = []
    chain = sub >> Tx(lambda s: (received.append(s),
                                 EventBox.nothing(None))[1])
    for _ in range(30):
        await asyncio.sleep(0.01)
        if pubs:
            break
    assert pubs, "server publisher never created"
    pub = pubs[0]
    assert pub.play_path() == "show"
    for _ in range(14):
        clock.step()
        await asyncio.sleep(0)
    bufs = _buffers()
    sent = []
    ts = TimePoint(0, 1000)
    for i in range(40):
        sample = CodedMediaSample(
            buffer=bufs[i % len(bufs)], pts_value=ts, dts_value=ts,
            media_type=MediaType.video, media_format=MediaFormat.avc,
            id_asset="show", id_workspace="app", side={"config": bytes(48)})
        box = pub.apply(__import__("swiftvideo_tpu_torch.core",
                                   fromlist=["EventBox"]).EventBox
                        .just(sample))
        # only frames the publisher actually wrote (just -> ResultEvent);
        # nothing() covers metadata-pending and backpressure drops, which
        # legitimately occur under heavy host load
        if box.is_just():
            sent.append(sample)
        ts = ts + TimePoint(16, 1000)
        clock.step()
        await asyncio.sleep(0)
    for _ in range(60):
        await asyncio.sleep(0.01)
        if len(received) >= len(sent):
            break
    pub.close()
    await server.close()
    return sent, received


def test_rtmp_play_loopback():
    """Server publishes to a playing client (the client play command the
    reference left TODO, states.swift:496-499, completed here)."""
    sent, received = asyncio.run(_play_loopback(_free_port()))
    assert len(sent) > 20
    assert len(received) == len(sent)
    for s, r in zip(sent, received):
        assert r.data() == s.data()
        assert r.pts() == s.pts()


def test_publisher_drops_when_backpressured():
    """A paused transport (kernel buffer full) drops media instead of
    buffering unboundedly."""
    from swiftvideo_tpu_torch.core import EventBox, StatsReport, WallClock
    from swiftvideo_tpu_torch.net.rtmp.rtmp import RtmpPublisher
    from swiftvideo_tpu_torch.net.rtmp.session import RtmpSessionCore
    from swiftvideo_tpu_torch.net.tcp import Connection

    clock = StepClock(TimePoint(16, 1000))
    conn = Connection()

    class FakeTransport:
        def __init__(self):
            self.sent = []

        def write(self, data):
            self.sent.append(data)

        def close(self):
            pass

    conn.transport = FakeTransport()
    core = RtmpSessionCore(is_server=True, asset_id="a", clock=clock)
    pub = RtmpPublisher(clock, conn, core)
    pub._sent_props = True  # skip metadata machinery
    sample = CodedMediaSample(
        buffer=b"\x00\x00\x00\x02\x65x", pts_value=TimePoint(0, 1000),
        dts_value=TimePoint(0, 1000), media_type=MediaType.video,
        media_format=MediaFormat.avc, id_asset="a",
        side={"config": bytes(8)})
    assert pub.apply(EventBox.just(sample)).is_just()
    n = len(conn.transport.sent)
    conn.pause_writing()
    assert pub.apply(EventBox.just(sample)).is_nothing()
    assert len(conn.transport.sent) == n  # nothing written while paused
    conn.resume_writing()
    assert pub.apply(EventBox.just(sample)).is_just()
    assert len(conn.transport.sent) > n


def test_enhanced_rtmp_fourcc_roundtrip():
    """Non-avc/aac media travels as Enhanced RTMP ex-headers (fourCC
    signaling per E-RTMP v1/v2) — beyond the reference's avc/aac-only
    tags (serialize.swift:24-55, states.swift:198-248): hevc with hvcC
    config + 24-bit cts, vp9 config-less, opus with OpusHead config."""
    from swiftvideo_tpu_torch.net.rtmp.media import MediaSerializer
    from swiftvideo_tpu_torch.net.rtmp.session import RtmpSessionCore

    clock = StepClock(TimePoint(16, 1000))

    def roundtrip(samples):
        tx_core = RtmpSessionCore(is_server=False, asset_id="a", clock=clock)
        rx_core = RtmpSessionCore(is_server=True, asset_id="a", clock=clock)
        rx_core._hs_state = "established"   # skip the handshake exchange
        media = MediaSerializer(tx_core.serializer, 1)
        received = []
        for s in samples:
            blob = media.serialize(s)
            if blob:
                _, out = rx_core.feed(blob)
                received.extend(out)
        return received

    def coded(fmt, data, pts_ms, dts_ms=None, side=None,
              mtype=MediaType.video):
        dts_ms = pts_ms if dts_ms is None else dts_ms
        return CodedMediaSample(
            buffer=data, pts_value=TimePoint(pts_ms, 1000),
            dts_value=TimePoint(dts_ms, 1000), media_type=mtype,
            media_format=fmt, id_asset="a", id_workspace="w",
            side=side or {})

    # hevc: IDR + TRAIL, 2 ms composition offset, hvcC config
    from tests.test_bitstream import make_h265_sps
    from swiftvideo_tpu_torch.codec import containers
    rec = containers.make_hvcc(
        b"\x40\x01", make_h265_sps(1920, 1088, crop=(0, 0, 0, 4)),
        b"\x44\x01")

    def nal(t):
        body = bytes([t << 1, 1]) + b"\x00" * 20
        return len(body).to_bytes(4, "big") + body

    got = roundtrip([
        coded(MediaFormat.hevc, nal(19), 2, 0, side={"config": rec}),
        coded(MediaFormat.hevc, nal(1), 18, 16, side={"config": rec}),
    ])
    assert [s.media_format for s in got] == [MediaFormat.hevc] * 2
    assert [is_keyframe(s) for s in got] == [True, False]
    assert [(s.pts() - s.dts()).value for s in got] == [2, 2]
    assert got[0].side_data()["config"] == rec
    assert got[0].data() == nal(19)

    # vp9: no codec config record; keyframe bit from the frame header
    got = roundtrip([coded(MediaFormat.vp9, b"\x80" + b"k" * 10, 0),
                     coded(MediaFormat.vp9, b"\x84" + b"p" * 10, 16)])
    assert [s.media_format for s in got] == [MediaFormat.vp9] * 2
    assert [is_keyframe(s) for s in got] == [True, False]
    assert "config" not in got[0].side_data()

    # opus: ex-header audio with OpusHead config
    head = containers.make_opus_head(2)
    got = roundtrip([coded(MediaFormat.opus, b"\xfc" + b"o" * 30, 0,
                           side={"config": head}, mtype=MediaType.audio),
                     coded(MediaFormat.opus, b"\xfc" + b"p" * 30, 20,
                           side={"config": head}, mtype=MediaType.audio)])
    assert [s.media_format for s in got] == [MediaFormat.opus] * 2
    assert got[0].side_data()["config"] == head
    assert got[1].data() == b"\xfc" + b"p" * 30

    # vp8 has no RTMP representation: serializes to nothing, no crash
    assert roundtrip([coded(MediaFormat.vp8, b"\x00" + b"v" * 10, 0)]) == []


def test_legacy_aac_tag_roundtrip():
    """Legacy FLV AAC audio tags (0xAF: sequence header + raw) — the
    reference's core audio path (serialize.swift:24-55 audio branch,
    states.swift handleAudio:224-248): ASC config rides the sequence
    header and re-attaches to every received sample; pts survives."""
    from swiftvideo_tpu_torch.net.rtmp.media import MediaSerializer
    from swiftvideo_tpu_torch.net.rtmp.session import RtmpSessionCore

    clock = StepClock(TimePoint(16, 1000))
    tx_core = RtmpSessionCore(is_server=False, asset_id="a", clock=clock)
    rx_core = RtmpSessionCore(is_server=True, asset_id="a", clock=clock)
    rx_core._hs_state = "established"
    media = MediaSerializer(tx_core.serializer, 1)
    asc = bytes([0x12, 0x10])                 # AAC-LC 44.1k stereo
    received = []
    for i in range(3):
        s = CodedMediaSample(
            buffer=bytes([0x21, i]) + b"a" * 50,
            pts_value=TimePoint(i * 21, 1000),
            dts_value=TimePoint(i * 21, 1000),
            media_type=MediaType.audio, media_format=MediaFormat.aac,
            id_asset="a", id_workspace="w", side={"config": asc})
        blob = media.serialize(s)
        if blob:
            _, out = rx_core.feed(blob)
            received.extend(out)
    assert len(received) == 3
    assert all(s.media_format == MediaFormat.aac for s in received)
    assert all(s.media_type == MediaType.audio for s in received)
    assert received[0].side_data()["config"] == asc
    assert [s.pts().value for s in received] == [0, 21, 42]
    assert received[2].data() == bytes([0x21, 2]) + b"a" * 50


def test_enhanced_rtmp_sequence_start_configs():
    """vp9/av1 publish with a codec config record emits an E-RTMP
    PacketTypeSequenceStart (vpcC / av1C payload) ahead of CodedFrames —
    compliant receivers require it — and the receiver re-attaches the
    record to every sample; hvc1 SI24 composition time sign-extends."""
    from swiftvideo_tpu_torch.codec import containers
    from swiftvideo_tpu_torch.net.rtmp.media import MediaSerializer
    from swiftvideo_tpu_torch.net.rtmp.session import RtmpSessionCore
    from tests.test_containers import (av1_frame_obu, make_av1_seq_obu,
                                       make_vp9_keyframe)
    from tests.test_bitstream import make_h265_sps

    clock = StepClock(TimePoint(16, 1000))

    def coded(fmt, data, pts_ms, dts_ms=None, side=None):
        dts_ms = pts_ms if dts_ms is None else dts_ms
        return CodedMediaSample(
            buffer=data, pts_value=TimePoint(pts_ms, 1000),
            dts_value=TimePoint(dts_ms, 1000), media_type=MediaType.video,
            media_format=fmt, id_asset="a", id_workspace="w",
            side=side or {})

    def roundtrip(samples):
        tx_core = RtmpSessionCore(is_server=False, asset_id="a", clock=clock)
        rx_core = RtmpSessionCore(is_server=True, asset_id="a", clock=clock)
        rx_core._hs_state = "established"
        media = MediaSerializer(tx_core.serializer, 1)
        received = []
        for s in samples:
            blob = media.serialize(s)
            if blob:
                _, out = rx_core.feed(blob)
                received.extend(out)
        return received, media

    # vp9 with vpcC: config precedes media and survives the wire
    key = make_vp9_keyframe(1280, 720, color_space=1)
    vpcc = containers.make_vpcc(key)
    got, _ = roundtrip([coded(MediaFormat.vp9, key, 0,
                              side={"config": vpcc}),
                        coded(MediaFormat.vp9, b"\x84" + b"p" * 9, 16,
                              side={"config": vpcc})])
    assert [s.media_format for s in got] == [MediaFormat.vp9] * 2
    assert got[0].side_data()["config"] == vpcc
    assert got[1].side_data()["config"] == vpcc
    assert containers.parse_vpcc(got[0].side_data()["config"])["level"] == 31
    assert got[0].data() == key

    # av1 with av1C
    tu = make_av1_seq_obu(640, 360) + av1_frame_obu(0x00)
    av1c = containers.make_av1c(tu)
    got, _ = roundtrip([coded(MediaFormat.av1, tu, 0,
                              side={"config": av1c})])
    assert got[0].media_format == MediaFormat.av1
    assert got[0].side_data()["config"] == av1c
    assert containers.parse_av1c(
        got[0].side_data()["config"])["config_obus"] \
        == make_av1_seq_obu(640, 360)

    # hvc1: negative composition offset (B-frame leading picture)
    rec = containers.make_hvcc(b"\x40\x01", make_h265_sps(640, 360),
                               b"\x44\x01")

    def nal(t):
        body = bytes([t << 1, 1]) + b"\x00" * 20
        return len(body).to_bytes(4, "big") + body

    got, _ = roundtrip([
        coded(MediaFormat.hevc, nal(19), 2, 0, side={"config": rec}),
        coded(MediaFormat.hevc, nal(1), 14, 16, side={"config": rec}),
    ])
    assert (got[1].pts() - got[1].dts()).value == -2

    # vp8 carrying a config blob: nothing reaches the wire and the
    # first-keyframe gate must NOT open (regression: it used to)
    got, media = roundtrip([coded(MediaFormat.vp8, b"\x00v", 0,
                                  side={"config": b"cfg"})])
    assert got == [] and not media._sent_first_keyframe
    assert MediaType.video not in media._prev_config

    # mid-stream config change (rtmp.swift:562-609 resend semantics):
    # a new hvcC triggers a fresh SequenceStart and downstream samples
    # re-attach the NEW record
    rec2 = containers.make_hvcc(b"\x40\x01", make_h265_sps(1280, 720),
                                b"\x44\x01")
    got, _ = roundtrip([
        coded(MediaFormat.hevc, nal(19), 0, 0, side={"config": rec}),
        coded(MediaFormat.hevc, nal(1), 16, 16, side={"config": rec}),
        coded(MediaFormat.hevc, nal(19), 32, 32, side={"config": rec2}),
        coded(MediaFormat.hevc, nal(1), 48, 48, side={"config": rec2}),
    ])
    assert [s.side_data()["config"] for s in got] == [rec, rec, rec2, rec2]


def test_enhanced_rtmp_metadata_codec_ids():
    """onMetaData advertises the real codec ids (hvc1/Opus) instead of
    hardcoded avc1/mp4a."""
    from swiftvideo_tpu_torch.codec import containers
    from swiftvideo_tpu_torch.net.rtmp import amf
    from swiftvideo_tpu_torch.net.rtmp.chunks import ChunkDeserializer
    from swiftvideo_tpu_torch.net.rtmp.media import create_metadata
    from swiftvideo_tpu_torch.net.rtmp.session import RtmpSessionCore
    from swiftvideo_tpu_torch.media.coded import (BasicAudioDescription,
                                            BasicVideoDescription)

    clock = StepClock(TimePoint(16, 1000))
    core = RtmpSessionCore(is_server=False, asset_id="a", clock=clock)
    blob = create_metadata(
        [BasicVideoDescription(size=(1920, 1080)),
         BasicAudioDescription(sample_rate=48000.0, channel_count=2,
                               samples_per_packet=960)],
        core.serializer, 1, video_format=MediaFormat.hevc,
        audio_format=MediaFormat.opus)
    de = ChunkDeserializer()
    de.append(blob)
    chunk = de.poll()
    atoms = amf.parse(chunk.data)
    meta = atoms[2]
    assert meta["videocodecid"] == "hvc1"
    assert meta["audiocodecid"] == "Opus"
    assert meta["width"] == 1920.0


# --- round-4 interop corrections ---------------------------------------------


def test_three_byte_csid_bias_spec_vector():
    """Spec 5.3.1.1: the 3-byte basic-header form carries csid - 64.  A
    conformant peer encoding chunk stream 70 as (fmt|1, 6, 0) must NOT
    collide with chunk stream 6 (the reference has this bug,
    serialize.swift:137 / deserialize.swift:63)."""
    ser = ChunkSerializer(out_chunk_size=4096)
    for csid in (320, 5000, 65599):
        wire = ser.serialize(Chunk(
            msg_stream_id=1, msg_length=3, msg_type=9, chunk_stream_id=csid,
            timestamp=16, timestamp_delta=16, data=b"abc"))
        assert wire[0] & 0x3F == 1
        assert int.from_bytes(wire[1:3], "little") == csid - 64
        for native in (True, False):
            d = ChunkDeserializer(in_chunk_size=4096, native=native)
            out = d.feed(wire)
            assert len(out) == 1 and out[0].chunk_stream_id == csid
    # hand-built conformant peer bytes: fmt0, 3-byte csid 70, ts 0, len 1
    wire = bytes([0x01, 6, 0]) + b"\x00\x00\x00" + b"\x00\x00\x01" \
        + bytes([9]) + b"\x01\x00\x00\x00" + b"x"
    for native in (True, False):
        d = ChunkDeserializer(native=native)
        out = d.feed(wire)
        assert len(out) == 1 and out[0].chunk_stream_id == 70, f"{native=}"


def test_type3_extended_field_carries_delta():
    """A standalone type-3 with the extended flag must repeat the
    preceding header's DELTA (FFmpeg sniffs those 4 bytes against the
    last extended value), not the absolute timestamp.  The selection
    rules (2 s type-0 forcing) make this unreachable through
    serialize() today, so drive _chunk3 directly after priming the
    per-stream state with an extended type-1."""
    big = 0x1000000                       # delta >= 0xFFFFFF -> extended
    ser = ChunkSerializer(out_chunk_size=4096)
    first = Chunk(msg_stream_id=1, msg_length=2, msg_type=9,
                  chunk_stream_id=6, timestamp=big, timestamp_delta=big,
                  data=b"ab")
    ser.serialize(first)                  # type 0 (no prev)
    w1 = ser._chunk1(first.changing(timestamp=2 * big))
    assert int.from_bytes(w1[8:12], "big") == big  # ext delta after 7B hdr
    w3 = ser._chunk3(first.changing(timestamp=3 * big))
    assert (w3[0] & 0xC0) >> 6 == 3
    assert int.from_bytes(w3[1:5], "big") == big, "ext field must be delta"
    # a conformant receiver advances by the repeated delta
    d = ChunkDeserializer(in_chunk_size=4096)
    w0 = ChunkSerializer(out_chunk_size=4096).serialize(first)
    out = d.feed(w0 + w1 + w3)
    assert [c.timestamp for c in out] == [big, 2 * big, 3 * big]


def test_set_chunk_size_zero_contained():
    """SetChunkSize 0 (or high-bit) would desync the parser into per-byte
    garbage; the session must record a malformed-message error and stay
    alive rather than applying it."""
    from swiftvideo_tpu_torch.net.rtmp.session import RtmpSessionCore

    clock = StepClock(TimePoint(16, 1000))
    core = RtmpSessionCore(is_server=True, asset_id="a", clock=clock)
    core._hs_state = "established"
    ser = ChunkSerializer(out_chunk_size=128)
    import struct as _s
    for bad in (0, 0x80000000):
        wire = ser.serialize(Chunk(
            msg_stream_id=0, msg_length=4, msg_type=1, chunk_stream_id=2,
            timestamp=0, data=_s.pack(">I", bad)))
        core.feed(wire)
    # recoverable (not applied, parsing continues): a warning, not a
    # dial-fatal error
    assert len(core.warnings) == 2 and not core.errors and not core.fatal
    assert core.deserializer.in_chunk_size == 128


def test_legacy_non_avc_video_and_non_aac_audio_ignored():
    """Legacy FLV tags for VP6 video (codec id 4) and MP3 audio (sound
    format 2) have no AVC cts / AAC packet-type fields; they must be
    ignored, not parsed as avc/aac garbage."""
    from swiftvideo_tpu_torch.net.rtmp.session import RtmpSessionCore

    clock = StepClock(TimePoint(16, 1000))
    core = RtmpSessionCore(is_server=True, asset_id="a", clock=clock)
    core._hs_state = "established"
    ser = ChunkSerializer(out_chunk_size=4096)
    vp6 = bytes([0x14, 0x00]) + bytes(20)       # keyframe|codec4, then data
    mp3 = bytes([0x2F, 0x00]) + bytes(20)       # format 2, stereo
    wire = ser.serialize(Chunk(
        msg_stream_id=1, msg_length=len(vp6), msg_type=9,
        chunk_stream_id=6, timestamp=0, data=vp6))
    wire += ser.serialize(Chunk(
        msg_stream_id=1, msg_length=len(mp3), msg_type=8,
        chunk_stream_id=4, timestamp=0, data=mp3))
    _out, samples = core.feed(wire)
    assert samples == [] and not core.errors
    assert "videoConfig" not in core.ctx.side_data
    assert "audioConfig" not in core.ctx.side_data


def test_null_transaction_id_contained():
    """AMF payloads are attacker-typed: a null transaction id reaching
    int() raised TypeError past feed()'s containment."""
    from swiftvideo_tpu_torch.net.rtmp import amf
    from swiftvideo_tpu_torch.net.rtmp.session import RtmpSessionCore

    clock = StepClock(TimePoint(16, 1000))
    core = RtmpSessionCore(is_server=False, asset_id="a", clock=clock)
    core._hs_state = "established"
    payload = amf.serialize(["_result", None])
    ser = ChunkSerializer(out_chunk_size=4096)
    wire = ser.serialize(Chunk(
        msg_stream_id=0, msg_length=len(payload), msg_type=0x14,
        chunk_stream_id=3, timestamp=0, data=payload))
    core.feed(wire)
    assert any("malformed" in e for e in core.warnings) and not core.fatal
    assert not core.errors      # recoverable: must not fail a dial


def test_informational_onstatus_does_not_fail_dial():
    """NetStream.Play.Reset (sent by real servers before Play.Start) and
    other informational statuses must not abort the connect; only
    level:'error' statuses are dial-fatal."""
    from swiftvideo_tpu_torch.net.rtmp import amf
    from swiftvideo_tpu_torch.net.rtmp.session import RtmpSessionCore

    clock = StepClock(TimePoint(16, 1000))
    core = RtmpSessionCore(is_server=False, asset_id="a", clock=clock,
                           publish_to_peer=False)
    core._hs_state = "established"
    ser = ChunkSerializer(out_chunk_size=4096)

    def status(code, level="status"):
        payload = amf.serialize(["onStatus", 0.0, None,
                                 {"level": level, "code": code}])
        return ser.serialize(Chunk(
            msg_stream_id=1, msg_length=len(payload), msg_type=0x14,
            chunk_stream_id=3, timestamp=0, data=payload))

    core.feed(status("NetStream.Play.Reset"))
    assert not core.errors and core.notices == ["NetStream.Play.Reset"]
    core.feed(status("NetStream.Play.Start"))
    assert core.ctx.started and not core.errors
    core2 = RtmpSessionCore(is_server=False, asset_id="b", clock=clock,
                            publish_to_peer=False)
    core2._hs_state = "established"
    ser2 = ChunkSerializer(out_chunk_size=4096)
    payload = amf.serialize(["onStatus", 0.0, None,
                             {"level": "error",
                              "code": "NetStream.Play.StreamNotFound"}])
    core2.feed(ser2.serialize(Chunk(
        msg_stream_id=1, msg_length=len(payload), msg_type=0x14,
        chunk_stream_id=3, timestamp=0, data=payload)))
    assert core2.errors == ["NetStream.Play.StreamNotFound"]


def test_connection_write_from_foreign_thread():
    """asyncio transports are not thread-safe; Connection.write from a
    non-loop thread (WallClock scheduler emitting media) must marshal
    onto the loop and still deliver."""
    import asyncio
    import threading

    from swiftvideo_tpu_torch.core import EventBox, Tx
    from swiftvideo_tpu_torch.net.tcp import tcp_client, tcp_serve

    async def run():
        got = asyncio.Event()
        data = []

        def on_conn(conn):
            conn.retain(conn >> Tx(
                lambda e: (data.append(e.data()), got.set(),
                           EventBox.nothing(None))[2]))

        server = await tcp_serve("127.0.0.1", 0, on_conn)
        port = server.sockets[0].getsockname()[1]
        cli = await tcp_client("127.0.0.1", port)
        t = threading.Thread(target=cli.write, args=(b"off-loop-bytes",))
        t.start(); t.join()
        await asyncio.wait_for(got.wait(), 5.0)
        assert b"".join(data) == b"off-loop-bytes"
        cli.close()
        server.close()
        await server.wait_closed()

    asyncio.run(run())
