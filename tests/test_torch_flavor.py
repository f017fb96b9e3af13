"""Twin of ``tests/test_flavor.py`` on the port (``swiftvideo_tpu_torch``): the same
cases, with free ports in place of the fixed ones.

flavor protocol tests: atom codec roundtrip + socket loopback push."""

import asyncio
import socket

import numpy as np
import pytest

from swiftvideo_tpu_torch.core import EventBox, TimePoint, Tx
from swiftvideo_tpu_torch.media import CodedMediaSample, MediaFormat, MediaType
from swiftvideo_tpu_torch.net import flavor as fl


def _free_port() -> int:
    """A port no test of another worker holds (the JAX twins' fixed ports
    may be bound by a concurrent worker)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_atom_value_roundtrip():
    vals = {"i": 42, "big": 1 << 40, "f": 3.5, "s": "hello flavor",
            "b": True, "d": b"\x00\x01\x02",
            "nested": {"x": 1, "list": [1, 2, "three"]}}
    blob = fl.encode_value(vals)
    atoms = list(fl.parse_atoms(blob))
    assert len(atoms) == 1 and atoms[0][0] == "dict"
    out = fl.decode_value("dict", atoms[0][1])
    assert out == vals


def test_trak_roundtrip():
    t = fl.TrackInfo("AVC1", 7, 3, 600600, True, b"extradata")
    blob = fl.serialize_trak(t)
    atoms = list(fl.parse_atoms(blob))
    assert atoms[0][0] == "trak"
    out = fl.parse_trak(atoms[0][1])
    assert out == t


def test_core_handshake_and_push():
    """Pure core loopback: ping handshake, push grant, track + media."""
    srv = fl.FlavorSessionCore(is_server=True, asset_id="s")
    cli = fl.FlavorSessionCore(is_server=False, asset_id="c")
    out_c, _ = cli.feed(srv.start_bytes())     # ping -> rply
    out_s, _ = srv.feed(out_c)
    assert srv.established and cli.established
    out_c2, _ = cli.feed(srv.feed(cli.request_push(5, "ws/token/asset"))[0])
    assert cli.push_granted
    assert srv.stream_tokens[5] == "ws/token/asset"
    # tracks + media
    track = fl.TrackInfo("AVC1", 5, 1, 1000, True, b"cfg")
    srv_out, samples = srv.feed(cli.send_tracks([track]))
    assert 1 in srv.tracks
    sample = CodedMediaSample(
        buffer=b"payload", pts_value=TimePoint(2002, 1000),
        dts_value=TimePoint(2000, 1000), media_type=MediaType.video,
        media_format=MediaFormat.avc, id_asset="c")
    _, received = srv.feed(cli.media_bytes(sample, track))
    assert len(received) == 1
    r = received[0]
    assert r.data() == b"payload"
    assert r.pts() == TimePoint(2002, 1000)
    assert r.dts() == TimePoint(2000, 1000)
    assert r.media_format == MediaFormat.avc
    assert r.side_data()["config"] == b"cfg"
    assert r.workspace_token() == "ws/token/asset"


def test_push_denied():
    srv = fl.FlavorSessionCore(is_server=True, asset_id="s",
                               on_push_request=lambda sid, tok: False)
    cli = fl.FlavorSessionCore(is_server=False, asset_id="c")
    out_c, _ = cli.feed(srv.start_bytes())
    srv.feed(out_c)
    reply, _ = srv.feed(cli.request_push(1, "tok"))
    cli.feed(reply)
    assert not cli.push_granted
    assert cli.errors and "denied" in cli.errors[0]


def test_unsupported_track_rejected():
    srv = fl.FlavorSessionCore(is_server=True, asset_id="s")
    cli = fl.FlavorSessionCore(is_server=False, asset_id="c")
    srv.feed(cli.feed(srv.start_bytes())[0])
    srv.feed(cli.request_push(1, "t"))
    weird = fl.TrackInfo("WERD", 1, 9, 1000, False)
    reply, _ = srv.feed(cli.send_tracks([weird]))
    # server must reply with the unsupported track list
    atoms = list(fl.parse_atoms(reply))
    assert atoms[0][0] == "rply"
    import struct
    _, code = struct.unpack_from("<ii", atoms[0][1], 0)
    assert code != 0


async def _loopback(port: int):
    received = []
    subs = []

    def on_subscriber(sub):
        subs.append(sub)
        sub_chain = sub >> Tx(lambda s: (received.append(s),
                                         EventBox.nothing(None))[1])
        subs.append(sub_chain)

    server = fl.Flavor(on_subscriber=on_subscriber)
    await server.serve("127.0.0.1", port)
    client = fl.Flavor()
    pub = await client.connect(f"flavor://127.0.0.1:{port}/ws/tok", push=True)
    assert isinstance(pub, fl.FlavorPublisher)
    sent = []
    rng = np.random.default_rng(1)
    for i in range(50):
        payload = rng.integers(0, 256, 1000 + i, np.int64).astype(np.uint8
                                                                  ).tobytes()
        # pts in exact 1/30s steps of the video track time base (600600)
        # so rescaling to the wire base and back is lossless
        s = CodedMediaSample(
            buffer=payload, pts_value=TimePoint(i * 20020, 600600),
            dts_value=TimePoint(i * 20020, 600600), media_type=MediaType.video,
            media_format=MediaFormat.avc, id_asset="cam",
            side={"config": b"\x01cfg"})
        pub.apply(EventBox.just(s))
        sent.append(s)
        if i % 10 == 0:
            await asyncio.sleep(0)
    for _ in range(50):
        await asyncio.sleep(0.01)
        if len(received) >= len(sent):
            break
    pub.close()
    await server.close()
    return sent, received


def test_flavor_socket_loopback():
    sent, received = asyncio.run(_loopback(_free_port()))
    assert len(received) == len(sent)
    for s, r in zip(sent, received):
        assert r.data() == s.data()
        assert r.pts() == s.pts()
        assert r.side_data()["config"] == b"\x01cfg"
        assert r.workspace_token() == "ws/tok"


async def _pull_loopback(port: int):
    """Client pulls; the server-side publisher pushes media down."""
    pubs = []
    server = fl.Flavor(on_publisher=lambda p: pubs.append(p))
    await server.serve("127.0.0.1", port)
    client = fl.Flavor()
    sub = await client.connect(f"flavor://127.0.0.1:{port}/tok2", push=False)
    assert isinstance(sub, fl.FlavorSubscriber)
    received = []
    chain = sub >> Tx(lambda s: (received.append(s),
                                 EventBox.nothing(None))[1])
    for _ in range(30):
        await asyncio.sleep(0.01)
        if pubs:
            break
    assert pubs, "server-side publisher never appeared"
    pub = pubs[0]
    for i in range(20):
        pub.apply(EventBox.just(CodedMediaSample(
            buffer=bytes([i]) * 100, pts_value=TimePoint(i * 20020, 600600),
            dts_value=TimePoint(i * 20020, 600600),
            media_type=MediaType.video, media_format=MediaFormat.avc,
            id_asset="srv")))
        await asyncio.sleep(0)
    for _ in range(50):
        await asyncio.sleep(0.01)
        if len(received) >= 20:
            break
    await server.close()
    sub.close()
    return received


def test_flavor_pull_flow():
    received = asyncio.run(_pull_loopback(_free_port()))
    assert len(received) == 20
    assert received[3].data() == bytes([3]) * 100
    assert received[3].pts() == TimePoint(3 * 20020, 600600)


def test_oversize_atom_rejected():
    """A hostile u32 atom size (up to 4 GiB) must not make the session
    buffer all incoming bytes forever; it is treated as a malformed atom
    (error recorded, backlog dropped, later atoms parse)."""
    import struct
    core = fl.FlavorSessionCore(is_server=True, asset_id="s")
    core.feed(struct.pack("<I", 0x7FFFFFFF) + b"evil")
    assert core.errors and "size" in core.errors[-1]
    assert len(core._buffer) < 64
    # the session still parses sane atoms afterwards
    out, _ = core.feed(fl.serialize_atom("ping", b""))
    assert core.errors is not None   # no crash; ping handling proceeds


def test_publisher_drops_when_backpressured():
    """FlavorPublisher mirrors RtmpPublisher's backpressure: a stalled
    peer drops media frames instead of buffering the transport without
    bound."""
    from swiftvideo_tpu_torch.core import EventBox, TimePoint
    from swiftvideo_tpu_torch.media.coded import (CodedMediaSample, MediaFormat,
                                            MediaType)
    from swiftvideo_tpu_torch.net.tcp import Connection

    conn = Connection()

    class FakeTransport:
        def __init__(self):
            self.sent = []

        def write(self, data):
            self.sent.append(data)

        def close(self):
            pass

    conn.transport = FakeTransport()
    core = fl.FlavorSessionCore(is_server=False, asset_id="c")
    pub = fl.FlavorPublisher(conn, core, stream_id=1)
    sample = CodedMediaSample(
        buffer=b"\x00\x00\x00\x02\x65x", pts_value=TimePoint(0, 1000),
        dts_value=TimePoint(0, 1000), media_type=MediaType.video,
        media_format=MediaFormat.avc, id_asset="c",
        side={"config": bytes(8)})
    assert pub.apply(EventBox.just(sample)).is_just()
    n = len(conn.transport.sent)
    conn.pause_writing()
    assert pub.apply(EventBox.just(sample)).is_nothing()
    assert len(conn.transport.sent) == n
    conn.resume_writing()
    assert pub.apply(EventBox.just(sample)).is_just()
    assert len(conn.transport.sent) > n


def test_unsupported_track_dropped_and_media_not_mislabeled():
    """An unsupported fourcc (or nonsense time_base) must be DROPPED at
    registration, and media atoms must never be emitted with a silent
    avc fallback label."""
    srv = fl.FlavorSessionCore(is_server=True, asset_id="s")
    cli = fl.FlavorSessionCore(is_server=False, asset_id="c")
    srv.feed(cli.feed(srv.start_bytes())[0])
    srv.feed(cli.request_push(1, "t"))
    weird = fl.TrackInfo("MJPG", 1, 9, 1000, False)
    bad_tb = fl.TrackInfo("AVC1", 1, 10, 0, True)
    srv.feed(cli.send_tracks([weird, bad_tb]))
    assert 9 not in srv.tracks and 10 not in srv.tracks
    # media for the rejected track must be ignored, not emitted as avc
    good = fl.TrackInfo("AVC1", 1, 11, 600600, True)
    srv.feed(cli.send_tracks([good]))
    s = CodedMediaSample(
        buffer=b"\x00\x01", pts_value=TimePoint(0, 1000),
        dts_value=TimePoint(0, 1000), media_type=MediaType.video,
        media_format=MediaFormat.avc, id_asset="cam")
    _, samples = srv.feed(cli.media_bytes(s, weird))
    assert samples == []
    _, samples = srv.feed(cli.media_bytes(s, good))
    assert len(samples) == 1 and samples[0].media_format == MediaFormat.avc


def test_publisher_redeclares_track_on_config_change():
    """extradata captured once at first sample goes stale: a configless
    first sample (config rides keyframes) or a mid-stream SPS change must
    re-declare the track with the CURRENT config."""
    class _Conn:
        writable = True

        def __init__(self):
            self.sent = b""

        def write(self, data):
            self.sent += data

    conn = _Conn()
    core = fl.FlavorSessionCore(is_server=False, asset_id="c")
    pub = fl.FlavorPublisher(conn, core, stream_id=1)

    def sample(cfg, pts):
        side = {"config": cfg} if cfg else {}
        return CodedMediaSample(
            buffer=b"\x00\x01", pts_value=TimePoint(pts, 600600),
            dts_value=TimePoint(pts, 600600), media_type=MediaType.video,
            media_format=MediaFormat.avc, id_asset="cam", side=side)

    pub.apply(EventBox.just(sample(None, 0)))       # configless first
    assert pub._format_tracks[MediaFormat.avc].extradata is None
    pub.apply(EventBox.just(sample(b"cfg1", 20020)))
    assert pub._format_tracks[MediaFormat.avc].extradata == b"cfg1"
    pub.apply(EventBox.just(sample(b"cfg1", 40040)))  # unchanged: no re-send
    pub.apply(EventBox.just(sample(b"cfg2", 60060)))  # SPS change
    assert pub._format_tracks[MediaFormat.avc].extradata == b"cfg2"
    # the receiving side reconstructs with the updated extradata
    srv = fl.FlavorSessionCore(is_server=True, asset_id="s")
    srv.peer_pushing = True
    srv.established = True
    _, samples = srv.feed(conn.sent)
    assert samples and samples[-1].side_data().get("config") == b"cfg2"
