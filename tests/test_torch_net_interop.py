"""The port's network and wire layers against the JAX package's, on the CPU.

* Wire bytes: AMF0, RTMP chunks (serialize, and dechunk by the native and
  the Python route), RTMP media messages and metadata, flavor atoms,
  ``trak`` / ``mdia`` and RPC atoms, and the protobuf wire
  (``coded_sample_to_wire``, ``make_composition_to_wire``,
  ``composer_command_to_wire``).  Each case builds its values from one
  numpy seed in each package's own types; the port's bytes must equal the
  JAX package's, and each package must parse the other's.
* Interop over loopback: a port RTMP publisher into a JAX ``Rtmp`` server
  and a JAX publisher into a port server, and the same for flavor.
  Samples arrive byte-equal, with equal pts and dts.
* Twins of the net and proto cases of ``tests/test_fuzz_parsers.py`` and
  ``tests/test_composer_commands.py``.

Tolerance: none.
"""

import asyncio
import dataclasses
import socket
import struct
from types import SimpleNamespace

import numpy as np
import pytest

import swiftvideo_tpu.core as jax_core
import swiftvideo_tpu.media.coded as jax_coded
import swiftvideo_tpu.net.flavor as jax_flavor
import swiftvideo_tpu.net.rtmp as jax_rtmp
import swiftvideo_tpu.net.rtmp.chunks as jax_chunks
import swiftvideo_tpu.net.rtmp.media as jax_rtmp_media
import swiftvideo_tpu.proto as jax_proto
import swiftvideo_tpu.scene as jax_scene
import swiftvideo_tpu_torch.core as port_core
import swiftvideo_tpu_torch.media.coded as port_coded
import swiftvideo_tpu_torch.net.flavor as port_flavor
import swiftvideo_tpu_torch.net.rtmp as port_rtmp
import swiftvideo_tpu_torch.net.rtmp.chunks as port_chunks
import swiftvideo_tpu_torch.net.rtmp.media as port_rtmp_media
import swiftvideo_tpu_torch.proto as port_proto
import swiftvideo_tpu_torch.scene as port_scene
from swiftvideo_tpu_torch.net.rtmp import amf
from swiftvideo_tpu_torch.net.rtmp.chunks import (Chunk, ChunkDeserializer,
                                                  ChunkSerializer)
from swiftvideo_tpu_torch.net.rtmp.session import RtmpSessionCore

JAX = SimpleNamespace(core=jax_core, coded=jax_coded, fl=jax_flavor,
                      rtmp=jax_rtmp, chunks=jax_chunks, media=jax_rtmp_media,
                      proto=jax_proto, scene=jax_scene)
PORT = SimpleNamespace(core=port_core, coded=port_coded, fl=port_flavor,
                       rtmp=port_rtmp, chunks=port_chunks,
                       media=port_rtmp_media, proto=port_proto,
                       scene=port_scene)
BOTH = pytest.mark.parametrize("src,dst", [(PORT, JAX), (JAX, PORT)],
                               ids=["port_to_jax", "jax_to_port"])
needs_proto = pytest.mark.skipif(not port_proto.available(),
                                 reason="google.protobuf not available")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _bytes(rng, n):
    return rng.integers(0, 256, n, np.int64).astype(np.uint8).tobytes()


def _tp(tp):
    return (tp.value, tp.scale)


# --- wire bytes ---------------------------------------------------------------

def _amf_values(rng):
    return ["connect", float(rng.integers(0, 1 << 20)),
            {"app": "live", "ok": bool(rng.integers(0, 2)),
             "n": float(rng.normal()), "nested": {"k": [1.0, "x", None]}},
            None, [float(v) for v in rng.normal(size=5)],
            "x" * int(rng.integers(60000, 70000))]


@pytest.mark.parametrize("seed", [0, 1])
def test_amf_bytes_equal(seed):
    """AMF0 encode and decode: equal bytes, and each package parses the
    other's (long strings and ECMA arrays included)."""
    rng = np.random.default_rng(seed)
    vals = _amf_values(rng)
    mine = amf.serialize(vals)
    theirs = jax_rtmp.amf.serialize(vals)
    assert mine == theirs
    assert amf.parse(theirs) == jax_rtmp.amf.parse(mine) == vals
    ecma = {"duration": 0.0, "width": 1920.0, "encoder": "x"}
    assert amf.serialize([amf.EcmaArray(ecma)]) == \
        jax_rtmp.amf.serialize([jax_rtmp.amf.EcmaArray(ecma)])


def _messages(m, rng, count=200):
    msgs, ts = [], 0
    for _ in range(count):
        ts += int(rng.choice([0, 16, 33, 1000, 0x1000000]))
        size = int(rng.choice([0, 1, 7, 100, 128, 129, 4096, 20000]))
        msgs.append(m.chunks.Chunk(
            msg_stream_id=int(rng.integers(0, 2)), msg_length=size,
            msg_type=int(rng.choice([8, 9, 18])),
            chunk_stream_id=int(rng.choice([3, 4, 6, 300, 5000])),
            timestamp=ts % (1 << 32), timestamp_delta=16,
            data=_bytes(rng, size)))
    return msgs


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("chunk_size", [128, 4096])
def test_chunk_bytes_equal_and_dechunk(native, chunk_size):
    """Chunk serialize: equal bytes; the port's dechunker on either route
    gives the JAX dechunker's messages from the same bytes fed in the same
    pieces."""
    if native and not port_chunks.native_available():
        pytest.skip("libsvrtmp.so not available")
    msgs = {k: _messages(m, np.random.default_rng(3))
            for k, m in (("port", PORT), ("jax", JAX))}
    wire = {k: b"".join(m.chunks.ChunkSerializer(out_chunk_size=chunk_size)
                        .serialize(c) for c in msgs[k])
            for k, m in (("port", PORT), ("jax", JAX))}
    assert wire["port"] == wire["jax"]
    mine = ChunkDeserializer(in_chunk_size=chunk_size, native=native)
    theirs = jax_chunks.ChunkDeserializer(in_chunk_size=chunk_size,
                                          native=False)
    assert mine.native == native
    rng = np.random.default_rng(4)
    got, want, i = [], [], 0
    data = wire["jax"]
    while i < len(data):
        n = int(rng.integers(1, 5000))
        got += mine.feed(data[i:i + n])
        want += theirs.feed(data[i:i + n])
        i += n
    assert len(got) == len(want) == len(msgs["port"])
    assert [dataclasses.astuple(c) for c in got] == \
        [dataclasses.astuple(c) for c in want]


def _coded(m, rng, media_type, fmt, pts, dts, key=True, config=b"\x01cfg"):
    data = bytearray(_bytes(rng, int(rng.integers(20, 400))))
    if fmt == "avc":
        data[:5] = struct.pack(">I", len(data) - 4) + (b"\x65" if key
                                                       else b"\x41")
    return m.coded.CodedMediaSample(
        buffer=bytes(data), pts_value=m.core.TimePoint(pts, 1000),
        dts_value=m.core.TimePoint(dts, 1000),
        media_type=m.coded.MediaType[media_type],
        media_format=m.coded.MediaFormat[fmt], id_asset="cam",
        id_workspace="app", side={"config": config})


def _media_stream(m):
    rng = np.random.default_rng(5)
    out = []
    for i in range(40):
        fmt = ["avc", "hevc", "vp9", "av1"][i // 10]
        out.append(_coded(m, rng, "video", fmt, 33 * i + 66, 33 * i,
                          key=i % 10 == 0, config=b"v" + bytes([i // 20])))
        out.append(_coded(m, rng, "audio", "aac" if i < 20 else "opus",
                          21 * i, 21 * i, config=b"a" + bytes([i // 20])))
    return out


def test_rtmp_media_bytes_equal():
    """RTMP media messages (legacy AVC / AAC and Enhanced-RTMP hvc1, vp09,
    av01, Opus; config resends and the first-keyframe gate) and the
    onMetaData message: equal bytes."""
    wire = {}
    for name, m in (("port", PORT), ("jax", JAX)):
        ms = m.media.MediaSerializer(m.chunks.ChunkSerializer(4096), 1)
        wire[name] = [ms.serialize(s) for s in _media_stream(m)]
        desc = [m.coded.BasicVideoDescription(size=(1920, 1080)),
                m.coded.BasicAudioDescription(sample_rate=48000,
                                              channel_count=2,
                                              samples_per_packet=1024)]
        wire[name].append(m.media.create_metadata(
            desc, m.chunks.ChunkSerializer(), 1, m.coded.MediaFormat.hevc,
            m.coded.MediaFormat.opus))
    assert sum(w is not None for w in wire["port"]) > 60
    assert wire["port"] == wire["jax"]


def test_flavor_atoms_and_trak_bytes_equal():
    """flavor value atoms, ``trak``, ``mdia`` and the RPC atoms: equal
    bytes, and each package parses the other's."""
    rng = np.random.default_rng(6)
    vals = {"i": int(rng.integers(0, 1 << 30)), "big": 1 << 40,
            "f": float(rng.normal()), "s": "flavor", "b": True,
            "d": _bytes(rng, 33), "nested": {"x": 1, "list": [1, 2, "3"]}}
    assert port_flavor.encode_value(vals) == jax_flavor.encode_value(vals)
    (tag, body), = jax_flavor.parse_atoms(port_flavor.encode_value(vals))
    assert jax_flavor.decode_value(tag, body) == vals
    for extradata in (None, _bytes(rng, 40)):
        args = ("AVC1", 7, 3, 600600, True, extradata)
        mine = port_flavor.serialize_trak(port_flavor.TrackInfo(*args))
        assert mine == jax_flavor.serialize_trak(jax_flavor.TrackInfo(*args))
        (_, body), = jax_flavor.parse_atoms(mine)
        assert dataclasses.astuple(jax_flavor.parse_trak(body)) == args
    payload = _bytes(rng, 500)
    for dts in (None, 12345):
        assert port_flavor.serialize_mdia(3, 12346, dts, payload) == \
            jax_flavor.serialize_mdia(3, 12346, dts, payload)
    for fn in ("rpc_sync", "rpc_asyn"):
        assert getattr(port_flavor, fn)(9, "ping", b"p") == \
            getattr(jax_flavor, fn)(9, "ping", b"p")
    assert port_flavor.rpc_rply(9, -1, b"x") == jax_flavor.rpc_rply(9, -1,
                                                                    b"x")


def _proto_sample(m):
    tp = m.core.TimePoint
    return m.coded.CodedMediaSample(
        buffer=_bytes(np.random.default_rng(7), 300),
        pts_value=tp(100, 600600), dts_value=tp(99, 600600),
        time_point=tp(5, 1000), media_type=m.coded.MediaType.video,
        media_format=m.coded.MediaFormat.hevc, id_asset="cam1",
        id_workspace="ws", token_workspace="tok",
        side={"config": b"\x01\x42\xc0"}, encoder="enc0",
        constituents_value=(m.coded.MediaConstituent(
            id_asset="src", pts=tp(7, 1000), duration=tp(33, 1000),
            constituents=(m.coded.MediaConstituent(
                id_asset="leaf", pts=tp(1, 1000)),)),))


def _proto_composition(m):
    s = m.scene
    st = s.ElementState(pic_pos=(10.0, 20.0), size=(640.0, 360.0),
                        rotation=0.25, pic_aspect=s.AspectMode.aspectFit,
                        fill_color=(0.1, 0.2, 0.3, 0.4), audio_gain=0.8)
    return s.Composition(
        name="show", canvas_size=(1280, 720),
        frame_duration=m.core.TimePoint(1000, 30000), sample_rate=44100,
        scenes=(s.Scene(name="main", elements=(
            s.Element(name="cam", initial_state=st, z_index=2),
            s.Element(name="bg", parent="cam"))),),
        initial_scene="main")


def _proto_commands(m):
    s, tp = m.scene, m.core.TimePoint
    return (
        s.ComposerCommand(set_scene=s.SetSceneCommand(scene="b"), ident=7,
                          after=(s.ComposerCommand(bind=s.BindCommand(
                              asset_id="cam", element="e")),)),
        s.ComposerCommand(load_file=s.LoadCommand(
            uri="file:///x.mp4", asset_id="clip", workspace_token="tok",
            loop=False, autoplay=True, close_on_end=True)),
        s.ComposerCommand(play_file=s.PlayFileCommand(asset_id="clip")),
        s.ComposerCommand(stop_file=s.StopFileCommand(asset_id="clip")),
        s.ComposerCommand(set_text=s.SetTextCommand(
            value="hello", font_size=32, font_url="/f.ttf", asset_id="txt",
            color=(0.5, 0.25, 0.125, 1.0))),
        s.ComposerCommand(set_state=s.SetStateCommand(
            element="e", state_id="s1", duration=tp(100, 1000))))


@needs_proto
def test_proto_wire_bytes_equal():
    """The protobuf wire of a coded sample, an RpcMakeComposition and a
    command tree: equal bytes (both packages share one message class, the
    generated modules being byte-identical), and each package reads the
    other's."""
    assert port_proto.pb().CodedMediaSampleWire is \
        jax_proto.pb().CodedMediaSampleWire
    mine = port_proto.coded_sample_to_wire(_proto_sample(PORT))
    assert mine == jax_proto.coded_sample_to_wire(_proto_sample(JAX))
    back = jax_proto.coded_sample_from_wire(mine)
    assert back.data() == _proto_sample(JAX).data()
    assert _tp(back.pts()) == (100, 600600)
    kw = dict(new_asset_id="out", epoch=1234)
    mine = port_proto.make_composition_to_wire(_proto_composition(PORT), **kw)
    assert mine == jax_proto.make_composition_to_wire(
        _proto_composition(JAX), **kw)
    # each package reads the same bytes into the same values (reprs name
    # the same enum members and dataclass fields in both packages)
    assert repr(port_proto.make_composition_from_wire(mine)) == \
        repr(jax_proto.make_composition_from_wire(mine))
    assert port_proto.make_composition_from_wire(mine)[1:] == ({}, 1234)
    mine = port_proto.composer_command_to_wire(_proto_commands(PORT))
    assert mine == jax_proto.composer_command_to_wire(_proto_commands(JAX))
    assert port_proto.composer_command_from_wire(mine) == \
        _proto_commands(PORT)


# --- interop over loopback ----------------------------------------------------

def _video_samples(m, n=60):
    rng = np.random.default_rng(8)
    return [_coded(m, rng, "video", "avc", 16 * i + 32, 16 * i,
                   key=i % 15 == 0, config=bytes(48)) for i in range(n)]


async def _rtmp_interop(src, dst, port):
    clock_s = dst.core.StepClock(dst.core.TimePoint(16, 1000))
    clock_c = src.core.StepClock(src.core.TimePoint(16, 1000))
    received, keep = [], []

    async def on_connection(pub, sub):
        if sub is not None:
            keep.append(sub >> dst.core.Tx(lambda s: (
                received.append(s), dst.core.EventBox.nothing(None))[1]))
        return True

    server = dst.rtmp.Rtmp(clock_s, on_connection=on_connection)
    await server.serve("127.0.0.1", port)
    pub, _ = await src.rtmp.Rtmp(clock_c).connect(
        f"rtmp://127.0.0.1:{port}/app/cam", publish_to_peer=True,
        max_attempts=3, retry_delay=0.2)
    for _ in range(14):                  # the 200 ms metadata grace timer
        clock_c.step()
        await asyncio.sleep(0)
    sent = []
    for s in _video_samples(src):
        if pub.apply(src.core.EventBox.just(s)).is_just():
            sent.append(s)
        clock_c.step()
        await asyncio.sleep(0)
    for _ in range(1000):                # at most 10 s on a loaded host
        await asyncio.sleep(0.01)
        if len(received) >= len(sent):
            break
    pub.close()
    await server.close()
    return sent, received


@BOTH
def test_rtmp_interop(src, dst):
    """A publisher of one package into the other's RTMP server: every
    sample arrives byte-equal with its pts and dts."""
    sent, received = asyncio.run(_rtmp_interop(src, dst, _free_port()))
    assert len(sent) == 60
    assert len(received) == len(sent)
    for s, r in zip(sent, received):
        assert r.data() == s.data()
        assert (_tp(r.pts()), _tp(r.dts())) == (_tp(s.pts()), _tp(s.dts()))
        assert r.media_format.value == s.media_format.value
        assert isinstance(r, dst.coded.CodedMediaSample)


async def _flavor_interop(src, dst, port):
    received, keep = [], []

    def on_subscriber(sub):
        keep.append(sub)
        keep.append(sub >> dst.core.Tx(lambda s: (
            received.append(s), dst.core.EventBox.nothing(None))[1]))

    server = dst.fl.Flavor(on_subscriber=on_subscriber)
    await server.serve("127.0.0.1", port)
    pub = await src.fl.Flavor().connect(f"flavor://127.0.0.1:{port}/ws/tok",
                                        push=True)
    rng = np.random.default_rng(9)
    sent = []
    for i in range(50):
        tp = src.core.TimePoint
        s = src.coded.CodedMediaSample(
            buffer=_bytes(rng, 1000 + 7 * i),
            pts_value=tp(i * 20020 + 40040, 600600),
            dts_value=tp(i * 20020, 600600),
            media_type=src.coded.MediaType.video,
            media_format=src.coded.MediaFormat.avc, id_asset="cam",
            side={"config": b"\x01cfg"})
        pub.apply(src.core.EventBox.just(s))
        sent.append(s)
        if i % 10 == 0:
            await asyncio.sleep(0)
    for _ in range(1000):                # at most 10 s on a loaded host
        await asyncio.sleep(0.01)
        if len(received) >= len(sent):
            break
    pub.close()
    await server.close()
    return sent, received


@BOTH
def test_flavor_interop(src, dst):
    """A flavor push from one package into the other's server: byte-equal
    payloads, equal pts and dts, the track's config and the token."""
    sent, received = asyncio.run(_flavor_interop(src, dst, _free_port()))
    assert len(received) == len(sent) == 50
    for s, r in zip(sent, received):
        assert r.data() == s.data()
        assert (_tp(r.pts()), _tp(r.dts())) == (_tp(s.pts()), _tp(s.dts()))
        assert r.side_data()["config"] == b"\x01cfg"
        assert r.workspace_token() == "ws/tok"


# --- twins of the net and proto cases of test_fuzz_parsers.py -----------------

RNG = np.random.default_rng(0xF022)
ALLOWED = (ValueError, amf.AmfError, port_flavor.FlavorError, KeyError,
           EOFError)


def _rand(n: int) -> bytes:
    return RNG.integers(0, 256, n, np.int64).astype(np.uint8).tobytes()


def _mutations(valid: bytes, n: int = 40):
    """Truncations and single-byte mutations of a valid message."""
    for cut in range(0, min(len(valid), 24)):
        yield valid[:cut]
    for _ in range(n):
        pos = int(RNG.integers(0, len(valid)))
        b = bytearray(valid)
        b[pos] ^= int(RNG.integers(1, 256))
        yield bytes(b)


def _survives(fn, blobs):
    for blob in blobs:
        try:
            fn(blob)
        except ALLOWED:
            pass


def test_amf_parse_garbage():
    valid = amf.serialize(["connect", 1.0, {"app": "live", "ok": True},
                           None, [1.0, "x"]])
    assert amf.parse(valid)[0] == "connect"
    _survives(amf.parse, _mutations(valid))
    _survives(amf.parse, (_rand(n) for n in (0, 1, 2, 7, 64, 1024)))
    for hostile in (b"\x0c\xff\xff\xff\xff" + b"ten bytes!",
                    b"\x0b" + b"\x00" * 9,
                    b"\x0a\x00\x00\x00\x01" * 2000,
                    b"\x08\x00\x00\x00\x01\x00\x01k" * 2000):
        with pytest.raises(amf.AmfError):
            amf.parse(hostile)
    nested = {"a": {"b": {"c": [1.0, {"d": "e"}]}}}
    assert amf.parse(amf.serialize([nested]))[0] == nested


def test_rtmp_chunk_deserializer_garbage():
    data = _rand(300)
    valid = ChunkSerializer().serialize(Chunk(
        msg_stream_id=1, msg_length=len(data), msg_type=9,
        chunk_stream_id=6, timestamp=1234, data=data))

    def run(blob):
        d = ChunkDeserializer()
        d.feed(blob)
        d.feed(blob[len(blob) // 2:])

    _survives(run, _mutations(valid))
    _survives(run, (_rand(n) for n in (1, 3, 12, 128, 4096)))


def test_rtmp_chunk_huge_declared_length_bounded():
    d = ChunkDeserializer()
    hdr = bytes([0x03]) + b"\x00\x00\x00" + b"\xff\xff\xff" + b"\x09" \
        + struct.pack("<I", 1)
    assert d.feed(hdr + b"\x00" * 64) == []


def test_flavor_atoms_garbage():
    fl = port_flavor
    valid = fl.serialize_atom("moov", fl.atom_dict({
        "trak": fl.atom_list([fl.atom_in32(5)]), "name": fl.atom_utf8("x")}))

    def run(blob):
        for tag, body in fl.parse_atoms(blob):
            fl.decode_value(tag, body)

    (tag, moov_body), = fl.parse_atoms(valid)
    assert tag == "moov"
    (dtag, dbody), = fl.parse_atoms(moov_body)
    assert fl.decode_value(dtag, dbody)["name"] == "x"
    _survives(run, _mutations(valid))
    _survives(run, (_rand(n) for n in (0, 3, 8, 100, 2048)))


def test_flavor_trak_garbage():
    fl = port_flavor
    t = fl.TrackInfo(fourcc="avc1", stream_id=1, track_id=3,
                     time_base=30000, uses_dts=True)
    tag, valid = next(iter(fl.parse_atoms(fl.serialize_trak(t))))
    assert tag == "trak" and fl.parse_trak(valid).track_id == 3
    _survives(fl.parse_trak, _mutations(valid))
    _survives(fl.parse_trak, (_rand(n) for n in (0, 4, 16, 256)))


def test_rtmp_ex_header_media_garbage():
    sess = RtmpSessionCore(is_server=True, asset_id="fuzz",
                           clock=port_core.StepClock(
                               port_core.TimePoint(16, 1000)))
    payloads = [b"\x80", b"\x90", b"\x81hvc", b"\x81hvc1",
                b"\x81hvc1\x00", b"\x81hvc1\x00\x00",
                b"\x8fhvc1" + _rand(8), b"\x91Opus", b"\x90Opus",
                b"\x81vp09", b"\x83vp09" + _rand(4),
                b"\x80av01" + _rand(30)]
    payloads += [bytes([0x80 | i]) + _rand(12) for i in range(16)]
    for data in payloads:
        for mtype in (0x8, 0x9):
            try:
                sess._handle_chunk(Chunk(
                    msg_stream_id=1, msg_length=len(data), msg_type=mtype,
                    chunk_stream_id=6, timestamp=0, timestamp_delta=0,
                    data=data))
            except ALLOWED:
                pass


def test_rtmp_session_handshake_garbage():
    for blob in (_rand(1), _rand(1537), _rand(3073), b"\x06" + _rand(1536)):
        sess = RtmpSessionCore(is_server=True, asset_id="fuzz")
        try:
            sess.feed(blob)
        except ALLOWED:
            pass


@needs_proto
def test_proto_wire_garbage():
    def run(blob):
        msg = port_proto.pb().CodedMediaSampleWire()
        try:
            msg.ParseFromString(blob)
        except Exception:  # noqa: BLE001 — protobuf DecodeError family
            return
        port_proto.coded_sample_from_pb(msg)

    _survives(run, (_rand(n) for n in (0, 4, 33, 256)))


# --- twins of the proto cases of test_composer_commands.py ---------------------

@needs_proto
def test_composer_command_proto_roundtrip():
    cmds = _proto_commands(PORT)
    assert port_proto.composer_command_from_wire(
        port_proto.composer_command_to_wire(cmds)) == cmds


@needs_proto
def test_composer_command_wire_rejects_unrepresentable():
    s = port_scene
    with pytest.raises(ValueError):
        port_proto.composer_command_to_wire(s.ComposerCommand(
            set_state=s.SetStateCommand(element="e", state=s.ElementState())))
    with pytest.raises(ValueError):
        port_proto.composer_command_to_wire(s.ComposerCommand(
            unbind=s.UnbindCommand(asset_id="cam")))


@needs_proto
def test_composer_command_wire_field_numbers():
    m = port_proto.composer_command_to_pb(port_scene.ComposerCommand(
        play_file=port_scene.PlayFileCommand(asset_id="a"), ident=3))
    node = m.commands[0]
    assert node.DESCRIPTOR.fields_by_name["playFile"].number == 7
    assert node.DESCRIPTOR.fields_by_name["loadFile"].number == 6
    assert node.DESCRIPTOR.fields_by_name["setText"].number == 9
    assert node.DESCRIPTOR.fields_by_name["after"].number == 1
    assert m.DESCRIPTOR.fields_by_name["commands"].number == 1
