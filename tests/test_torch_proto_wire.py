"""Twin of ``tests/test_proto_wire.py`` on the port (``swiftvideo_tpu_torch``).

Protobuf wire interop with SwiftVideo peers.

Verifies (a) native-type <-> wire-message roundtrips and (b) the raw
proto3 BYTES carry the reference's field numbers
(Proto/CodedMediaSample.proto:66-90, Proto/Rpc.public.proto:114-124) —
hand-decoded tags, no reference runtime needed."""

import pytest

from swiftvideo_tpu_torch import proto as svproto
from swiftvideo_tpu_torch.core import TimePoint
from swiftvideo_tpu_torch.media.coded import (CodedMediaSample, MediaConstituent,
                                        MediaFormat, MediaType)

pytestmark = pytest.mark.skipif(not svproto.available(),
                                reason="google.protobuf not available")


def _tags(data: bytes):
    """(field_number, wire_type) sequence of a serialized message's
    top-level fields (proto3 varint tag decoding)."""
    tags, pos = [], 0
    while pos < len(data):
        tag, shift = 0, 0
        while True:
            b = data[pos]
            pos += 1
            tag |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                break
        field, wtype = tag >> 3, tag & 7
        tags.append((field, wtype))
        if wtype == 0:          # varint
            while data[pos] & 0x80:
                pos += 1
            pos += 1
        elif wtype == 2:        # length-delimited
            ln, shift = 0, 0
            while True:
                b = data[pos]
                pos += 1
                ln |= (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    break
            pos += ln
        elif wtype == 5:
            pos += 4
        elif wtype == 1:
            pos += 8
        else:
            raise AssertionError(f"unexpected wire type {wtype}")
    return tags


def test_timepoint_wire_bytes():
    """TimePoint{value=3, scale=1000} must serialize to the exact proto3
    bytes a SwiftVideo peer emits (fields 1, 2 varint)."""
    b = svproto.timepoint_to_pb(TimePoint(3, 1000)).SerializeToString()
    assert b == bytes.fromhex("080310e807")
    assert svproto.timepoint_from_pb(svproto.pb().TimePoint.FromString(b)) \
        == TimePoint(3, 1000)


def _sample():
    return CodedMediaSample(
        buffer=b"\x00\x00\x00\x02\x65\xaa", pts_value=TimePoint(100, 600600),
        dts_value=TimePoint(99, 600600), time_point=TimePoint(5, 1000),
        media_type=MediaType.video, media_format=MediaFormat.avc,
        id_asset="cam1", id_workspace="ws", token_workspace="tok",
        side={"config": b"\x01\x42\xc0"}, encoder="enc0",
        constituents_value=(MediaConstituent(
            id_asset="src", pts=TimePoint(7, 1000),
            duration=TimePoint(33, 1000),
            constituents=(MediaConstituent(id_asset="leaf",
                                           pts=TimePoint(1, 1000)),)),))


def test_coded_sample_roundtrip():
    s = _sample()
    wire = svproto.coded_sample_to_wire(s)
    out = svproto.coded_sample_from_wire(wire)
    assert out.data() == s.data()
    assert out.pts() == s.pts() and out.dts() == s.dts()
    assert out.time() == s.time()
    assert out.asset_id() == "cam1" and out.workspace_id() == "ws"
    assert out.workspace_token() == "tok"
    assert out.side_data() == {"config": b"\x01\x42\xc0"}
    assert out.media_type == MediaType.video
    assert out.media_format == MediaFormat.avc
    assert out.encoder == "enc0"
    c = out.constituents()[0]
    assert c.id_asset == "src" and c.duration == TimePoint(33, 1000)
    assert c.dts is None                      # optional stays optional
    assert c.constituents[0].id_asset == "leaf"


def test_coded_sample_wire_field_numbers():
    """Top-level tags carry the reference's numbering: pts=1, dts=2,
    eventTime=3, idAsset=4, idWorkspace=5, tokenWorkspace=6, buffer=7,
    side=8, mediatype=9(varint, only when nonzero), mediaformat=10,
    encoder=12, constituents=14."""
    s = _sample().with_(media_format=MediaFormat.hevc)
    fields = {f for f, _ in _tags(svproto.coded_sample_to_wire(s))}
    assert {1, 2, 3, 4, 5, 6, 7, 8, 10, 12, 14} <= fields
    assert 11 not in fields and 13 not in fields


def test_make_composition_roundtrip():
    from swiftvideo_tpu_torch.scene import (AspectMode, Composition, Element,
                                      ElementState, Scene)
    st = ElementState(pic_pos=(10.0, 20.0), size=(640.0, 360.0),
                      rotation=0.25, pic_aspect=AspectMode.aspectFit,
                      fill_color=(0.1, 0.2, 0.3, 0.4), audio_gain=0.8)
    comp = Composition(
        name="show", canvas_size=(1280, 720),
        frame_duration=TimePoint(1000, 30000), sample_rate=44100,
        channel_count=2,
        scenes=(Scene(name="main",
                      elements=(Element(name="cam", initial_state=st,
                                        z_index=2),
                                Element(name="bg", parent="cam"))),),
        initial_scene="main")
    wire = svproto.make_composition_to_wire(comp, epoch=1234)
    out, extra, epoch = svproto.make_composition_from_wire(wire)
    assert epoch == 1234
    assert out.name == "show" and out.canvas_size == (1280, 720)
    assert out.frame_duration == TimePoint(1000, 30000)
    assert out.sample_rate == 44100
    assert out.initial_scene == "main"
    (scene,) = out.scenes
    els = {e.name: e for e in scene.elements}
    assert els["cam"].z_index == 2
    assert els["cam"].initial_state.pic_pos == (10.0, 20.0)
    assert els["cam"].initial_state.pic_aspect == AspectMode.aspectFit
    assert abs(els["cam"].initial_state.fill_color[3] - 0.4) < 1e-6
    assert els["bg"].parent == "cam"
    assert extra == {}


def test_make_composition_wire_field_numbers():
    """RpcMakeComposition numbering: newAssetId=1, outputConfigs=3(absent
    here), video=4, audio=5, composition=7, epoch=8."""
    from swiftvideo_tpu_torch.scene import Composition, Scene
    comp = Composition(name="c", scenes=(Scene(name="s"),),
                       initial_scene="s")
    wire = svproto.make_composition_to_wire(comp, epoch=9)
    fields = {f for f, _ in _tags(wire)}
    assert {1, 4, 5, 7, 8} <= fields


def test_foreign_states_preserved_as_extra():
    """A peer manifest with multiple named states per element: the
    initial state lands on the dataclass, the rest come back in the
    extra-states map (our model holds one initial state)."""
    m = svproto.pb().RpcMakeComposition()
    m.newAssetId = "peer"
    el = m.composition.scenes["s"].elements["cam"]
    el.initialState = "a"
    el.states["a"].size.x = 100.0
    el.states["b"].size.x = 200.0
    m.composition.initialScene = "s"
    comp, extra, _ = svproto.make_composition_from_pb(m)
    els = {e.name: e for e in comp.scenes[0].elements}
    assert els["cam"].initial_state.size[0] == 100.0
    assert extra[("s", "cam")]["b"].size[0] == 200.0
