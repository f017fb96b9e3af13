"""Protobuf wire interop with SwiftVideo peers.

The reference transports ``CodedMediaSample`` as a protobuf
``CodedMediaSampleWire`` (sample.coded.swift:87-195) and configures
compositions with ``RpcMakeComposition`` manifests
(Proto/Rpc.public.proto:24-124).  This package carries the same wire
contract: ``swiftvideo.proto`` re-declares the messages with identical
field numbers (that numbering IS the interop spec, like RTMP chunk ids),
protoc-compiled into ``generated/`` — see the ``proto`` target in
csrc/Makefile.  Converters below bridge the wire messages to the
framework's native types (media.coded.CodedMediaSample, scene.py
dataclasses).

Gated: importing the generated module requires ``google.protobuf``,
which not every machine has; ``available()`` reports the gate, and this
package imports without it.  The generated module is byte-identical to
the JAX package's: both register ``swiftvideo.proto`` into protobuf's
default descriptor pool, which accepts a second identical copy only.
"""

from __future__ import annotations

import importlib.util
import os
from typing import Dict, Optional, Tuple

_GEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "generated", "swiftvideo_pb2.py")
_pb = None


def available() -> bool:
    try:
        import google.protobuf  # noqa: F401
    except Exception:
        return False
    return os.path.exists(_GEN)


def pb():
    """The generated module (lazy; raises if protobuf is unavailable)."""
    global _pb
    if _pb is None:
        spec = importlib.util.spec_from_file_location("swiftvideo_pb2", _GEN)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _pb = mod
    return _pb


# --- TimePoint --------------------------------------------------------------

def timepoint_to_pb(tp, msg=None):
    from ..core import TimePoint  # noqa: F401
    m = msg if msg is not None else pb().TimePoint()
    m.value = int(tp.value)
    m.scale = int(tp.scale)
    return m


def timepoint_from_pb(m):
    from ..core import TimePoint
    return TimePoint(int(m.value), int(m.scale) or 1)


# --- CodedMediaSample (sample.coded.swift:87-195 wire) ----------------------

def coded_sample_to_pb(sample):
    """media.coded.CodedMediaSample -> CodedMediaSampleWire message."""
    m = pb().CodedMediaSampleWire()
    timepoint_to_pb(sample.pts(), m.pts)
    timepoint_to_pb(sample.dts(), m.dts)
    timepoint_to_pb(sample.time(), m.eventTime)
    m.idAsset = sample.asset_id()
    m.idWorkspace = sample.workspace_id()
    if sample.workspace_token():
        m.tokenWorkspace = sample.workspace_token()
    m.buffer = sample.data()
    for k, v in sample.side_data().items():
        m.side[k] = v
    m.mediatype = sample.media_type.value
    m.mediaformat = sample.media_format.value
    if sample.encoder:
        m.encoder = sample.encoder
    for c in sample.constituents():
        _constituent_to_pb(c, m.constituents.add())
    return m


def _constituent_to_pb(c, m):
    m.idAsset = c.id_asset
    timepoint_to_pb(c.pts, m.pts)
    if c.dts is not None:
        timepoint_to_pb(c.dts, m.dts)
    if c.duration is not None:
        timepoint_to_pb(c.duration, m.duration)
    if c.normalized_pts is not None:
        timepoint_to_pb(c.normalized_pts, m.normalizedPts)
    for sub in c.constituents:
        _constituent_to_pb(sub, m.constituents.add())
    return m


def _opt_tp(m):
    return timepoint_from_pb(m) if m.scale else None


def _constituent_from_pb(m):
    from ..media.coded import MediaConstituent
    return MediaConstituent(
        id_asset=m.idAsset, pts=timepoint_from_pb(m.pts),
        dts=_opt_tp(m.dts), duration=_opt_tp(m.duration),
        normalized_pts=_opt_tp(m.normalizedPts),
        constituents=tuple(_constituent_from_pb(s) for s in m.constituents))


def coded_sample_from_pb(m):
    from ..media.coded import CodedMediaSample, MediaFormat, MediaType
    return CodedMediaSample(
        buffer=bytes(m.buffer),
        pts_value=timepoint_from_pb(m.pts),
        dts_value=timepoint_from_pb(m.dts),
        time_point=timepoint_from_pb(m.eventTime),
        media_type=MediaType(m.mediatype),
        media_format=MediaFormat(m.mediaformat),
        id_asset=m.idAsset, id_workspace=m.idWorkspace,
        token_workspace=m.tokenWorkspace or None,
        side={k: bytes(v) for k, v in m.side.items()},
        encoder=m.encoder,
        constituents_value=tuple(_constituent_from_pb(c)
                                 for c in m.constituents))


def coded_sample_to_wire(sample) -> bytes:
    return coded_sample_to_pb(sample).SerializeToString()


def coded_sample_from_wire(data: bytes):
    m = pb().CodedMediaSampleWire()
    m.ParseFromString(data)
    return coded_sample_from_pb(m)


# --- scene graph (Composition.proto) ----------------------------------------

_ASPECT_TO_PB = {"none": 0, "fit": 1, "fill": 2}
_ORIGIN_TO_PB = {"center": 0, "topLeft": 1}
_ANCHOR_TO_PB = {"topLeft": 0, "topRight": 1, "bottomLeft": 2,
                 "bottomRight": 3}


def element_state_to_pb(st, z_index: int = 0, msg=None):
    m = msg if msg is not None else pb().ElementState()
    m.picPos.x, m.picPos.y = float(st.pic_pos[0]), float(st.pic_pos[1])
    m.picPos.z = float(z_index)
    m.size.x, m.size.y = float(st.size[0]), float(st.size[1])
    m.textureOffset.x = float(st.texture_offset[0])
    m.textureOffset.y = float(st.texture_offset[1])
    m.rotation = float(st.rotation)
    m.transparency = float(st.transparency)
    m.audioGain = float(st.audio_gain)
    m.audioPos.x, m.audioPos.y = (float(st.audio_pos[0]),
                                  float(st.audio_pos[1]))
    m.picAspect = _ASPECT_TO_PB[st.pic_aspect.value]
    m.picOrigin = _ORIGIN_TO_PB[st.pic_origin.value]
    fc = st.get_fill_color()
    m.fillColor.x, m.fillColor.y, m.fillColor.z, m.fillColor.w = (
        float(fc[0]), float(fc[1]), float(fc[2]), float(fc[3]))
    bs = st.border_size
    m.borderSize.x, m.borderSize.y, m.borderSize.z, m.borderSize.w = (
        float(bs[0]), float(bs[1]), float(bs[2]), float(bs[3]))
    m.hidden = bool(st.hidden)
    m.muted = bool(st.muted)
    for a in st.parent_anchor:
        m.parentAnchor.append(_ANCHOR_TO_PB[a.value])
    return m


def element_state_from_pb(m):
    from ..scene import AspectMode, ElementState, PicOrigin, PictureAnchor
    aspect = {0: AspectMode.none, 1: AspectMode.aspectFit,
              2: AspectMode.aspectFill}[m.picAspect]
    origin = {0: PicOrigin.originCenter, 1: PicOrigin.originTopLeft}[
        m.picOrigin]
    anchors = tuple({0: PictureAnchor.anchorTopLeft,
                     1: PictureAnchor.anchorTopRight,
                     2: PictureAnchor.anchorBottomLeft,
                     3: PictureAnchor.anchorBottomRight}[a]
                    for a in m.parentAnchor)
    fc = (m.fillColor.x, m.fillColor.y, m.fillColor.z, m.fillColor.w)
    st = ElementState(
        pic_pos=(m.picPos.x, m.picPos.y),
        size=(m.size.x, m.size.y),
        texture_offset=(m.textureOffset.x, m.textureOffset.y),
        rotation=m.rotation, transparency=m.transparency,
        pic_aspect=aspect, pic_origin=origin,
        fill_color=None if fc == (0.0, 0.0, 0.0, 0.0) else fc,
        border_size=(m.borderSize.x, m.borderSize.y, m.borderSize.z,
                     m.borderSize.w),
        audio_gain=m.audioGain, audio_pos=(m.audioPos.x, m.audioPos.y),
        hidden=m.hidden, muted=m.muted, parent_anchor=anchors)
    return st, int(round(m.picPos.z))


def composition_to_pb(comp, msg=None):
    """scene.Composition -> Composition message (scene graph only — the
    canvas/audio parameters ride in RpcMakeComposition, below)."""
    m = msg if msg is not None else pb().Composition()
    for scene in comp.scenes:
        sc = m.scenes[scene.name]
        for el in scene.elements:
            e = sc.elements[el.name]
            element_state_to_pb(el.initial_state, el.z_index,
                                e.states["initial"])
            e.initialState = "initial"
            if el.parent:
                e.parent = el.parent
    m.initialScene = comp.initial_scene
    return m


def composition_from_pb(m, *, name: str = "composition",
                        canvas_size=(1920, 1080), frame_duration=None,
                        audio_frame_duration=None, sample_rate: int = 48000,
                        channel_count: int = 2):
    """Composition message -> scene.Composition.

    The proto scene graph carries only the graph; mixer parameters come
    from the surrounding RpcMakeComposition (or these keyword defaults).
    Returns (composition, extra_states) where extra_states maps
    (scene, element) -> {state_id: ElementState} for the non-initial
    named states our single-initial-state model does not hold."""
    from ..core import TimePoint
    from ..scene import Composition, Element, Scene
    scenes = []
    extra: Dict[Tuple[str, str], Dict[str, object]] = {}
    for sname in sorted(m.scenes):
        sc = m.scenes[sname]
        elements = []
        for ename in sorted(sc.elements):
            e = sc.elements[ename]
            init_id = e.initialState or (sorted(e.states)[0]
                                         if e.states else "")
            states = {sid: element_state_from_pb(st)
                      for sid, st in e.states.items()}
            init_st, z = states.get(init_id, (None, 0))
            if init_st is None:
                from ..scene import ElementState
                init_st = ElementState()
            elements.append(Element(name=ename, initial_state=init_st,
                                    parent=e.parent or None, z_index=z))
            others = {sid: st for sid, (st, _z) in states.items()
                      if sid != init_id}
            if others:
                extra[(sname, ename)] = others
        scenes.append(Scene(name=sname, elements=tuple(elements)))
    comp = Composition(
        name=name, canvas_size=tuple(canvas_size),
        frame_duration=frame_duration or TimePoint(1000, 30000),
        audio_frame_duration=audio_frame_duration or TimePoint(480, 48000),
        sample_rate=sample_rate, channel_count=channel_count,
        scenes=tuple(scenes), initial_scene=m.initialScene)
    return comp, extra


# --- RpcMakeComposition (Rpc.public.proto:114-124) --------------------------

def make_composition_to_pb(comp, *, new_asset_id: Optional[str] = None,
                           epoch: int = 0):
    """scene.Composition (+ canvas/audio params) -> RpcMakeComposition."""
    m = pb().RpcMakeComposition()
    m.newAssetId = new_asset_id or comp.name
    m.video.width, m.video.height = comp.canvas_size
    timepoint_to_pb(comp.frame_duration, m.video.frameDuration)
    m.audio.sampleRate = comp.sample_rate
    m.audio.channels = comp.channel_count
    composition_to_pb(comp, m.composition)
    m.epoch = epoch
    return m


def make_composition_from_pb(m):
    """RpcMakeComposition -> (scene.Composition, extra_states, epoch)."""
    comp, extra = composition_from_pb(
        m.composition, name=m.newAssetId or "composition",
        canvas_size=(m.video.width or 1920, m.video.height or 1080),
        frame_duration=(timepoint_from_pb(m.video.frameDuration)
                        if m.video.frameDuration.scale else None),
        sample_rate=m.audio.sampleRate or 48000,
        channel_count=m.audio.channels or 2)
    return comp, extra, int(m.epoch)


def make_composition_to_wire(comp, **kw) -> bytes:
    return make_composition_to_pb(comp, **kw).SerializeToString()


def make_composition_from_wire(data: bytes):
    m = pb().RpcMakeComposition()
    m.ParseFromString(data)
    return make_composition_from_pb(m)


# --- RpcComposerCommand (Rpc.public.proto:40-79) -----------------------------

def composer_command_to_pb(commands, msg=None):
    """Native ComposerCommand tree(s) -> RpcComposerCommand.

    Accepts one command or a sequence (the wire message is a repeated
    list).  ``set_state`` nodes must carry ``state_id`` (the wire StateSet
    names a registered state; a raw ElementState is not representable —
    register it and send the id).  ``unbind`` has NO wire form in the
    reference protocol and raises."""
    from ..scene import ComposerCommand  # noqa: F401
    m = msg if msg is not None else pb().RpcComposerCommand()
    if not isinstance(commands, (list, tuple)):
        commands = [commands]

    def fill(cmd, node):
        node.ident = cmd.ident
        if cmd.set_scene is not None:
            node.scene = cmd.set_scene.scene
        elif cmd.set_state is not None:
            if cmd.set_state.state_id is None:
                raise ValueError(
                    "wire StateSet carries a stateId; register the state "
                    "and set SetStateCommand.state_id")
            node.elementState.elementId = cmd.set_state.element
            node.elementState.stateId = cmd.set_state.state_id
            timepoint_to_pb(cmd.set_state.duration,
                            node.elementState.duration)
        elif cmd.bind is not None:
            node.bind.assetId = cmd.bind.asset_id
            node.bind.elementId = cmd.bind.element
        elif cmd.unbind is not None:
            raise ValueError("unbind has no RpcComposerCommand wire form")
        elif cmd.load_file is not None:
            lf = cmd.load_file
            node.loadFile.uri = lf.uri
            node.loadFile.assetId = lf.asset_id
            node.loadFile.workspaceToken = lf.workspace_token
            node.loadFile.loop = lf.loop
            node.loadFile.autoplay = lf.autoplay
            node.loadFile.closeOnEnd = lf.close_on_end
        elif cmd.play_file is not None:
            node.playFile = cmd.play_file.asset_id
        elif cmd.stop_file is not None:
            node.stopFile = cmd.stop_file.asset_id
        elif cmd.set_text is not None:
            tx = cmd.set_text
            node.setText.value = tx.value
            node.setText.fontSize = tx.font_size
            node.setText.fontUrl = tx.font_url
            node.setText.assetId = tx.asset_id
            (node.setText.color.x, node.setText.color.y,
             node.setText.color.z, node.setText.color.w) = tx.color
        for sub in cmd.after:
            fill(sub, node.after.add())

    for cmd in commands:
        fill(cmd, m.commands.add())
    return m


def composer_command_from_pb(m):
    """RpcComposerCommand -> tuple of native ComposerCommand trees.

    StateSet nodes come back with ``state_id`` set (resolve against
    Composer.named_states); an empty oneof becomes a no-op node whose
    ``after`` still runs, matching composer.swift:144-146."""
    from ..scene import (BindCommand, ComposerCommand, LoadCommand,
                         PlayFileCommand, SetSceneCommand, SetStateCommand,
                         SetTextCommand, StopFileCommand)

    def mk(node):
        kw = dict(ident=node.ident,
                  after=tuple(mk(sub) for sub in node.after))
        which = node.WhichOneof("command")
        if which == "scene":
            kw["set_scene"] = SetSceneCommand(scene=node.scene)
        elif which == "elementState":
            st = node.elementState
            kw["set_state"] = SetStateCommand(
                element=st.elementId, state=None,
                duration=timepoint_from_pb(st.duration),
                state_id=st.stateId)
        elif which == "bind":
            kw["bind"] = BindCommand(asset_id=node.bind.assetId,
                                     element=node.bind.elementId)
        elif which == "loadFile":
            lf = node.loadFile
            kw["load_file"] = LoadCommand(
                uri=lf.uri, asset_id=lf.assetId,
                workspace_token=lf.workspaceToken, loop=lf.loop,
                autoplay=lf.autoplay, close_on_end=lf.closeOnEnd)
        elif which == "playFile":
            kw["play_file"] = PlayFileCommand(asset_id=node.playFile)
        elif which == "stopFile":
            kw["stop_file"] = StopFileCommand(asset_id=node.stopFile)
        elif which == "setText":
            tx = node.setText
            kw["set_text"] = SetTextCommand(
                value=tx.value, font_size=tx.fontSize, font_url=tx.fontUrl,
                asset_id=tx.assetId,
                color=(tx.color.x, tx.color.y, tx.color.z, tx.color.w))
        return ComposerCommand(**kw)

    return tuple(mk(node) for node in m.commands)


def composer_command_to_wire(commands) -> bytes:
    return composer_command_to_pb(commands).SerializeToString()


def composer_command_from_wire(data: bytes):
    m = pb().RpcComposerCommand()
    m.ParseFromString(data)
    return composer_command_from_pb(m)
