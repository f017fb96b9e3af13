"""Scene-graph and composition manifests.

Reference semantics: ``/root/reference/Proto/Composition.proto:56-88``
(ElementState / Element / Scene / Composition) and
``/root/reference/Proto/Rpc.public.proto:24-124`` (RpcMakeComposition,
RpcComposerCommand, RpcEncodeConfig, mixer configs).  Implemented as plain
dataclasses with JSON (de)serialization instead of protobuf — same field
inventory, no protoc dependency; the flavor/RTMP wire paths use
media.wire's binary codec where needed.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field, replace
from enum import Enum
from typing import Optional, Tuple

from .core import TimePoint


class AspectMode(Enum):
    none = "none"
    aspectFit = "fit"
    aspectFill = "fill"


class PicOrigin(Enum):
    originTopLeft = "topLeft"
    originCenter = "center"


class PictureAnchor(Enum):
    anchorTopLeft = "topLeft"
    anchorTopRight = "topRight"
    anchorBottomLeft = "bottomLeft"
    anchorBottomRight = "bottomRight"


@dataclass(frozen=True)
class ElementState:
    """Animatable element state (Composition.proto ElementState)."""

    pic_pos: Tuple[float, float] = (0.0, 0.0)
    size: Tuple[float, float] = (0.0, 0.0)
    texture_offset: Tuple[float, float] = (0.0, 0.0)
    rotation: float = 0.0
    transparency: float = 0.0
    pic_aspect: AspectMode = AspectMode.none
    pic_origin: PicOrigin = PicOrigin.originTopLeft
    fill_color: Optional[Tuple[float, float, float, float]] = None
    border_size: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0)
    audio_gain: float = 1.0
    audio_pos: Tuple[float, float] = (0.0, 0.0)
    hidden: bool = False
    muted: bool = False
    parent_anchor: Tuple[PictureAnchor, ...] = ()

    def get_fill_color(self) -> Tuple[float, float, float, float]:
        """animator.pic.swift:335-342 — defaults to transparent black."""
        return self.fill_color if self.fill_color is not None else (0, 0, 0, 0)

    def with_(self, **kwargs) -> "ElementState":
        return replace(self, **kwargs)


@dataclass(frozen=True)
class Element:
    """A composable slot in a scene (Composition.proto Element)."""

    name: str
    initial_state: ElementState = field(default_factory=ElementState)
    parent: Optional[str] = None
    anchors: Tuple[PictureAnchor, ...] = ()
    z_index: int = 0


@dataclass(frozen=True)
class Scene:
    name: str
    elements: Tuple[Element, ...] = ()


@dataclass(frozen=True)
class Composition:
    """Canvas + scenes (Composition.proto Composition)."""

    name: str
    canvas_size: Tuple[int, int] = (1920, 1080)
    frame_duration: TimePoint = field(default_factory=lambda: TimePoint(1000, 30000))
    audio_frame_duration: TimePoint = field(default_factory=lambda: TimePoint(480, 48000))
    sample_rate: int = 48000
    channel_count: int = 2
    scenes: Tuple[Scene, ...] = ()
    initial_scene: str = ""


# --- RPC command tree (Rpc.public.proto:42-124) ----------------------------

@dataclass(frozen=True)
class EncodeConfig:
    """Encoder operating point (Rpc.public.proto RpcEncodeConfig; example
    values at Examples/Transcoding/main.swift:58-61)."""

    width: int = 1280
    height: int = 720
    video_bitrate: int = 3_000_000
    audio_bitrate: int = 96_000
    keyframe_interval: TimePoint = field(
        default_factory=lambda: TimePoint(2000, 1000))
    video_format: str = "avc"
    audio_format: str = "aac"


@dataclass(frozen=True)
class SetSceneCommand:
    scene: str


@dataclass(frozen=True)
class SetStateCommand:
    """Either a full ``state`` (native construction) or a ``state_id``
    naming one of the element's registered states (the wire form,
    Rpc.public.proto StateSet carries only ``stateId``); the Composer
    resolves ids against its named-state table."""

    element: str
    state: Optional[ElementState] = None
    duration: TimePoint = field(default_factory=lambda: TimePoint(0, 1000))
    state_id: Optional[str] = None


@dataclass(frozen=True)
class BindCommand:
    asset_id: str
    element: str


@dataclass(frozen=True)
class UnbindCommand:
    asset_id: str


@dataclass(frozen=True)
class LoadCommand:
    """Load a media file as an asset (Rpc.public.proto Load, :52-59).

    ``close_on_end`` drops the asset when playback drains (default keeps
    it alive so ``play_file`` can restart it; meaningless with
    ``loop=True``, matching the wire comment)."""

    uri: str
    asset_id: str
    workspace_token: str = ""
    loop: bool = False
    autoplay: bool = False
    close_on_end: bool = False


@dataclass(frozen=True)
class PlayFileCommand:
    """Start/resume a loaded file asset (wire ``playFile`` carries just
    the asset id string, Rpc.public.proto:75)."""

    asset_id: str


@dataclass(frozen=True)
class StopFileCommand:
    asset_id: str


@dataclass(frozen=True)
class SetTextCommand:
    """Render a text overlay asset (Rpc.public.proto Text, :60-66);
    ``color`` is RGBA in [0, 1] (the wire Vec4)."""

    value: str
    font_size: int = 24
    font_url: str = ""
    asset_id: str = ""
    color: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)


@dataclass(frozen=True)
class ComposerCommand:
    """Recursive command with ``after`` continuations
    (Rpc.public.proto RpcComposerCommand, composer.swift:141-183).

    scene/state/bind/unbind execute in the Composer; the media variants
    (load_file/play_file/stop_file/set_text) are delegated to the app's
    ``action`` callback like the reference, with built-in FileSource /
    TextRenderer handling when no action claims them
    (compose/composer.py run_command)."""

    set_scene: Optional[SetSceneCommand] = None
    set_state: Optional[SetStateCommand] = None
    bind: Optional[BindCommand] = None
    unbind: Optional[UnbindCommand] = None
    load_file: Optional[LoadCommand] = None
    play_file: Optional[PlayFileCommand] = None
    stop_file: Optional[StopFileCommand] = None
    set_text: Optional[SetTextCommand] = None
    ident: int = 0
    after: Tuple["ComposerCommand", ...] = ()


# --- JSON round-trip ------------------------------------------------------

def _encode(obj):
    """Recursive JSON encoder: TimePoints and Enums tag themselves BEFORE
    dataclass descent (dataclasses.asdict would flatten TimePoint first)."""
    import dataclasses as _dc
    if isinstance(obj, TimePoint):
        return {"__tp__": [obj.value, obj.scale]}
    if isinstance(obj, Enum):
        return {"__enum__": [type(obj).__name__, obj.name]}
    if _dc.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _encode(getattr(obj, f.name))
                for f in _dc.fields(obj)}
    if isinstance(obj, dict):
        return {k: _encode(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_encode(v) for v in obj]
    return obj


_ENUMS = {cls.__name__: cls for cls in (AspectMode, PicOrigin, PictureAnchor)}


def composition_to_json(comp: Composition) -> str:
    return json.dumps(_encode(comp))


def command_to_json(cmd: ComposerCommand) -> str:
    """Serialize a recursive command tree (RpcComposerCommand wire role)."""
    return json.dumps(_encode(cmd))


def _dec(o):
    """JSON -> TimePoint/enum-aware structure (shared by both decoders)."""
    if isinstance(o, dict):
        if "__tp__" in o:
            return TimePoint(*o["__tp__"])
        if "__enum__" in o:
            name, member = o["__enum__"]
            return _ENUMS[name][member]
        return {k: _dec(v) for k, v in o.items()}
    if isinstance(o, list):
        return [_dec(v) for v in o]
    return o


def _mk_state(d) -> ElementState:
    """dict -> ElementState with every sequence field re-tupled (lists
    would make states unequal to the originals and unhashable)."""
    d = dict(d)
    for key in ("pic_pos", "size", "texture_offset", "border_size",
                "audio_pos"):
        if d.get(key) is not None:
            d[key] = tuple(d[key])
    if d.get("fill_color") is not None:
        d["fill_color"] = tuple(d["fill_color"])
    d["parent_anchor"] = tuple(d.get("parent_anchor", ()) or ())
    return ElementState(**d)


def command_from_json(text: str) -> ComposerCommand:
    dec, mk_state = _dec, _mk_state

    def mk(raw) -> ComposerCommand:
        st = raw.get("set_state")
        text_raw = raw.get("set_text")
        return ComposerCommand(
            set_scene=SetSceneCommand(**raw["set_scene"])
            if raw.get("set_scene") else None,
            set_state=SetStateCommand(
                element=st["element"],
                state=mk_state(st["state"]) if st.get("state") else None,
                duration=st.get("duration") or TimePoint(0, 1000),
                state_id=st.get("state_id"))
            if st else None,
            bind=BindCommand(**raw["bind"]) if raw.get("bind") else None,
            unbind=UnbindCommand(**raw["unbind"]) if raw.get("unbind") else None,
            load_file=LoadCommand(**raw["load_file"])
            if raw.get("load_file") else None,
            play_file=PlayFileCommand(**raw["play_file"])
            if raw.get("play_file") else None,
            stop_file=StopFileCommand(**raw["stop_file"])
            if raw.get("stop_file") else None,
            set_text=SetTextCommand(
                **{**text_raw, "color": tuple(text_raw.get("color",
                                                           (1, 1, 1, 1)))})
            if text_raw else None,
            ident=raw.get("ident", 0),
            after=tuple(mk(sub) for sub in raw.get("after", ())))

    return mk(dec(json.loads(text)))


def composition_from_json(text: str) -> Composition:
    raw = _dec(json.loads(text))
    mk_state = _mk_state

    scenes = tuple(
        Scene(name=s["name"], elements=tuple(
            Element(name=e["name"], initial_state=mk_state(e["initial_state"]),
                    parent=e.get("parent"),
                    anchors=tuple(e.get("anchors", ())),
                    z_index=e.get("z_index", 0))
            for e in s["elements"]))
        for s in raw["scenes"])
    # every field with a dataclass default is optional in the JSON too —
    # a minimal hand-written manifest is {"name": ..., "scenes": [...]}
    return Composition(
        name=raw["name"],
        canvas_size=tuple(raw.get("canvas_size", (1920, 1080))),
        frame_duration=raw.get("frame_duration") or TimePoint(1000, 30000),
        audio_frame_duration=(raw.get("audio_frame_duration")
                              or TimePoint(480, 48000)),
        sample_rate=raw.get("sample_rate", 48000),
        channel_count=raw.get("channel_count", 2),
        scenes=scenes, initial_scene=raw.get("initial_scene", ""))
