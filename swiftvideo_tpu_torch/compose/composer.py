"""Composer: scene-graph orchestration binding assets into mixers.

Reference semantics: SwiftVideo's ``Sources/SwiftVideo/composer.swift``.

Owns one composition: an AudioMixer (audio frame duration + delay from the
manifest) and a VideoMixer share buses; ``bind(asset, element)`` splices a
per-asset chain —

  picture: pictureBus <- assetFilter >> GPUBarrierUpload >> Repeater
           >> PictureAnimator >> videoMixer            (composer.swift:210-211)
  audio:   audioBus <- assetFilter >> AudioSampleRateConversion
           >> SoundAnimator >> audioMixer              (composer.swift:212-214)

Ported from ``swiftvideo_tpu/compose/composer.py``: the chains run on the
compute context's torch device, and the built-in Load / SetText media
handlers are not yet ported (an ``action`` callback may claim them).

``set_scene`` / ``set_state`` drive animator transitions with futures;
``run_command`` executes recursive command trees with ``after``
continuations (composer.swift:141-183).
"""

from __future__ import annotations

from concurrent.futures import Future
from typing import Dict, Optional, Tuple

from ..core import Bus, Clock, TimePoint, asset_filter
from ..media.audio import AudioFormat
from ..media.pixel import PixelFormat
from ..scene import (ComposerCommand, Composition, Element,
                     ElementState, Scene)

from ..mix.animator import PictureAnimator, SoundAnimator
from ..mix.audio_mixer import AudioMixer
from ..mix.audio_stats import audio_stats
from ..mix.repeater import Repeater
from ..mix.src_audio import AudioSampleRateConversion
from ..mix.video_mixer import VideoMixer
from ..ops.barriers import GPUBarrierUpload
from ..ops.registry import ComputeContext, make_compute_context


class ComposerError(Exception):
    pass


class Composer:
    def __init__(self, clock: Clock, *, workspace_id: str,
                 composition: Composition,
                 audio_bus: Bus, picture_bus: Bus,
                 asset_id: Optional[str] = None,
                 compute_context: Optional[ComputeContext] = None,
                 output_format: PixelFormat = PixelFormat.y420p,
                 epoch: Optional[int] = None):
        self.clock = clock
        self.composition = composition
        self.audio_bus = audio_bus
        self.picture_bus = picture_bus
        self.ctx = compute_context or make_compute_context()
        self.id_workspace = workspace_id
        self.id_asset = asset_id or composition.name

        # mixers (composer.swift:58-75); both publish into the shared buses
        self.audio_mixer = AudioMixer(
            clock, workspace_id=workspace_id,
            frame_duration=composition.audio_frame_duration,
            sample_rate=composition.sample_rate,
            channel_count=composition.channel_count,
            delay=composition.audio_frame_duration * 4,  # 40 ms at 10 ms frames
            output_format=AudioFormat.s16i, asset_id=self.id_asset,
            epoch=epoch, compute_context=self.ctx)
        self.video_mixer = VideoMixer(
            clock, workspace_id=workspace_id,
            frame_duration=composition.frame_duration,
            output_size=composition.canvas_size,
            output_format=output_format, compute_context=self.ctx,
            asset_id=self.id_asset, epoch=epoch)
        # composer.swift:76-77
        self._picture_tx = self.video_mixer >> picture_bus
        self._audio_tx = self.audio_mixer >> audio_stats() >> audio_bus

        self._scenes: Dict[str, Scene] = {s.name: s for s in composition.scenes}
        self._elements: Dict[str, Tuple[Element, PictureAnimator,
                                        SoundAnimator]] = {}
        # keyed per (asset, element) like the reference's per-element
        # connectElement (composer.swift:203-224): one asset may feed
        # several elements (e.g. picture-in-picture of the same camera)
        self._bindings: Dict[Tuple[str, str], Tuple[object, object]] = {}
        # named states per element for wire StateSet commands, which carry
        # only a stateId (composer.swift:185-195 resolves
        # element.states[stateId]); populate via register_states() with the
        # extra_states mapping from proto.make_composition_from_pb
        self.named_states: Dict[str, Dict[str, ElementState]] = {}
        if composition.initial_scene:
            self.set_scene(composition.initial_scene)

    # --- scene management (composer.swift:111-195) ------------------------
    def set_scene(self, name: str) -> None:
        scene = self._scenes.get(name)
        if scene is None:
            raise ComposerError(f"unknown scene {name}")
        # The reference KEEPS animator objects across scene changes
        # (composer.swift:111-135 remaps the element table in place):
        # elements named in the new scene reuse their animators with
        # refreshed definition/state; elements not in it stay parked with
        # parents detached.  But its step 1 rebuilds every ElementAnimator
        # WITHOUT picTx/audioTx (composer.swift:117-124) and step 2
        # reconnects only the new scene's elements (connectElement,
        # composer.swift:128-131) — bindings to elements absent from the
        # new scene DISCONNECT.  Without this, a departed element's
        # Repeater keeps feeding its last frame into the VideoMixer (a
        # ghost overlay) and its audio keeps mixing.
        new_names = {e.name for e in scene.elements}
        stale = [k for k in self._bindings if k[1] not in new_names]
        for k in stale:
            self._bindings.pop(k, None)
        for asset_id in {k[0] for k in stale}:
            if not any(k[0] == asset_id for k in self._bindings):
                self.audio_mixer.remove_asset(asset_id)
        old = self._elements
        self._elements = {}
        for ename, (el, pic, soun) in old.items():
            pic.set_parent(None)
            soun.set_parent(None)
            self._elements[ename] = (el, pic, soun)
        for element in scene.elements:
            kept = self._elements.get(element.name)
            if kept is not None:
                _, pic, soun = kept
                pic.anchors = list(element.initial_state.parent_anchor or ())
                pic.z_index = element.z_index
            else:
                pic = PictureAnimator(
                    self.clock, self.composition.canvas_size,
                    parent_anchors=element.initial_state.parent_anchor or (),
                    z_index=element.z_index)
                soun = SoundAnimator(self.clock)
            self._elements[element.name] = (element, pic, soun)
        for element in scene.elements:
            _, pic, soun = self._elements[element.name]
            if element.parent and element.parent in self._elements:
                _, ppic, psoun = self._elements[element.parent]
                pic.set_parent(ppic)
                soun.set_parent(psoun)
            pic.set_state(element.initial_state, TimePoint(0, 1000))
            soun.set_state(element.initial_state, TimePoint(0, 1000))

    def set_state(self, element_id: str, state: ElementState,
                  duration: Optional[TimePoint] = None) -> Future:
        entry = self._elements.get(element_id)
        if entry is None:
            fut: Future = Future()
            fut.set_exception(ComposerError(f"unknown element {element_id}"))
            return fut
        _, pic, soun = entry
        d = duration if duration is not None else TimePoint(0, 1000)
        soun.set_state(state, d)
        return pic.set_state(state, d)

    def get_element_state(self, element_id: str) -> Optional[ElementState]:
        entry = self._elements.get(element_id)
        return entry[1].current_state if entry else None

    def register_states(self, element_id: str,
                        states: Dict[str, ElementState]) -> None:
        """Register named states for wire StateSet commands (the extra
        non-initial states a peer's Composition.proto Element carries;
        feed the ``extra_states`` mapping from
        ``proto.make_composition_from_pb`` through here)."""
        self.named_states.setdefault(element_id, {}).update(states)

    def set_state_by_id(self, element_id: str, state_id: str,
                        duration: Optional[TimePoint] = None) -> Future:
        """composer.swift:185-195 — resolve ``element.states[stateId]``."""
        state = self.named_states.get(element_id, {}).get(state_id)
        if state is None:
            fut: Future = Future()
            fut.set_exception(ComposerError(
                f"unknown state {state_id!r} for element {element_id!r}"))
            return fut
        return self.set_state(element_id, state, duration)

    # --- binding (composer.swift:93-101, 203-224) -------------------------
    def bind(self, asset_id: str, element_id: str) -> None:
        entry = self._elements.get(element_id)
        if entry is None:
            raise ComposerError(f"unknown element {element_id}")
        element, pic_anim, soun_anim = entry
        pic_chain = self.picture_bus.subscribe(
            asset_filter(asset_id) >> GPUBarrierUpload(self.ctx)
            >> Repeater(self.clock, self.composition.frame_duration)
            >> pic_anim >> self.video_mixer)
        soun_chain = self.audio_bus.subscribe(
            asset_filter(asset_id)
            >> AudioSampleRateConversion(self.composition.sample_rate,
                                         self.composition.channel_count,
                                         AudioFormat.s16i)
            >> soun_anim >> self.audio_mixer)
        self._bindings[(asset_id, element_id)] = (pic_chain, soun_chain)
        # connectElement(setInitialState: true) resets BOTH animators
        # (composer.swift:219-222)
        pic_anim.set_state(element.initial_state, TimePoint(0, 1000))
        soun_anim.set_state(element.initial_state, TimePoint(0, 1000))

    def unbind(self, asset_id: str,
               element_id: Optional[str] = None) -> None:
        # dropping the chains unsubscribes them (weak bus observers);
        # element_id narrows to one binding, default removes the asset
        # everywhere
        keys = [k for k in self._bindings
                if k[0] == asset_id and (element_id is None
                                         or k[1] == element_id)]
        for k in keys:
            self._bindings.pop(k, None)
        if keys and not any(k[0] == asset_id for k in self._bindings):
            self.audio_mixer.remove_asset(asset_id)

    # --- command trees (composer.swift:141-183) ---------------------------
    def run_command(self, command: ComposerCommand,
                    action=None) -> Future:
        """Execute a recursive command tree; ``after`` continuations run
        when the node's own work resolves.

        ``action`` mirrors the reference's app-delegation callback
        (composer.swift:141-183): it receives the command node and may
        return a Future to claim the media variants (load_file /
        play_file / stop_file / set_text) — and to sequence ``after``
        behind app work for scene/bind.  Unlike the reference (where an
        action returning nil silently SKIPS the bind,
        composer.swift:152-157), bind always executes here — after the
        action's future when one is returned.  Media variants an action
        does not claim raise ComposerError: the built-in handlers are not
        yet ported."""
        done: Future = Future()

        def run_after(_=None):
            futures = [self.run_command(sub, action)
                       for sub in command.after]
            if not futures:
                if not done.done():
                    done.set_result(True)
                return
            pending = len(futures)

            def one_done(_f):
                nonlocal pending
                pending -= 1
                if pending == 0 and not done.done():
                    done.set_result(True)

            for f in futures:
                f.add_done_callback(one_done)

        def forward(fut, then=run_after):
            # a failed step must fail the command and skip the `after`
            # continuations, not silently resolve True
            def _cb(f):
                exc = f.exception()
                if exc is not None:
                    if not done.done():
                        done.set_exception(exc)
                    return
                # a continuation raising inside a Future callback would
                # otherwise be logged-and-swallowed by concurrent.futures,
                # leaving `done` unresolved forever
                try:
                    then()
                except Exception as cont_exc:  # noqa: BLE001
                    if not done.done():
                        done.set_exception(cont_exc)
            fut.add_done_callback(_cb)

        def act():
            return action(command) if action is not None else None

        if command.set_scene is not None:
            self.set_scene(command.set_scene.scene)
            fut = act()
            forward(fut) if fut is not None else run_after()
        elif command.set_state is not None:
            cmd = command.set_state
            if cmd.state is not None:
                fut = self.set_state(cmd.element, cmd.state, cmd.duration)
            else:
                fut = self.set_state_by_id(cmd.element, cmd.state_id or "",
                                           cmd.duration)
            forward(fut)
        elif command.bind is not None:
            fut = act()

            def do_bind(_=None):
                self.bind(command.bind.asset_id, command.bind.element)
                run_after()

            forward(fut, do_bind) if fut is not None else do_bind()
        elif command.unbind is not None:
            self.unbind(command.unbind.asset_id)
            run_after()
        elif (command.load_file is not None or command.play_file is not None
              or command.stop_file is not None
              or command.set_text is not None):
            fut = act()
            if fut is None:
                self._media_not_ported(command)
            forward(fut)
        else:
            run_after()
        return done

    # --- built-in media command handlers -----------------------------------
    # The JAX package ships Load -> FileSource and SetText -> TextRenderer
    # defaults; both reach its codec layer, which loads JAX.  Until the port
    # has its own codec glue, an ``action`` callback must claim these
    # commands.

    def _media_not_ported(self, command: ComposerCommand) -> None:
        kind = next(k for k in ("load_file", "play_file", "stop_file",
                                "set_text")
                    if getattr(command, k) is not None)
        raise ComposerError(f"{kind}: built-in media handling is not yet "
                            "ported; claim the command with an action")

    def unload_asset(self, asset_id: str) -> None:
        """Drop an asset's bindings."""
        self.unbind(asset_id)

    # --- checkpoint / resume ----------------------------------------------
    # The reference's only resume story is explicit unix epochs so pts remain
    # derivable across restarts (SURVEY.md §5.4); here the scene graph and
    # element states snapshot to JSON as well.
    def snapshot(self) -> dict:
        from dataclasses import asdict
        from enum import Enum

        def enc(o):
            if isinstance(o, TimePoint):
                return {"__tp__": [o.value, o.scale]}
            if isinstance(o, Enum):
                return {"__enum__": [type(o).__name__, o.name]}
            if isinstance(o, dict):
                return {k: enc(v) for k, v in o.items()}
            if isinstance(o, (list, tuple)):
                return [enc(v) for v in o]
            return o

        return {
            "states": {name: enc(asdict(entry[1].current_state))
                       for name, entry in self._elements.items()
                       if entry[1].current_state is not None},
            "bindings": [[asset, element]
                         for (asset, element) in self._bindings],
        }

    def restore(self, snap: dict) -> None:
        # shared scene-JSON decoders (TimePoint/enum revival + re-tupling)
        from ..scene import _dec, _mk_state

        # bindings first: bind() resets elements to their initial state
        raw_b = snap.get("bindings", [])
        pairs = raw_b.items() if isinstance(raw_b, dict) else raw_b
        for asset, element in pairs:
            if ((asset, element) not in self._bindings
                    and element in self._elements):
                self.bind(asset, element)
        for name, raw in snap.get("states", {}).items():
            if name in self._elements:
                self.set_state(name, _mk_state(_dec(raw)))

    def close(self) -> None:
        self.video_mixer.close()
        self.audio_mixer.close()
