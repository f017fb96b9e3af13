"""Animators: per-element transforms with clock-timed transitions.

Reference semantics: SwiftVideo's ``Sources/SwiftVideo/animator.pic.swift``
and ``animator.soun.swift``.

``PictureAnimator`` is a ``Tx[PictureSample, PictureSample]`` holding a
current / next ``ElementState`` pair; ``set_state`` schedules transition
completion on the clock and ``impl`` stamps samples with interpolated
composition matrices (position/size/rotation/opacity/fill/border +
parent-anchored resize algebra + aspect fit/fill texture matrix).
``SoundAnimator`` does the same for audio gain/position, emitting a 3x3
transform composed with parent and sample transforms.
"""

from __future__ import annotations

import uuid
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np

from ..scene import (AspectMode, ElementState, PicOrigin,
                     PictureAnchor)
from ..core import Clock, EventBox, TimePoint, Tx, rescale, seconds
from ..media.audio import AudioSample
from ..media.picture import PictureSample
from ..utils import matrix as m4


@dataclass(frozen=True)
class ComputedPictureState:
    matrix: np.ndarray          # [0,1]^2 local -> canvas pixels
    texture_matrix: np.ndarray  # texture uv -> element local
    border_matrix: np.ndarray
    fill_color: np.ndarray
    opacity: float


def _lerp(a, b, pct: float):
    if isinstance(a, tuple):
        return tuple(x + (y - x) * pct for x, y in zip(a, b))
    return a + (b - a) * pct


def _interpolate_state(cur: ElementState, nxt: ElementState,
                       pct: float) -> ElementState:
    """animator.pic.swift:193-205"""
    return cur.with_(
        pic_pos=_lerp(cur.pic_pos, nxt.pic_pos, pct),
        size=_lerp(cur.size, nxt.size, pct),
        texture_offset=_lerp(cur.texture_offset, nxt.texture_offset, pct),
        rotation=_lerp(cur.rotation, nxt.rotation, pct),
        transparency=_lerp(cur.transparency, nxt.transparency, pct),
        pic_aspect=nxt.pic_aspect, pic_origin=nxt.pic_origin,
        fill_color=_lerp(cur.get_fill_color(), nxt.get_fill_color(), pct),
        border_size=_lerp(cur.border_size, nxt.border_size, pct))


def _compute_position_size(base_pos, base_size, parent_pos, parent_delta,
                           anchors) -> Tuple[np.ndarray, np.ndarray]:
    """Parent-anchored resize algebra (animator.pic.swift:149-191): three
    rect-defining vertices move with the parent's size delta according to
    which corners are anchored."""
    anchors = set(anchors)
    rel = np.array([base_pos[0] + parent_pos[0], base_pos[1] + parent_pos[1],
                    0.0], np.float32)
    verts = [rel.copy(),
             rel + np.array([base_size[0], 0, 0], np.float32),
             rel + np.array([0, base_size[1], 0], np.float32)]
    delta = np.array([parent_delta[0], parent_delta[1], 0], np.float32)
    dx = np.array([parent_delta[0], 0, 0], np.float32)
    dy = np.array([0, parent_delta[1], 0], np.float32)
    A = PictureAnchor
    if A.anchorBottomRight in anchors:
        verts = [v + delta for v in verts]
        if A.anchorBottomLeft in anchors:
            verts[0][0] = rel[0]
            verts[2][0] = rel[0]
        if A.anchorTopRight in anchors:
            verts[0][1] = rel[1]
            verts[1][1] = rel[1]
        if A.anchorTopLeft in anchors:
            verts[0] = rel.copy()
            verts[1] = rel + np.array([base_size[0], 0, 0], np.float32) + dx
            verts[2] = rel + np.array([0, base_size[1], 0], np.float32) + dy
    elif A.anchorTopRight in anchors:
        verts[1] = verts[1] + dx
        if A.anchorTopLeft not in anchors and A.anchorBottomLeft not in anchors:
            verts[0] = verts[0] + dx
            verts[2] = verts[2] + dx
        elif A.anchorBottomLeft in anchors:
            verts[2] = verts[2] + dy
    elif A.anchorBottomLeft in anchors:
        verts[2] = verts[2] + dy
        if A.anchorTopLeft not in anchors:
            verts[0] = verts[0] + dy
            verts[1] = verts[1] + dy
    pos = verts[0]
    size = np.array([verts[1][0] - verts[0][0], verts[2][1] - verts[0][1],
                     1.0], np.float32)
    return pos, size


def _compute_texture_matrix(sample_size, geometry_size, texture_offset,
                            aspect: AspectMode) -> np.ndarray:
    """Aspect fit / fill uv mapping (animator.pic.swift:207-227)."""
    if aspect == AspectMode.none or geometry_size[1] == 0 or sample_size[1] == 0:
        return m4.identity4()
    orig = sample_size[0] / sample_size[1]
    geom = geometry_size[0] / geometry_size[1]
    if aspect == AspectMode.aspectFit:
        sx = 1.0 if orig > geom else orig / geom
        sy = 1.0 if orig <= geom else geom / orig
    else:  # aspectFill
        sx = 1.0 if orig <= geom else orig / geom
        sy = 1.0 if orig > geom else geom / orig
    return (m4.translation(texture_offset[0] + (1.0 - sx) / 2,
                           texture_offset[1] + (1.0 - sy) / 2)
            @ m4.scale(sx, sy))


def compute_picture_state(sample: PictureSample,
                          parent_matrix: Optional[np.ndarray],
                          current: ElementState,
                          nxt: Optional[ElementState],
                          pct: Optional[float],
                          anchors: Sequence[PictureAnchor],
                          initial_parent_state: Optional[ComputedPictureState]
                          = None, z_index: int = 0) -> ComputedPictureState:
    """animator.pic.swift:229-272"""
    state = (_interpolate_state(current, nxt, pct)
             if nxt is not None and pct is not None else current)

    if parent_matrix is not None:
        parent_pos = parent_matrix[:3, 3]
        parent_size = np.array([
            np.hypot(parent_matrix[0, 0], parent_matrix[1, 0]),
            np.hypot(parent_matrix[0, 1], parent_matrix[1, 1]), 0.0],
            np.float32)
    else:
        parent_pos = np.zeros(3, np.float32)
        parent_size = np.zeros(3, np.float32)
    if initial_parent_state is not None:
        ipm = initial_parent_state.matrix
        initial_size = np.array([np.hypot(ipm[0, 0], ipm[1, 0]),
                                 np.hypot(ipm[0, 1], ipm[1, 1]), 0.0],
                                np.float32)
    else:
        initial_size = np.zeros(3, np.float32)
    parent_delta = parent_size - initial_size

    add = (np.zeros(3, np.float32) if state.pic_origin == PicOrigin.originTopLeft
           else -np.array([state.size[0] / 2, state.size[1] / 2, 0], np.float32))
    rel_pos, size = _compute_position_size(state.pic_pos, state.size,
                                           parent_pos, parent_delta, anchors)
    pos = rel_pos + add
    bs = state.border_size
    border_pos = pos - np.array([bs[0], bs[1], 0], np.float32)
    border_size = np.array([bs[0] + size[0] + bs[2], bs[1] + size[1] + bs[3],
                            1.0], np.float32)

    tex = _compute_texture_matrix(sample.size(), size, state.texture_offset,
                                  state.pic_aspect)
    rot = m4.rotation_z(state.rotation)
    return ComputedPictureState(
        matrix=m4.translation(pos[0], pos[1], float(z_index)) @ rot
        @ m4.scale(size[0], size[1]),
        texture_matrix=tex,
        border_matrix=m4.translation(border_pos[0], border_pos[1]) @ rot
        @ m4.scale(border_size[0], border_size[1]),
        fill_color=np.asarray(state.get_fill_color(), np.float32),
        opacity=1.0 - state.transparency)


class AnimatorError(Exception):
    pass


class PictureAnimator(Tx):
    """Per-element picture transform stage (animator.pic.swift:29-139)."""

    def __init__(self, clock: Clock, canvas_size: Tuple[int, int],
                 parent: Optional["PictureAnimator"] = None,
                 parent_anchors: Sequence[PictureAnchor] = (
                     PictureAnchor.anchorTopLeft,),
                 z_index: int = 0):
        self.clock = clock
        self.canvas_size = canvas_size
        self.current_state: Optional[ElementState] = None
        self.next_state: Optional[ElementState] = None
        self.transition_duration: Optional[TimePoint] = None
        self.current_start_time: Optional[TimePoint] = None
        self.revision_id = str(uuid.uuid4())
        self.parent = parent
        self.initial_parent_state: Optional[ComputedPictureState] = None
        self.anchors = list(parent_anchors)
        self.z_index = z_index
        self._transition_gen = 0
        super().__init__(self._impl)

    def set_parent(self, parent: Optional["PictureAnimator"]) -> None:
        self.parent = parent

    def set_state(self, state: ElementState, duration: TimePoint) -> Future:
        """animator.pic.swift:54-80: immediate when no current state or zero
        duration, otherwise a clock-scheduled transition."""
        fut: Future = Future()
        self._transition_gen += 1
        gen = self._transition_gen
        if self.current_state is None or duration.value <= 0:
            self.current_state = state
            self.next_state = None
            self.current_start_time = None
            self.transition_duration = None
            self.initial_parent_state = None
            self.anchors = (list(state.parent_anchor) if state.parent_anchor
                            else [PictureAnchor.anchorTopLeft])
            fut.set_result(True)
        else:
            now = self.clock.current()
            # `now + duration` adopts duration's SCALE (clock.swift:250-253
            # semantics), so a coarse duration (e.g. whole seconds) would
            # truncate `now` and fire the deadline early; normalize to the
            # finer scale first (the Repeater does the same at init)
            duration = rescale(duration, max(now.scale, duration.scale))
            self.current_start_time = now
            self.next_state = state
            self.transition_duration = duration

            def complete(_event):
                if self._transition_gen != gen:
                    # superseded by a later set_state: the stale
                    # deadline must not truncate the new transition
                    if not fut.done():
                        fut.set_result(True)
                    return
                self.anchors = (list(self.next_state.parent_anchor)
                                if self.next_state and self.next_state.parent_anchor
                                else [PictureAnchor.anchorTopLeft])
                if self.next_state is not None:
                    self.current_state = self.next_state
                self.next_state = None
                self.current_start_time = None
                self.transition_duration = None
                self.initial_parent_state = None
                if not fut.done():
                    fut.set_result(True)

            self.clock.schedule(now + duration, complete)
        return fut

    def computed_state(self, sample: PictureSample,
                       parent_state: Optional[ComputedPictureState] = None
                       ) -> ComputedPictureState:
        if self.current_state is None:
            raise AnimatorError("noCurrentState")
        pct = None
        if self.current_start_time is not None and \
                self.transition_duration is not None:
            # clamp: a sample arriving between the logical deadline and the
            # completion callback must hold AT the target, not extrapolate
            # past it (the reference leaves this unclamped and relies on a
            # prompt timer; at pct=1 interpolation equals the target, so
            # clamping is behavior-identical in the timely case)
            pct = min(1.0, seconds(self.clock.current()
                                   - self.current_start_time)
                      / seconds(self.transition_duration))
        return compute_picture_state(
            sample, parent_state.matrix if parent_state else None,
            self.current_state, self.next_state, pct, self.anchors,
            self.initial_parent_state, self.z_index)

    def _impl(self, sample: PictureSample) -> EventBox:
        if self.current_state is None or self.current_state.hidden:
            return EventBox.nothing(sample.info())
        try:
            parent_state = (self.parent.computed_state(sample)
                            if self.parent is not None else None)
            computed = self.computed_state(sample, parent_state)
            opacity = parent_state.opacity if parent_state is not None else 1.0
            if parent_state is not None and self.initial_parent_state is None:
                self.initial_parent_state = parent_state
            proj = m4.ortho(*self.canvas_size)
            return EventBox.just(sample.with_(
                matrix=proj @ computed.matrix,
                texture_matrix=computed.texture_matrix,
                border_matrix=proj @ computed.border_matrix,
                fill_color=computed.fill_color,
                opacity=computed.opacity * opacity,
                revision=self.revision_id))
        except AnimatorError:
            return EventBox.nothing(sample.info())


class SoundAnimator(Tx):
    """Per-element audio transform stage (animator.soun.swift:21-118)."""

    def __init__(self, clock: Clock, parent: Optional["SoundAnimator"] = None):
        self.clock = clock
        self.current_state: Optional[ElementState] = None
        self.next_state: Optional[ElementState] = None
        self.transition_duration: Optional[TimePoint] = None
        self.current_start_time: Optional[TimePoint] = None
        self.parent = parent
        self._transition_gen = 0
        super().__init__(self._impl)

    def set_parent(self, parent: Optional["SoundAnimator"]) -> None:
        self.parent = parent

    def set_state(self, state: ElementState, duration: TimePoint) -> Future:
        fut: Future = Future()
        self._transition_gen += 1
        gen = self._transition_gen
        if self.current_state is None or duration.value <= 0:
            self.current_state = state
            # an immediate state change cancels any pending transition
            # (mirrors PictureAnimator: stale next_state would keep
            # interpolating toward the superseded target)
            self.next_state = None
            self.current_start_time = None
            self.transition_duration = None
            fut.set_result(True)
        else:
            now = self.clock.current()
            # see PictureAnimator.set_state: keep the finer scale so the
            # deadline is not truncated to the duration's coarse scale
            duration = rescale(duration, max(now.scale, duration.scale))
            self.current_start_time = now
            self.next_state = state
            self.transition_duration = duration

            def complete(_event):
                if self._transition_gen != gen:
                    # superseded by a later set_state
                    if not fut.done():
                        fut.set_result(True)
                    return
                if self.next_state is not None:
                    self.current_state = self.next_state
                self.next_state = None
                self.current_start_time = None
                self.transition_duration = None
                if not fut.done():
                    fut.set_result(True)

            self.clock.schedule(now + duration, complete)
        return fut

    def computed_matrix(self) -> np.ndarray:
        """animator.soun.swift:104-118: T(pos) @ S(gain)."""
        if self.current_state is None:
            raise AnimatorError("noCurrentState")
        state = self.current_state
        if (self.next_state is not None and self.current_start_time is not None
                and self.transition_duration is not None):
            # clamped for the same late-callback reason as PictureAnimator
            pct = min(1.0, seconds(self.clock.current()
                                   - self.current_start_time)
                      / seconds(self.transition_duration))
            state = state.with_(
                audio_gain=_lerp(state.audio_gain, self.next_state.audio_gain, pct),
                audio_pos=_lerp(state.audio_pos, self.next_state.audio_pos, pct))
        return (m4.translation3(*state.audio_pos)
                @ m4.scale3(state.audio_gain))

    def _impl(self, sample: AudioSample) -> EventBox:
        if self.current_state is None or self.current_state.muted:
            return EventBox.nothing(sample.info())
        try:
            # chain order (animator.soun.swift:77-90): element transform
            # first, then parent, then the sample's own transform
            mat = self.computed_matrix()
            if self.parent is not None:
                mat = self.parent.computed_matrix() @ mat
            transform = sample.transform @ mat
            return EventBox.just(sample.with_(transform=transform))
        except AnimatorError:
            return EventBox.just(sample)
