"""Where each source lands, worked out from the scene's element states.

SwiftVideo's picture animator (``animator.pic.swift:149-272``) places an
element from its state: the top-left corner and the size become three
rectangle vertices in float32, the size is read back from them, and the
element matrix is translation(pos, z) @ rotation @ scale(size), projected
by the canvas's orthographic matrix.  The mixer inverts each matrix in
float64 and rounds the inverse to float32.  A transition interpolates the
state linearly from its start state to its end state by the share of its
duration that has passed at the media time the sample passes the
animator.  The sound animator's transform is translation(audio_pos) @
scale(audio_gain) and its gain per channel is the smoothstep pan of
``mix.audio.swift:228-258``.

Plain numpy; imports nothing of the program.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Optional, Sequence, Tuple

import numpy as np

from .composite import Placement


@dataclass(frozen=True)
class State:
    """An element's state: top-left position and size in canvas pixels,
    transparency, z order, audio gain and pan position."""

    pos: Tuple[float, float]
    size: Tuple[float, float]
    transparency: float = 0.0
    z: int = 0
    audio_gain: float = 1.0
    audio_pos: Tuple[float, float] = (0.0, 0.0)


@dataclass(frozen=True)
class Transition:
    """A state change issued at media step ``start`` (in clock steps) that
    takes ``duration`` steps."""

    start: int
    duration: int
    to: State


def _lerp(a, b, pct):
    if isinstance(a, tuple):
        return tuple(x + (y - x) * pct for x, y in zip(a, b))
    return a + (b - a) * pct


def state_at(initial: State, transitions: Sequence[Transition],
             step: int) -> State:
    """The state at media step ``step``.  A transition interpolates from
    the state current when it was issued, by min(1, elapsed / duration),
    and its end state becomes current once it has run its duration; one
    issued before the last finished supersedes it, and the state current
    before the superseded one stays the start."""
    current, running = initial, None
    for t in transitions:
        if t.start > step:
            break
        if running is not None and t.start >= running.start + running.duration:
            current = running.to
        running = t
    if running is None:
        return current
    if step >= running.start + running.duration:
        return running.to
    return _interp(current, running, step)


def _interp(current: State, t: Transition, step: int) -> State:
    pct = min(1.0, (step - t.start) / t.duration)
    return replace(current, pos=_lerp(current.pos, t.to.pos, pct),
                   size=_lerp(current.size, t.to.size, pct),
                   transparency=_lerp(current.transparency,
                                      t.to.transparency, pct),
                   audio_gain=_lerp(current.audio_gain, t.to.audio_gain, pct),
                   audio_pos=_lerp(current.audio_pos, t.to.audio_pos, pct))


def _translation(x, y, z=0.0) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[0, 3], m[1, 3], m[2, 3] = x, y, z
    return m


def _scale(x, y) -> np.ndarray:
    return np.diag(np.array([x, y, 1.0, 1.0], dtype=np.float32))


def _ortho(w, h) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[1, 1] = 2.0 / w, 2.0 / h
    m[0, 3], m[1, 3], m[2, 3] = -1.0, -1.0, 1.0
    return m


def _inverse_affine(m: np.ndarray) -> np.ndarray:
    inv = np.linalg.inv(m.astype(np.float64)).astype(np.float32)
    return np.array([inv[0, 0], inv[0, 1], inv[1, 0], inv[1, 1], inv[0, 3],
                     inv[1, 3]], np.float32)


IDENTITY = np.array([1, 0, 0, 1, 0, 0], np.float32)
NO_FILL = np.zeros(4, np.float32)


def placement(state: State, canvas: Tuple[int, int]) -> Placement:
    """The source placement of an element in ``state`` on ``canvas``:
    unrotated, no border, no aspect fit, no fill."""
    rel = np.array([state.pos[0], state.pos[1], 0.0], np.float32)
    right = rel + np.array([state.size[0], 0, 0], np.float32)
    down = rel + np.array([0, state.size[1], 0], np.float32)
    size = np.array([right[0] - rel[0], down[1] - rel[1]], np.float32)
    rot = np.eye(4, dtype=np.float32)
    rot[0, 1] = -0.0  # -sin(0), as a rotation by 0 radians writes it
    proj = _ortho(*canvas)
    element = _translation(rel[0], rel[1], float(state.z)) @ rot \
        @ _scale(size[0], size[1])
    border = _translation(rel[0], rel[1]) @ rot @ _scale(size[0], size[1])
    return Placement(transform=_inverse_affine(proj @ element),
                     texture=IDENTITY,
                     border=_inverse_affine(proj @ border), fill=NO_FILL,
                     opacity=np.float32(1.0 - state.transparency))


# a source that covers its whole canvas: local = (ndc + 1) / 2
FULL_CELL = Placement(transform=np.array([0.5, 0, 0, 0.5, 0.5, 0.5],
                                         np.float32),
                      texture=IDENTITY,
                      border=np.array([0.5, 0, 0, 0.5, 0.5, 0.5], np.float32),
                      fill=NO_FILL, opacity=np.float32(1.0))


def channel_gains(state: State, channels: int,
                  transform: Optional[np.ndarray] = None) -> np.ndarray:
    """Per-channel float32 gains of an element's sound (mix.audio.swift:
    228-258): position and gain read from the float32 3x3 transform
    translation(audio_pos) @ scale(audio_gain), channels on a circle,
    smoothstep pan."""
    t = np.eye(3, dtype=np.float32)
    t[0, 2], t[1, 2] = state.audio_pos
    s = np.diag(np.array([state.audio_gain, state.audio_gain, 1.0],
                         np.float32))
    m = t @ s if transform is None else transform @ (t @ s)
    center = m @ np.array([0.0, 0.0, 1.0], np.float32)
    front = m @ np.array([0.0, 1.0, 1.0], np.float32)
    mag = front - center
    gain = float(np.sqrt(mag[0] * mag[0] + mag[1] * mag[1]))
    pos = center[:2]
    dims = min(channels - 1, 2)
    theta = 2.0 * math.pi / channels
    out = np.empty(channels, np.float32)
    for i in range(channels):
        px = math.cos(theta * i + theta / 2) - pos[0]
        py = math.sin(theta * i + theta / 2) - pos[1]
        if dims == 0:
            out[i] = gain
            continue
        d = 1.0 - px * 0.5 if dims == 1 else 1.0 - math.sqrt(px * px + py * py) * 0.5
        x = min(max(d / 0.5, 0.0), 1.0)
        out[i] = x * x * (3 - 2 * x) * gain
    return out
