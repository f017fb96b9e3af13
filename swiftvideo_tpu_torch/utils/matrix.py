"""Small 4x4 / 3x3 matrix helpers (numpy, float32, column-vector convention).

Replaces the reference's VectorMath dependency.  Convention here:
``v' = M @ [x, y, z, 1]`` with translation in the last column.  The reference
uses VectorMath's row-vector convention; only the *geometric effect* is
preserved (see animator.pic.swift:229-272 for the reference compositions).
"""

from __future__ import annotations

import numpy as np


def identity4() -> np.ndarray:
    return np.eye(4, dtype=np.float32)


def translation(x: float, y: float, z: float = 0.0) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[0, 3] = x
    m[1, 3] = y
    m[2, 3] = z
    return m


def scale(x: float, y: float, z: float = 1.0) -> np.ndarray:
    return np.diag(np.array([x, y, z, 1.0], dtype=np.float32))


def rotation_z(radians: float) -> np.ndarray:
    c, s = np.cos(radians), np.sin(radians)
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[0, 1] = c, -s
    m[1, 0], m[1, 1] = s, c
    return m


def ortho(width: float, height: float) -> np.ndarray:
    """Canvas pixels -> NDC [-1,1], y down (animator.pic.swift:326-333)."""
    m = np.eye(4, dtype=np.float32)
    m[0, 0] = 2.0 / width
    m[1, 1] = 2.0 / height
    m[0, 3] = -1.0
    m[1, 3] = -1.0
    m[2, 3] = 1.0
    return m


def inverse(m: np.ndarray) -> np.ndarray:
    return np.linalg.inv(m.astype(np.float64)).astype(np.float32)


# --- 3x3 audio transforms (position + gain, sample.audio.swift:167-169) ---

def identity3() -> np.ndarray:
    return np.eye(3, dtype=np.float32)


def translation3(x: float, y: float) -> np.ndarray:
    m = np.eye(3, dtype=np.float32)
    m[0, 2] = x
    m[1, 2] = y
    return m


def scale3(g: float) -> np.ndarray:
    return np.diag(np.array([g, g, 1.0], dtype=np.float32))


def audio_position_gain(transform: np.ndarray) -> tuple:
    """Decode (position, gain) from a 3x3 audio transform
    (mix.audio.swift:228-234): position = M @ (0,0,1); gain is the length of
    M @ (0,1,1) - position."""
    center = transform @ np.array([0.0, 0.0, 1.0], dtype=np.float32)
    front = transform @ np.array([0.0, 1.0, 1.0], dtype=np.float32)
    mag = front - center
    gain = float(np.sqrt(mag[0] * mag[0] + mag[1] * mag[1]))
    return (center[:2].astype(np.float32), gain)
