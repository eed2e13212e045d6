"""Rotations about +Y (camera frame: X right, Y down, Z forward).

JAX-free copy of `roty_np` and `rotate_points_y_np`
(`transferable3d_tpu/core/geometry.py:61-105`), used by
`train/test.rotate_back`. The JAX module imports JAX at import time.
"""

from __future__ import annotations

import numpy as np


def roty_np(t: np.ndarray) -> np.ndarray:
    """Rotation about +Y, batched: t [...] -> [..., 3, 3]."""
    c, s = np.cos(t), np.sin(t)
    zeros, ones = np.zeros_like(c), np.ones_like(c)
    rows = [
        np.stack([c, zeros, s], axis=-1),
        np.stack([zeros, ones, zeros], axis=-1),
        np.stack([-s, zeros, c], axis=-1),
    ]
    return np.stack(rows, axis=-2).astype(np.float32)


def rotate_points_y_np(points: np.ndarray, angle) -> np.ndarray:
    """Rotate points [..., N, 3] about +Y by angle [...] (active)."""
    rot = roty_np(np.asarray(angle))
    return np.einsum("...ij,...nj->...ni", rot, points).astype(points.dtype)
