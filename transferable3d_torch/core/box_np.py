"""Host-side (numpy) box helpers the data code needs.

JAX-free copy of `in_hull_np` (`transferable3d_tpu/core/box_np.py:282`),
which the synthetic generator calls to label its points. The JAX
package's `core/__init__.py` imports JAX, so the port cannot import the
original.
"""

from __future__ import annotations

import numpy as np


def in_hull_np(points: np.ndarray, corners: np.ndarray) -> np.ndarray:
    """Boolean mask of points [N, 3] inside the (possibly rotated) box
    with corners [8, 3] in the canonical order of core/geometry.py."""
    center = corners.mean(axis=0)
    # Axes from the canonical order: x = c0 - c3, z = c0 - c1, y = c4 - c0.
    x_axis = corners[0] - corners[3]
    z_axis = corners[0] - corners[1]
    y_axis = corners[4] - corners[0]
    l = np.linalg.norm(x_axis)
    w = np.linalg.norm(z_axis)
    h = np.linalg.norm(y_axis)
    x_axis, z_axis, y_axis = x_axis / l, z_axis / w, y_axis / h
    rel = points - center
    px = rel @ x_axis
    py = rel @ y_axis
    pz = rel @ z_axis
    return ((np.abs(px) <= l / 2 + 1e-6)
            & (np.abs(py) <= h / 2 + 1e-6)
            & (np.abs(pz) <= w / 2 + 1e-6))
