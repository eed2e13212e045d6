"""Synthetic frustum generator for tests, smoke training and the chip
smoke run.

JAX-free copy of `transferable3d_tpu/data/synthetic.py` (numpy only):
random boxes drawn around each class's mean size, object points inside
the box (or on its visible surface with `hard=True`), clutter in the
frustum cone, exact seg labels from the box test. The same seed gives
the same records as the JAX package's generator.
"""

from __future__ import annotations

from typing import List

import numpy as np

from transferable3d_torch.core import bins as bins_lib
from transferable3d_torch.core import box_np
from transferable3d_torch.core import geometry
from transferable3d_torch.data.provider import FrustumRecord


def _surface_points(rng: np.random.RandomState, size: np.ndarray,
                    n: int) -> np.ndarray:
    """Points on the box surface, local frame (x: l, y: h, z: w)."""
    face = rng.randint(0, 6, n)
    u = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    axis = face // 2
    sign = np.where(face % 2 == 0, 0.5, -0.5).astype(np.float32)
    u[np.arange(n), axis] = sign
    u[:, 0] *= size[0]
    u[:, 1] *= size[2]
    u[:, 2] *= size[1]
    return u


def make_record(rng: np.random.RandomState, cfg: bins_lib.BinConfig,
                class_idx: int = None, n_object: int = 400,
                n_clutter: int = 200, extra_channels: int = 1,
                hard: bool = False) -> FrustumRecord:
    """One synthetic frustum in the frustum camera frame (Y down).

    `hard=True` switches to depth-sensor-like clouds (the regime the
    transfer mechanism targets, round-1 verdict item 3):
      * points on the box SURFACE only, back faces culled (a camera sees
        the facing surfaces, so the full extent must be inferred — the
        amodal problem);
      * class-conditional partial shapes: each class hides a different
        fixed face pattern (lookalike classes with distinct geometry);
      * random occlusion: a contiguous angular sector of object points
        dropped (p=0.4);
      * tighter clutter including a ground plane at the box bottom.
    """
    k = (rng.randint(cfg.num_classes) if class_idx is None else class_idx)
    mean = np.asarray(cfg.mean_sizes[k], np.float32)
    size = mean * rng.uniform(0.8, 1.25, 3).astype(np.float32)
    heading = np.float32(rng.uniform(-np.pi, np.pi))

    depth = rng.uniform(3.0, 15.0)
    lateral = rng.uniform(-0.25, 0.25) * depth
    # Y down: ground is at positive Y; put the box center slightly below
    # the camera horizon like a real indoor/outdoor object.
    center = np.array([lateral, rng.uniform(0.2, 1.2), depth], np.float32)
    frustum_angle = float(-np.arctan2(center[0], center[2]))

    if hard:
        # Surface cloud with back-face culling + sensor noise.
        local = _surface_points(rng, size, n_object * 3)
        world = geometry.rotate_points_y_np(local[None], heading)[0] + center
        # Outward normal (local) = sign of the pinned axis; visible if
        # the world-frame normal faces the camera at the origin.
        normals_local = np.zeros_like(local)
        amax = np.argmax(
            np.abs(local / np.array([size[0], size[2], size[1]])), axis=1)
        normals_local[np.arange(len(local)), amax] = np.sign(
            local[np.arange(len(local)), amax])
        normals = geometry.rotate_points_y_np(normals_local[None],
                                              heading)[0]
        visible = np.einsum("nc,nc->n", normals, world) < 0
        # Class-conditional partial shape: class k always misses face
        # (k % 3) in the local frame (distinct geometry per class).
        hidden_axis = k % 3
        keep = visible & ~(
            (amax == hidden_axis)
            & (np.sign(local[np.arange(len(local)), hidden_axis]) > 0))
        world = world[keep]
        if rng.rand() < 0.4 and len(world) > 8:  # occlusion sector
            ang = np.arctan2(world[:, 0] - center[0],
                             world[:, 2] - center[2])
            a0 = rng.uniform(-np.pi, np.pi)
            width = rng.uniform(0.5, 1.5)
            d = np.abs(np.mod(ang - a0 + np.pi, 2 * np.pi) - np.pi)
            world = world[d > width / 2]
        if len(world) == 0:
            world = center[None]
        sel = rng.randint(0, len(world), n_object)
        obj = world[sel] + rng.normal(0, 0.01 * depth / 10.0,
                                      (n_object, 3)).astype(np.float32)
    else:
        # Object points: uniform inside the box, rotated + translated.
        # Local axes before heading: x spans l, y spans h, z spans w.
        local = rng.uniform(-0.5, 0.5, (n_object, 3)).astype(np.float32)
        local[:, 0] *= size[0]
        local[:, 1] *= size[2]
        local[:, 2] *= size[1]
        obj = geometry.rotate_points_y_np(local[None], heading)[0] + center

    # Clutter: points spread through the frustum cone around the ray.
    t = rng.uniform(0.3, 1.4, (n_clutter, 1)).astype(np.float32)
    ray = center[None] * t
    clutter = ray + rng.normal(0, 0.8, (n_clutter, 3)).astype(np.float32)
    if hard:
        # Ground plane at the box bottom (Y down: bottom = +h/2).
        n_gr = n_clutter // 2
        gx = center[0] + rng.uniform(-2, 2, n_gr)
        gz = center[2] + rng.uniform(-2, 2, n_gr)
        gy = np.full(n_gr, center[1] + size[2] / 2)
        ground = np.stack([gx, gy, gz], -1).astype(np.float32)
        clutter = np.concatenate([clutter[:n_clutter - n_gr], ground], 0)

    pts = np.concatenate([obj, clutter], axis=0)
    if extra_channels:
        extra = rng.uniform(0, 1, (pts.shape[0], extra_channels))
        pts = np.concatenate([pts, extra.astype(np.float32)], axis=1)

    corners = geometry.box_corners_np(center, size, heading)
    seg = box_np.in_hull_np(pts[:, :3], corners).astype(np.int64)

    perm = rng.permutation(pts.shape[0])
    return FrustumRecord(points=pts[perm], seg=seg[perm], class_idx=int(k),
                         frustum_angle=frustum_angle, center=center,
                         size=size, heading=heading,
                         box2d=np.zeros(4, np.float32),
                         frame_id=f"synthetic_{rng.randint(1 << 30):08d}")


def make_dataset(n: int, cfg: bins_lib.BinConfig, seed: int = 0,
                 **kwargs) -> List[FrustumRecord]:
    rng = np.random.RandomState(seed)
    return [make_record(rng, cfg, **kwargs) for _ in range(n)]
