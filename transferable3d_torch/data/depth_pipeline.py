"""Fully on-device training pipeline: raw depth maps -> train batch.

Port of `transferable3d_tpu/data/depth_pipeline.py`. The host supplies
(depth, K, boxes2d, ground-truth box parameters); lifting, cropping,
sampling and rotating (data/frustum_jit.py), the seg labels (a
point-in-box test against the rotated ground-truth box) and the heading
and size bin encoding all run on the device, and the batch stays there
for the train step.

  * `scene_to_train_batch`: depth scenes -> the flat batch the train
    step takes, [F*MB, ...];
  * `make_depth_scene`: host-side numpy generator of synthetic depth
    maps with boxes, for tests and smoke training.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from transferable3d_torch import resolve_device
from transferable3d_torch.core import bins as bins_lib
from transferable3d_torch.core import geometry
from transferable3d_torch.data import frustum_jit


class DepthScene(NamedTuple):
    """One batch of frames, fixed shapes (numpy arrays from
    `make_depth_scene`, or tensors after `scene_to_device`)."""

    depth: torch.Tensor        # [F, H, W] meters
    K: torch.Tensor            # [3, 3] shared intrinsics
    boxes2d: torch.Tensor      # [F, MB, 4] (padded with zero-area boxes)
    box_valid: torch.Tensor    # [F, MB] bool
    center: torch.Tensor       # [F, MB, 3] ground-truth centers (camera)
    size: torch.Tensor         # [F, MB, 3] (l, w, h)
    heading: torch.Tensor      # [F, MB]
    class_idx: torch.Tensor    # [F, MB] int


def scene_to_device(scene: DepthScene, device=None) -> DepthScene:
    """The scene as tensors on `device` (default: the card): float32,
    bool `box_valid`, int64 `class_idx`. Tensors already there stay."""
    device = resolve_device(device)
    types = {"box_valid": torch.bool, "class_idx": torch.long}
    return DepthScene(**{
        k: torch.as_tensor(v).to(device=device,
                                 dtype=types.get(k, torch.float32))
        for k, v in scene._asdict().items()})


def points_in_box(points: torch.Tensor, center: torch.Tensor,
                  size: torch.Tensor, heading: torch.Tensor) -> torch.Tensor:
    """Point-in-box mask, one box per leading entry: points [B, N, 3],
    center [B, 3], size (l, w, h) [B, 3], heading [B] -> [B, N] bool."""
    rel = geometry.rotate_points_y(points - center[:, None, :], -heading)
    half = (size / 2.0)[:, None, :]
    return ((rel[..., 0].abs() <= half[..., 0] + 1e-6)
            & (rel[..., 1].abs() <= half[..., 2] + 1e-6)
            & (rel[..., 2].abs() <= half[..., 1] + 1e-6))


@torch.no_grad()
def scene_to_train_batch(scene: DepthScene, rng: frustum_jit.Phases,
                         npoints: int, cfg: bins_lib.BinConfig,
                         device=None) -> Dict[str, torch.Tensor]:
    """Depth scenes -> flat train batch [F*MB, ...], entirely on `device`.

    `rng` is a `torch.Generator` or the [F, MB] sampling phases. Padding
    boxes yield zero-count frustums; the `valid` column lets the loss
    mask them (`StepConfig(use_valid_weights=True)`). Besides the JAX
    batch's entries, `idx` holds the pixel each point was lifted from."""
    scene = scene_to_device(scene, device)
    f, mb = scene.boxes2d.shape[:2]
    out = frustum_jit.lift_depth_frustums(
        scene.depth, scene.K, scene.boxes2d, npoints, rng,
        device=scene.depth.device)
    points = out.points.reshape(f * mb, npoints, -1)
    angles = out.frustum_angle.reshape(f * mb)
    counts = out.count.reshape(f * mb)

    center = scene.center.reshape(f * mb, 3)
    size = scene.size.reshape(f * mb, 3)
    heading = scene.heading.reshape(f * mb)
    class_idx = scene.class_idx.reshape(f * mb)
    valid = scene.box_valid.reshape(f * mb) & (counts > 0)

    # The ground truth in the frustum frame (provider.rotate_to_center).
    center_rot = geometry.rotate_points_y(center[:, None, :], angles)[:, 0]
    heading_rot = heading + angles

    # Seg labels: in-box test against the rotated ground-truth box.
    seg = points_in_box(points[..., :3], center_rot, size,
                        heading_rot).to(torch.int32)

    hcls, hres = bins_lib.angle_to_class(heading_rot, cfg.num_heading_bin)
    scls, sres = bins_lib.size_to_class(size, class_idx, cfg)
    one_hot = torch.nn.functional.one_hot(
        class_idx, cfg.num_classes).to(torch.float32)

    return {
        "points": points,
        "seg": seg,
        "center": center_rot,
        "heading_class": hcls,
        "heading_residual": hres,
        "size_class": scls,
        "size_residual": sres,
        "one_hot": one_hot,
        "class_idx": class_idx,
        "frustum_angle": angles,
        "valid": valid,
        "count": counts,
        "idx": out.idx.reshape(f * mb, npoints),
    }


# ---------------------------------------------------------------------------
# Synthetic depth scenes (tests / smoke): numpy, on the host
# ---------------------------------------------------------------------------

def render_box_depth(h: int, w: int, K: np.ndarray, center: np.ndarray,
                     size: np.ndarray, heading: float,
                     background_depth: float = 8.0) -> np.ndarray:
    """Crude z-buffer render of one box over a flat background wall:
    each pixel's ray is intersected with the box's axis-aligned form in
    the box frame (slab method)."""
    u, v = np.meshgrid(np.arange(w), np.arange(h))
    dirs = np.stack([(u - K[0, 2]) / K[0, 0],
                     (v - K[1, 2]) / K[1, 1],
                     np.ones_like(u, np.float64)], axis=-1)  # [H, W, 3]
    rot = geometry.roty_np(np.float32(-heading))
    d = dirs @ rot.T
    o = (rot @ (-center)).astype(np.float64)
    half = np.array([size[0] / 2, size[2] / 2, size[1] / 2])

    with np.errstate(divide="ignore", invalid="ignore"):
        t1 = (-half - o) / d
        t2 = (half - o) / d
    tmin = np.nanmax(np.minimum(t1, t2), axis=-1)
    tmax = np.nanmin(np.maximum(t1, t2), axis=-1)
    hit = (tmax >= np.maximum(tmin, 0))
    depth = np.where(hit, tmin, background_depth)  # camera z = t * dz
    depth = depth * dirs[..., 2]
    return np.where(depth > 0.1, depth, background_depth).astype(np.float32)


def make_depth_scene(rng: np.random.RandomState, cfg: bins_lib.BinConfig,
                     n_frames: int = 2, boxes_per_frame: int = 2,
                     h: int = 120, w: int = 160) -> Tuple[DepthScene,
                                                          np.ndarray]:
    """Synthetic DepthScene (numpy arrays) + the intrinsics used."""
    K = np.array([[130.0, 0, w / 2], [0, 130.0, h / 2], [0, 0, 1]],
                 np.float64)
    depths = np.zeros((n_frames, h, w), np.float32)
    boxes2d = np.zeros((n_frames, boxes_per_frame, 4), np.float32)
    valid = np.zeros((n_frames, boxes_per_frame), bool)
    centers = np.zeros((n_frames, boxes_per_frame, 3), np.float32)
    sizes = np.ones((n_frames, boxes_per_frame, 3), np.float32)
    headings = np.zeros((n_frames, boxes_per_frame), np.float32)
    classes = np.zeros((n_frames, boxes_per_frame), np.int64)

    for fi in range(n_frames):
        depth = np.full((h, w), 8.0, np.float32)
        for bi in range(boxes_per_frame):
            k = rng.randint(cfg.num_classes)
            size = (np.asarray(cfg.mean_sizes[k], np.float32)
                    * rng.uniform(0.9, 1.1, 3).astype(np.float32))
            lateral = rng.uniform(-0.15, 0.15)
            center = np.array([0, 0, rng.uniform(3.5, 6.0)], np.float32)
            center[0] = lateral * center[2]
            center[1] = rng.uniform(-0.2, 0.4)
            heading = np.float32(rng.uniform(-np.pi, np.pi))
            box_depth = render_box_depth(h, w, K, center, size, heading)
            depth = np.minimum(depth, box_depth)
            corners = geometry.box_corners_np(center, size, heading)
            uv = (corners @ np.array([[K[0, 0], 0], [0, K[1, 1]],
                                      [K[0, 2], K[1, 2]]], np.float64)
                  / corners[:, 2:3])
            b2d = np.array([max(uv[:, 0].min(), 0),
                            max(uv[:, 1].min(), 0),
                            min(uv[:, 0].max(), w - 1),
                            min(uv[:, 1].max(), h - 1)], np.float32)
            boxes2d[fi, bi] = b2d
            valid[fi, bi] = True
            centers[fi, bi] = center
            sizes[fi, bi] = size
            headings[fi, bi] = heading
            classes[fi, bi] = k
        depths[fi] = depth

    scene = DepthScene(
        depth=depths, K=K.astype(np.float32), boxes2d=boxes2d,
        box_valid=valid, center=centers, size=sizes, heading=headings,
        class_idx=classes)
    return scene, K
