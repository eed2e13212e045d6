"""3D box geometry, rotations about +Y, and the rotated 3D / BEV IoU.

Port of `transferable3d_tpu/core/geometry.py` (camera frame: X right, Y
down, Z forward; size is (l, w, h); corner order as documented there).
The torch half (`roty`, `rotate_points_y`, `box_corners`, and the
branch-free Sutherland-Hodgman clip behind `box3d_iou`) takes a leading
batch dimension where the JAX code is vmapped. The numpy half
(`roty_np`, `rotate_points_y_np`, `box_corners_np`) is a JAX-free copy
for the data code and `train/test.rotate_back`; the JAX module imports
JAX at import time.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

# Canonical corner signs, [8, 3] multiplying (l/2, h/2, w/2) on (x, y, z).
_CORNER_SIGNS = np.array(
    [
        [+1, -1, +1],
        [+1, -1, -1],
        [-1, -1, -1],
        [-1, -1, +1],
        [+1, +1, +1],
        [+1, +1, -1],
        [-1, +1, -1],
        [-1, +1, +1],
    ],
    dtype=np.float32,
)
_MAX_VERTS = 8


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


def box_corners_np(center: np.ndarray, size: np.ndarray,
                   heading: np.ndarray) -> np.ndarray:
    """Centers [..., 3], sizes (l, w, h) [..., 3], headings [...] ->
    corners [..., 8, 3] float32."""
    l, w, h = size[..., 0], size[..., 1], size[..., 2]
    half = np.stack([l / 2, h / 2, w / 2], axis=-1)
    local = _CORNER_SIGNS * half[..., None, :]
    rot = roty_np(np.asarray(heading))
    rotated = np.einsum("...ij,...nj->...ni", rot, local)
    return (rotated + center[..., None, :]).astype(np.float32)


def roty(t: torch.Tensor) -> torch.Tensor:
    """Rotation about +Y, batched: t [...] -> [..., 3, 3]."""
    c, s = torch.cos(t), torch.sin(t)
    zeros, ones = torch.zeros_like(c), torch.ones_like(c)
    rows = [
        torch.stack([c, zeros, s], dim=-1),
        torch.stack([zeros, ones, zeros], dim=-1),
        torch.stack([-s, zeros, c], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def rotate_points_y(points: torch.Tensor, angle: torch.Tensor
                    ) -> torch.Tensor:
    """Rotate points [..., N, 3] about +Y by angle [...] (active)."""
    return torch.einsum("...ij,...nj->...ni", roty(angle), points)


def box_corners(center: torch.Tensor, size: torch.Tensor,
                heading: torch.Tensor) -> torch.Tensor:
    """Centers [..., 3], sizes (l, w, h) [..., 3], headings [...] ->
    corners [..., 8, 3]."""
    l, w, h = size[..., 0], size[..., 1], size[..., 2]
    half = torch.stack([l / 2, h / 2, w / 2], dim=-1)
    signs = torch.as_tensor(_CORNER_SIGNS, device=size.device)
    local = signs * half[..., None, :]
    rotated = torch.einsum("...ij,...nj->...ni", roty(heading), local)
    return rotated + center[..., None, :]


def _clip_halfplane(verts: torch.Tensor, count: torch.Tensor,
                    normal: torch.Tensor, offset: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Clip polygons (verts [B, K, 2], the first `count` [B] valid) to
    n.p + offset >= 0: each edge (p_i, p_i+1) emits p_i if inside and the
    edge/plane intersection if crossing, compacted in order by a cumsum
    scatter (geometry.py:149-180)."""
    b, k, _ = verts.shape
    idx = torch.arange(k, device=verts.device)
    active = idx[None] < count[:, None]
    nxt = torch.remainder(idx[None] + 1, torch.clamp_min(count, 1)[:, None])
    p = verts
    q = torch.gather(verts, 1, nxt[..., None].expand(-1, -1, 2))
    dp = p @ normal + offset[:, None]
    dq = q @ normal + offset[:, None]
    denom = torch.where(dp - dq == 0, torch.full_like(dp, 1e-12), dp - dq)
    inter = p + (dp / denom)[..., None] * (q - p)
    inside = (dp >= 0) & active
    crossing = ((dp >= 0) != (dq >= 0)) & active
    cand = torch.stack([p, inter], dim=2).reshape(b, 2 * k, 2)
    emit = torch.stack([inside, crossing], dim=2).reshape(b, 2 * k)
    pos = torch.cumsum(emit.long(), dim=1) - 1
    pos = torch.where(emit, pos, 2 * k)  # parked in a slot cut off below
    out = torch.zeros(b, 2 * k + 1, 2, dtype=verts.dtype,
                      device=verts.device)
    out.scatter_(1, pos[..., None].expand(-1, -1, 2), cand)
    return out[:, :k], emit.sum(dim=1)


def _polygon_area(verts: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """Shoelace over the first `count` [B] vertices of verts [B, K, 2]."""
    k = verts.shape[1]
    idx = torch.arange(k, device=verts.device)
    nxt = torch.remainder(idx[None] + 1, torch.clamp_min(count, 1)[:, None])
    valid = (idx[None] < count[:, None]).to(verts.dtype)
    x, z = verts[..., 0], verts[..., 1]
    xn = torch.gather(x, 1, nxt)
    zn = torch.gather(z, 1, nxt)
    cross = (x * zn - xn * z) * valid
    return torch.abs(cross.sum(dim=1)) / 2.0


def bev_intersection_area(center_a, size_a, heading_a,
                          center_b, size_b, heading_b) -> torch.Tensor:
    """Exact BEV (x, z-plane) intersection area [B] of box pairs: centers
    [B, 3], sizes (l, w, h) [B, 3], headings [B]."""
    dev, dt = center_a.device, center_a.dtype
    rel = heading_b - heading_a
    signs = torch.as_tensor(_CORNER_SIGNS[:4][:, [0, 2]], device=dev)
    half_b = torch.stack([size_b[:, 0] / 2, size_b[:, 1] / 2], dim=-1)
    local = signs[None] * half_b[:, None, :]                    # [B, 4, 2]
    c, s = torch.cos(rel), torch.sin(rel)
    rot = torch.stack([torch.stack([c, s], -1), torch.stack([-s, c], -1)],
                      dim=-2)                                   # [B, 2, 2]
    corners_b = torch.einsum("bij,bnj->bni", rot, local)
    dc = center_b - center_a
    ca, sa = torch.cos(-heading_a), torch.sin(-heading_a)
    dx = ca * dc[:, 0] + sa * dc[:, 2]
    dz = -sa * dc[:, 0] + ca * dc[:, 2]
    verts = torch.nn.functional.pad(
        corners_b + torch.stack([dx, dz], -1)[:, None],
        (0, 0, 0, _MAX_VERTS - 4))
    count = torch.full((center_a.shape[0],), 4, dtype=torch.long,
                       device=dev)
    la, wa = size_a[:, 0] / 2, size_a[:, 1] / 2
    for normal, offset in (((1.0, 0.0), la), ((-1.0, 0.0), la),
                           ((0.0, 1.0), wa), ((0.0, -1.0), wa)):
        verts, count = _clip_halfplane(
            verts, count, torch.tensor(normal, dtype=dt, device=dev), offset)
    return _polygon_area(verts, count)


def box3d_iou(center_a, size_a, heading_a, center_b, size_b, heading_b
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact (3D IoU [B], BEV IoU [B]) of box pairs; the batched twin of
    the JAX `box3d_iou_batched`."""
    inter_area = bev_intersection_area(center_a, size_a, heading_a,
                                       center_b, size_b, heading_b)
    area_a = size_a[:, 0] * size_a[:, 1]
    area_b = size_b[:, 0] * size_b[:, 1]
    iou_bev = inter_area / torch.clamp_min(area_a + area_b - inter_area,
                                           1e-8)
    # Y spans (Y down: a box occupies [cy - h/2, cy + h/2]).
    ymin = torch.maximum(center_a[:, 1] - size_a[:, 2] / 2,
                         center_b[:, 1] - size_b[:, 2] / 2)
    ymax = torch.minimum(center_a[:, 1] + size_a[:, 2] / 2,
                         center_b[:, 1] + size_b[:, 2] / 2)
    inter_vol = inter_area * torch.clamp_min(ymax - ymin, 0.0)
    vol_a = area_a * size_a[:, 2]
    vol_b = area_b * size_b[:, 2]
    iou3d = inter_vol / torch.clamp_min(vol_a + vol_b - inter_vol, 1e-8)
    return iou3d, iou_bev
