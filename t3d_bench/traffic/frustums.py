"""The benchmark's one traffic generator: seeded synthetic RGB-D frustums.

A frozen, numpy-only copy of the port's synthetic generator (the
non-`hard` path of `make_record`, with `in_hull` and the box geometry it
needs), so that a later change to the program cannot change the
benchmark's inputs. What differs between mixes is data: each mix is a
JSON file beside this one (`<traffic>.json`) that `load_mix` reads.

A record is a box of a SUN-RGBD class (sizes drawn around the class's
mean size), object points inside it and clutter spread through the
frustum's cone, with exact seg labels; the point count of each record is
drawn from the mix's ranges, so every seed gives records of the same
kinds in another order.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List

import numpy as np

HERE = Path(__file__).resolve().parent

_CORNER_SIGNS = np.array(
    [[+1, -1, +1], [+1, -1, -1], [-1, -1, -1], [-1, -1, +1],
     [+1, +1, +1], [+1, +1, -1], [-1, +1, -1], [-1, +1, +1]],
    dtype=np.float32)


def load_mix(name: str) -> Dict:
    """The traffic mix `name` (`<name>.json` beside this module)."""
    path = HERE / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no traffic mix {path}")
    return json.loads(path.read_text())


def roty_np(t) -> np.ndarray:
    c, s = np.cos(t), np.sin(t)
    zeros, ones = np.zeros_like(c), np.ones_like(c)
    rows = [np.stack([c, zeros, s], axis=-1),
            np.stack([zeros, ones, zeros], axis=-1),
            np.stack([-s, zeros, c], axis=-1)]
    return np.stack(rows, axis=-2).astype(np.float32)


def rotate_points_y_np(points: np.ndarray, angle) -> np.ndarray:
    """Rotate points [..., N, 3] about +Y by angle [...] (active)."""
    rot = roty_np(np.asarray(angle))
    return np.einsum("...ij,...nj->...ni", rot, points).astype(points.dtype)


def box_corners_np(center, size, heading) -> np.ndarray:
    l, w, h = size[..., 0], size[..., 1], size[..., 2]
    half = np.stack([l / 2, h / 2, w / 2], axis=-1)
    local = _CORNER_SIGNS * half[..., None, :]
    rotated = np.einsum("...ij,...nj->...ni", roty_np(np.asarray(heading)),
                        local)
    return (rotated + center[..., None, :]).astype(np.float32)


def in_hull_np(points: np.ndarray, corners: np.ndarray) -> np.ndarray:
    """Points [N, 3] inside the box given by its 8 corners."""
    center = corners.mean(axis=0)
    axes = [corners[0] - corners[3], corners[4] - corners[0],
            corners[0] - corners[1]]
    rel = points - center
    inside = np.ones(len(points), bool)
    for a in axes:
        length = np.linalg.norm(a)
        proj = rel @ (a / max(length, 1e-12))
        inside &= np.abs(proj) <= length / 2 + 1e-6
    return inside


def make_record(rng: np.random.RandomState, mean_sizes: np.ndarray,
                n_object: int, n_clutter: int, extra_channels: int,
                depth=(3.0, 15.0)) -> Dict:
    """One frustum in the camera frame (Y down), its box `depth` metres
    away (uniform over the range)."""
    k = rng.randint(len(mean_sizes))
    size = mean_sizes[k] * rng.uniform(0.8, 1.25, 3).astype(np.float32)
    heading = np.float32(rng.uniform(-np.pi, np.pi))
    depth = rng.uniform(*depth)
    lateral = rng.uniform(-0.25, 0.25) * depth
    center = np.array([lateral, rng.uniform(0.2, 1.2), depth], np.float32)
    frustum_angle = float(-np.arctan2(center[0], center[2]))

    local = rng.uniform(-0.5, 0.5, (n_object, 3)).astype(np.float32)
    local[:, 0] *= size[0]
    local[:, 1] *= size[2]
    local[:, 2] *= size[1]
    obj = rotate_points_y_np(local[None], heading)[0] + center
    t = rng.uniform(0.3, 1.4, (n_clutter, 1)).astype(np.float32)
    clutter = center[None] * t + rng.normal(
        0, 0.8, (n_clutter, 3)).astype(np.float32)
    pts = np.concatenate([obj, clutter], axis=0)
    if extra_channels:
        extra = rng.uniform(0, 1, (pts.shape[0], extra_channels))
        pts = np.concatenate([pts, extra.astype(np.float32)], axis=1)
    corners = box_corners_np(center, size, heading)
    seg = in_hull_np(pts[:, :3], corners).astype(np.int64)
    perm = rng.permutation(pts.shape[0])
    return {"points": pts[perm], "seg": seg[perm], "class_idx": int(k),
            "frustum_angle": frustum_angle, "center": center,
            "size": size.astype(np.float32), "heading": heading}


def make_records(mix: Dict, mean_sizes, channels: int, seed: int
                 ) -> List[Dict]:
    """`mix["records"]` records from `seed`; each record's object and
    clutter counts are drawn from the mix's [low, high] ranges, its
    depth from `mix["depth"]` (3 to 15 m, SUN-RGBD's indoor range, by
    default)."""
    rng = np.random.RandomState(seed)
    means = np.asarray(mean_sizes, np.float32)
    lo_o, hi_o = mix["object_points"]
    lo_c, hi_c = mix["clutter_points"]
    depth = mix.get("depth", (3.0, 15.0))
    return [make_record(rng, means, rng.randint(lo_o, hi_o + 1),
                        rng.randint(lo_c, hi_c + 1), channels - 3, depth)
            for _ in range(mix["records"])]


def frustum_frame(rec: Dict, max_points: int):
    """A record rotated to its frustum's center ray and cut to
    `max_points`: (points [m, C], seg [m], center [3], heading) in the
    frustum frame, as a device-resident dataset stores it."""
    ang = np.float32(rec["frustum_angle"])
    m = min(rec["points"].shape[0], max_points)
    pts = rec["points"][:m].astype(np.float32).copy()
    pts[:, :3] = rotate_points_y_np(pts[None, :, :3], ang)[0]
    center = rotate_points_y_np(
        np.asarray(rec["center"], np.float32)[None, None, :], ang)[0, 0]
    heading = np.float32(float(rec["heading"]) + float(ang))
    return pts, rec["seg"][:m], center, heading


def serving_batches(records: List[Dict], mix: Dict, num_classes: int,
                    seed: int) -> List[Dict[str, np.ndarray]]:
    """`mix["pool_batches"]` batches of `mix["batch"]` frustums for the
    predict step: each frustum is a record in its frustum frame with
    `mix["npoints"]` of its points drawn with replacement."""
    rng = np.random.RandomState(seed)
    b, n = mix["batch"], mix["npoints"]
    frames = [frustum_frame(r, mix["max_points"])[0] for r in records]
    out = []
    for _ in range(mix["pool_batches"]):
        idx = rng.randint(0, len(records), b)
        pts = np.zeros((b, n, frames[0].shape[1]), np.float32)
        cls = np.zeros(b, np.int64)
        for i, r in enumerate(idx):
            pts[i] = frames[r][rng.randint(0, len(frames[r]), n)]
            cls[i] = records[r]["class_idx"]
        out.append({"points": pts, "class_idx": cls,
                    "one_hot": np.eye(num_classes, dtype=np.float32)[cls]})
    return out


def pinned(batch: Dict[str, np.ndarray]):
    """A host batch as page-locked tensors, as a server holds the
    buffers it copies to the card from."""
    import torch

    return {k: torch.from_numpy(v).pin_memory() for k, v in batch.items()}


def step_indices(num_records: int, batch: int, seed: int):
    """Each step's [batch] record indices, without end: successive
    epochs' permutations, as the driver's device iterator draws them."""
    rng = np.random.RandomState(seed)
    while True:
        order = rng.permutation(num_records)
        for i in range(num_records // batch):
            yield order[i * batch:(i + 1) * batch]
