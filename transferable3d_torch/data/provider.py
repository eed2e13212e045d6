"""Frustum dataset provider: frustum records -> fixed-size train arrays.

JAX-free copy of `transferable3d_tpu/data/provider.py` (numpy only), so
the port builds the same labelled batches as the JAX package, array for
array: per example, `npoints` sampled (without replacement when the
frustum has enough points), rotation to the frustum-center axis,
optional flip / shift augmentation, the one-hot class, and the box
encoded as (center, heading class + residual, size class + residual).
Records are in the frustum camera frame (X right, Y down, Z forward).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np

from transferable3d_torch.core import bins as bins_lib
from transferable3d_torch.core import geometry


@dataclasses.dataclass
class FrustumRecord:
    """One (2D box -> frustum) example in the frustum camera frame."""

    points: np.ndarray          # [M, C] xyz + extra channels (intensity/rgb)
    seg: Optional[np.ndarray]   # [M] int {0,1} or None (weak / test examples)
    class_idx: int              # semantic class index into cfg.classes
    frustum_angle: float        # rotation about +Y aligning center ray to +Z
    center: Optional[np.ndarray] = None   # [3] box center (None if weak)
    size: Optional[np.ndarray] = None     # [3] (l, w, h)
    heading: Optional[np.ndarray] = None  # scalar heading angle
    box2d: Optional[np.ndarray] = None    # [4] 2D box (xmin,ymin,xmax,ymax)
    score: float = 1.0                    # 2D detector confidence
    frame_id: str = ""                    # source frame identifier
    calib_p: Optional[np.ndarray] = None  # [3, 4] rect->image P matrix


class FrustumDataset:
    """Indexable dataset over frustum records with reference semantics.

    Args mirror the reference constructor: npoints, rotate_to_center,
    random_flip, random_shift, one_hot.
    """

    def __init__(self, records: Sequence[FrustumRecord],
                 cfg: bins_lib.BinConfig, npoints: int = 1024,
                 rotate_to_center: bool = True, random_flip: bool = False,
                 random_shift: bool = False, one_hot: bool = True,
                 seed: int = 0):
        self.records = list(records)
        self.cfg = cfg
        self.npoints = npoints
        self.rotate_to_center = rotate_to_center
        self.random_flip = random_flip
        self.random_shift = random_shift
        self.one_hot = one_hot
        self.rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        return len(self.records)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        rec = self.records[i]
        pts = rec.points.astype(np.float32)
        m = pts.shape[0]

        # Fixed-size sampling with replacement (reference: np.random.choice).
        if m == 0:
            choice = np.zeros(self.npoints, np.int64)
            pts = np.zeros((1, rec.points.shape[1]), np.float32)
            seg = np.zeros(1, np.int64) if rec.seg is not None else None
        else:
            # Sample without replacement when the frustum has enough points
            # (keeps more unique geometry), with replacement otherwise.
            choice = self.rng.choice(m, self.npoints, replace=m < self.npoints)
            seg = rec.seg
        pts = pts[choice]
        seg_s = (seg[choice].astype(np.int64)
                 if seg is not None else np.zeros(self.npoints, np.int64))

        center = (np.zeros(3, np.float32) if rec.center is None
                  else np.asarray(rec.center, np.float32).copy())
        heading = float(rec.heading) if rec.heading is not None else 0.0
        size = (np.ones(3, np.float32) if rec.size is None
                else np.asarray(rec.size, np.float32).copy())

        # Rotate to the frustum-center axis: the frustum angle maps the
        # center ray onto +Z; headings shift by the same angle.
        if self.rotate_to_center:
            ang = np.float32(rec.frustum_angle)
            pts = pts.copy()
            pts[:, :3] = geometry.rotate_points_y_np(
                pts[None, :, :3], ang)[0]
            center = geometry.rotate_points_y_np(
                center[None, None, :], ang)[0, 0]
            heading = heading + float(ang)

        # Augmentation (reference train_util): flip about the YZ plane and
        # z-shift along the depth axis. Either one moves the cloud away
        # from the geometry the recorded 2D box + calib describe, so the
        # calib-exact reprojection loss must not use this example
        # (per-example `has_calib` gate; the angular-span surrogate takes
        # over — see train/semisup.py).
        calib_valid = rec.calib_p is not None and rec.box2d is not None
        if self.random_flip and self.rng.rand() > 0.5:
            pts[:, 0] = -pts[:, 0]
            center[0] = -center[0]
            heading = np.pi - heading
            calib_valid = False
        if self.random_shift:
            dist = np.sqrt(center[0] ** 2 + center[2] ** 2)
            shift = np.clip(self.rng.randn() * dist * 0.05, -dist * 0.2,
                            dist * 0.2)
            pts[:, 2] += shift
            center[2] += shift
            calib_valid = False

        hcls, hres = bins_lib.angle_to_class_np(np.float32(heading),
                                                self.cfg.num_heading_bin)
        scls, sres = bins_lib.size_to_class_np(
            size, np.int64(rec.class_idx), self.cfg)

        out = {
            "points": pts.astype(np.float32),
            "seg": seg_s,
            "center": center.astype(np.float32),
            "heading_class": np.int64(hcls),
            "heading_residual": np.float32(hres),
            "size_class": np.int64(scls),
            "size_residual": sres.astype(np.float32),
            "frustum_angle": np.float32(rec.frustum_angle),
            "class_idx": np.int64(rec.class_idx),
            "score": np.float32(rec.score),
            "box2d": (np.zeros(4, np.float32) if rec.box2d is None
                      else np.asarray(rec.box2d, np.float32)),
            "calib_p": (np.zeros((3, 4), np.float32)
                        if rec.calib_p is None
                        else np.asarray(rec.calib_p, np.float32)),
            "has_calib": np.float32(1.0 if calib_valid else 0.0),
        }
        if self.one_hot:
            oh = np.zeros(self.cfg.num_classes, np.float32)
            oh[rec.class_idx] = 1.0
            out["one_hot"] = oh
        return out

    def get_batch(self, idxs: Sequence[int]) -> Dict[str, np.ndarray]:
        """Stack examples into batch arrays (reference `get_batch`)."""
        items = [self[i] for i in idxs]
        return {k: np.stack([it[k] for it in items]) for k in items[0]}

    def epoch_batches(self, batch_size: int, shuffle: bool = True,
                      drop_last: bool = True):
        """Yield batches for one epoch."""
        order = np.arange(len(self))
        if shuffle:
            self.rng.shuffle(order)
        end = (len(self) // batch_size * batch_size if drop_last
               else len(self))
        for s in range(0, max(end, 0), batch_size):
            idx = order[s:s + batch_size]
            if len(idx) < batch_size and drop_last:
                break
            yield self.get_batch(idx)
