"""KITTI object-detection data access + frustum extraction.

Capability parity target: the reference's `kitti/kitti_object.py`,
`kitti/kitti_util.py` (SURVEY.md C1) and `kitti/prepare_data.py` (C2):
calibration parsing and velo<->rect<->image projections, label parsing,
per-(frame, 2D box) frustum cropping with frustum angle and per-point
segmentation labels, with 2D-box jitter augmentation.

Coordinate frames (KITTI devkit conventions):
  * velodyne: X forward, Y left, Z up.
  * rect camera: X right, Y down, Z forward == our frustum camera frame
    (core/geometry.py), so extracted records feed the provider directly.
  * KITTI 3D labels: (h, w, l), center at the box *bottom* face, ry about
    Y. We convert to our centroid-centered (l, w, h) + heading.

JAX-free copy of `transferable3d_tpu/data/kitti.py`;
tests/test_torch_data_prep.py holds it equal to the original.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from transferable3d_torch.core import box_np
from transferable3d_torch.core.geometry import box_corners_np
from transferable3d_torch.data.provider import FrustumRecord


# ---------------------------------------------------------------------------
# Calibration
# ---------------------------------------------------------------------------

def _inverse_rigid_trans(tr: np.ndarray) -> np.ndarray:
    """Invert a 3x4 [R|t]."""
    inv = np.zeros_like(tr)
    inv[:3, :3] = tr[:3, :3].T
    inv[:3, 3] = -tr[:3, :3].T @ tr[:3, 3]
    return inv


class Calibration:
    """KITTI calib file: P2 (rect->image), R0_rect, Tr_velo_to_cam."""

    def __init__(self, p2: np.ndarray, r0: np.ndarray, v2c: np.ndarray):
        self.P = np.asarray(p2, np.float64).reshape(3, 4)
        self.R0 = np.asarray(r0, np.float64).reshape(3, 3)
        self.V2C = np.asarray(v2c, np.float64).reshape(3, 4)
        self.C2V = _inverse_rigid_trans(self.V2C)
        # Camera intrinsics from P.
        self.c_u = self.P[0, 2]
        self.c_v = self.P[1, 2]
        self.f_u = self.P[0, 0]
        self.f_v = self.P[1, 1]
        self.b_x = self.P[0, 3] / (-self.f_u)
        self.b_y = self.P[1, 3] / (-self.f_v)

    @staticmethod
    def from_file(path: str) -> "Calibration":
        data: Dict[str, np.ndarray] = {}
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                key, vals = line.split(":", 1)
                try:
                    data[key] = np.array([float(x) for x in vals.split()])
                except ValueError:
                    continue
        return Calibration(
            data["P2"], data["R0_rect"], data["Tr_velo_to_cam"])

    @staticmethod
    def _cart2hom(pts: np.ndarray) -> np.ndarray:
        return np.hstack([pts, np.ones((pts.shape[0], 1))])

    # velo <-> rect
    def project_velo_to_ref(self, pts: np.ndarray) -> np.ndarray:
        return self._cart2hom(pts) @ self.V2C.T

    def project_ref_to_rect(self, pts: np.ndarray) -> np.ndarray:
        return pts @ self.R0.T

    def project_velo_to_rect(self, pts: np.ndarray) -> np.ndarray:
        return self.project_ref_to_rect(self.project_velo_to_ref(pts))

    def project_rect_to_ref(self, pts: np.ndarray) -> np.ndarray:
        return pts @ np.linalg.inv(self.R0).T

    def project_ref_to_velo(self, pts: np.ndarray) -> np.ndarray:
        return self._cart2hom(pts) @ self.C2V.T

    def project_rect_to_velo(self, pts: np.ndarray) -> np.ndarray:
        return self.project_ref_to_velo(self.project_rect_to_ref(pts))

    # rect <-> image
    def project_rect_to_image(self, pts: np.ndarray) -> np.ndarray:
        uvw = self._cart2hom(pts) @ self.P.T
        return uvw[:, :2] / uvw[:, 2:3]

    def project_image_to_rect(self, uv_depth: np.ndarray) -> np.ndarray:
        """[u, v, depth] -> rect xyz."""
        n = uv_depth.shape[0]
        x = ((uv_depth[:, 0] - self.c_u) * uv_depth[:, 2]) / self.f_u + self.b_x
        y = ((uv_depth[:, 1] - self.c_v) * uv_depth[:, 2]) / self.f_v + self.b_y
        out = np.zeros((n, 3))
        out[:, 0], out[:, 1], out[:, 2] = x, y, uv_depth[:, 2]
        return out


# ---------------------------------------------------------------------------
# Labels
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Object3d:
    """One KITTI label line."""

    type: str
    truncation: float
    occlusion: float
    alpha: float
    box2d: np.ndarray      # [4] xmin ymin xmax ymax
    h: float
    w: float
    l: float
    t: Tuple[float, float, float]  # bottom-center in rect frame
    ry: float
    score: float = 1.0

    @staticmethod
    def from_line(line: str) -> "Object3d":
        p = line.split()
        return Object3d(
            type=p[0], truncation=float(p[1]), occlusion=float(p[2]),
            alpha=float(p[3]),
            box2d=np.array([float(x) for x in p[4:8]], np.float32),
            h=float(p[8]), w=float(p[9]), l=float(p[10]),
            t=(float(p[11]), float(p[12]), float(p[13])), ry=float(p[14]),
            score=float(p[15]) if len(p) > 15 else 1.0)

    def center_size_heading(self):
        """Convert to our centroid-centered (l, w, h) box."""
        center = np.array(
            [self.t[0], self.t[1] - self.h / 2, self.t[2]], np.float32)
        size = np.array([self.l, self.w, self.h], np.float32)
        return center, size, np.float32(self.ry)


def read_label(path: str) -> List[Object3d]:
    with open(path) as f:
        return [Object3d.from_line(l) for l in f if l.strip()]


# ---------------------------------------------------------------------------
# Dataset accessor
# ---------------------------------------------------------------------------

class KittiObjectDataset:
    """Standard KITTI object layout: {root}/{split}/{velodyne,calib,label_2,image_2}."""

    def __init__(self, root: str, split: str = "training"):
        self.root = os.path.join(root, split)
        self.split = split

    def ids(self) -> List[str]:
        d = os.path.join(self.root, "velodyne")
        return sorted(os.path.splitext(f)[0] for f in os.listdir(d)
                      if f.endswith(".bin"))

    def get_lidar(self, idx: str) -> np.ndarray:
        path = os.path.join(self.root, "velodyne", f"{idx}.bin")
        return np.fromfile(path, dtype=np.float32).reshape(-1, 4)

    def get_calibration(self, idx: str) -> Calibration:
        return Calibration.from_file(
            os.path.join(self.root, "calib", f"{idx}.txt"))

    def get_label_objects(self, idx: str) -> List[Object3d]:
        return read_label(os.path.join(self.root, "label_2", f"{idx}.txt"))


# ---------------------------------------------------------------------------
# Frustum extraction
# ---------------------------------------------------------------------------

def random_shift_box2d(box2d: np.ndarray, rng: np.random.RandomState,
                       shift_ratio: float = 0.1) -> np.ndarray:
    """Jitter a 2D box by up to shift_ratio of its size (reference C2)."""
    xmin, ymin, xmax, ymax = box2d
    h, w = ymax - ymin, xmax - xmin
    cx, cy = (xmin + xmax) / 2, (ymin + ymax) / 2
    cx2 = cx + w * shift_ratio * (rng.random() * 2 - 1)
    cy2 = cy + h * shift_ratio * (rng.random() * 2 - 1)
    h2 = h * (1 + shift_ratio * (rng.random() * 2 - 1))
    w2 = w * (1 + shift_ratio * (rng.random() * 2 - 1))
    return np.array([cx2 - w2 / 2, cy2 - h2 / 2, cx2 + w2 / 2,
                     cy2 + h2 / 2], np.float32)


def frustum_angle_for_box(box2d: np.ndarray, calib: Calibration) -> float:
    """Rotation about +Y aligning the 2D-box center ray with +Z."""
    cx = (box2d[0] + box2d[2]) / 2
    cy = (box2d[1] + box2d[3]) / 2
    ray = calib.project_image_to_rect(
        np.array([[cx, cy, 20.0]]))[0]  # any positive depth works
    return float(-np.arctan2(ray[0], ray[2]))


def extract_frustum_records(
        dataset: KittiObjectDataset, idx: str,
        cfg=None,
        type_whitelist: Sequence[str] = ("Car", "Pedestrian", "Cyclist"),
        perturb_box2d: bool = False, augment_x: int = 1,
        rng: Optional[np.random.RandomState] = None,
        img_size: Tuple[int, int] = (1242, 375),
        min_points: int = 5) -> List[FrustumRecord]:
    """All frustum records for one frame from GT labels (reference
    `extract_frustum_data`, call stack §3.1)."""
    from transferable3d_torch.core import bins as bins_lib
    cfg = cfg or bins_lib.KITTI
    rng = rng or np.random.RandomState(0)
    calib = dataset.get_calibration(idx)
    objects = dataset.get_label_objects(idx)
    scan = dataset.get_lidar(idx)
    pts_rect = calib.project_velo_to_rect(scan[:, :3]).astype(np.float32)
    pts_intensity = scan[:, 3:4]
    pts_img = calib.project_rect_to_image(pts_rect)
    # Only points inside the image and in front of the camera.
    in_img = ((pts_img[:, 0] >= 0) & (pts_img[:, 0] < img_size[0])
              & (pts_img[:, 1] >= 0) & (pts_img[:, 1] < img_size[1])
              & (pts_rect[:, 2] > 0))

    records = []
    for obj in objects:
        if obj.type not in type_whitelist:
            continue
        center, size, heading = obj.center_size_heading()
        corners = box_corners_np(center, size, heading)
        for aug in range(augment_x):
            box2d = (random_shift_box2d(obj.box2d, rng)
                     if perturb_box2d and aug > 0 else obj.box2d)
            sel = (in_img
                   & (pts_img[:, 0] >= box2d[0]) & (pts_img[:, 0] < box2d[2])
                   & (pts_img[:, 1] >= box2d[1]) & (pts_img[:, 1] < box2d[3]))
            if sel.sum() < min_points:
                continue
            pts = np.concatenate(
                [pts_rect[sel], pts_intensity[sel]], axis=1)
            seg = box_np.in_hull_np(pts[:, :3], corners).astype(np.int64)
            records.append(FrustumRecord(
                points=pts.astype(np.float32), seg=seg,
                class_idx=cfg.class_index(obj.type),
                frustum_angle=frustum_angle_for_box(box2d, calib),
                center=center, size=size, heading=heading,
                box2d=box2d.astype(np.float32), frame_id=idx,
                calib_p=calib.P.astype(np.float32)))
    return records


def extract_frustum_records_from_detections(
        dataset: KittiObjectDataset, idx: str,
        detections: Sequence[Tuple[str, float, np.ndarray]],
        cfg=None,
        img_size: Tuple[int, int] = (1242, 375),
        min_points: int = 5) -> List[FrustumRecord]:
    """Frustums from provided 2D detections (classname, prob, box2d) —
    reference `extract_frustum_data_rgb_detection` (C2); no labels."""
    from transferable3d_torch.core import bins as bins_lib
    cfg = cfg or bins_lib.KITTI
    calib = dataset.get_calibration(idx)
    scan = dataset.get_lidar(idx)
    pts_rect = calib.project_velo_to_rect(scan[:, :3]).astype(np.float32)
    pts_intensity = scan[:, 3:4]
    pts_img = calib.project_rect_to_image(pts_rect)
    in_img = ((pts_img[:, 0] >= 0) & (pts_img[:, 0] < img_size[0])
              & (pts_img[:, 1] >= 0) & (pts_img[:, 1] < img_size[1])
              & (pts_rect[:, 2] > 0))
    records = []
    for classname, prob, box2d in detections:
        box2d = np.asarray(box2d, np.float32)
        sel = (in_img
               & (pts_img[:, 0] >= box2d[0]) & (pts_img[:, 0] < box2d[2])
               & (pts_img[:, 1] >= box2d[1]) & (pts_img[:, 1] < box2d[3]))
        if sel.sum() < min_points:
            continue
        pts = np.concatenate([pts_rect[sel], pts_intensity[sel]], axis=1)
        records.append(FrustumRecord(
            points=pts.astype(np.float32), seg=None,
            class_idx=cfg.class_index(classname),
            frustum_angle=frustum_angle_for_box(box2d, calib),
            box2d=box2d, score=float(prob), frame_id=idx,
            calib_p=calib.P.astype(np.float32)))
    return records


def read_det_file(path: str) -> Dict[str, List[Tuple[str, float, np.ndarray]]]:
    """2D detection file: lines 'frame_id classname prob x1 y1 x2 y2'."""
    out: Dict[str, List] = {}
    with open(path) as f:
        for line in f:
            p = line.split()
            if not p:
                continue
            out.setdefault(p[0], []).append(
                (p[1], float(p[2]),
                 np.array([float(x) for x in p[3:7]], np.float32)))
    return out
