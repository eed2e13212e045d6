"""SUN-RGBD data access: .mat metadata parsing, depth lifting, frustums.

Capability parity target: the reference's MATLAB extraction + python
reader (SURVEY.md C3/N5): SUNRGBDMeta `.mat` structs -> per-frame
calibration (K, Rtilt), depth image -> gravity-aligned point cloud,
2D/3D amodal ground-truth boxes, frustum records for the provider.
Python (scipy.io) replaces MATLAB per the survey plan — data prep is
host-side; the jit-compiled on-device frustum pass lives in
`frustum_jit.py`.

Coordinate conventions:
  * toolbox "upright" frame (output of Rtilt): X right, Y forward
    (depth), Z up.
  * our frustum camera frame: X right, Y down, Z forward. Conversion:
    our (x, y, z) = (up_x, -up_z, up_y); headings about up-Z map to
    about our Y with a sign flip (see `upright_to_camera`).
  * depth decode: SUN-RGBD uint16 depth, value >> 3 in millimeters
    (toolbox `read3dPoints.m` semantics: bitshift(depthVis, -3) / 1000).

JAX-free copy of `transferable3d_tpu/data/sunrgbd.py` (`scipy.io` is
imported inside `load_meta`, as there); tests/test_torch_data_prep.py
holds it equal to the original.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from transferable3d_torch.core import bins as bins_lib
from transferable3d_torch.core import box_np
from transferable3d_torch.core.geometry import box_corners_np
from transferable3d_torch.data.provider import FrustumRecord


# ---------------------------------------------------------------------------
# Frame conversion
# ---------------------------------------------------------------------------

def upright_to_camera(points: np.ndarray) -> np.ndarray:
    """Upright (x right, y fwd, z up) -> camera (x right, y down, z fwd)."""
    out = np.empty_like(points)
    out[..., 0] = points[..., 0]
    out[..., 1] = -points[..., 2]
    out[..., 2] = points[..., 1]
    return out


def camera_to_upright(points: np.ndarray) -> np.ndarray:
    out = np.empty_like(points)
    out[..., 0] = points[..., 0]
    out[..., 1] = points[..., 2]
    out[..., 2] = -points[..., 1]
    return out


def heading_upright_to_camera(theta: float) -> float:
    """Upright heading (box x-axis (cos t, sin t, 0) about +Z) -> ours.

    Our heading h puts the box x-axis at (cos h, 0, -sin h); the mapped
    axis is (cos t, 0, sin t), so h = -t.
    """
    return -float(theta)


# ---------------------------------------------------------------------------
# Metadata structures
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SunRgbdBox3d:
    classname: str
    centroid: np.ndarray    # [3] upright coords
    size: np.ndarray        # [3] (l, w, h): l along heading axis
    heading: float          # about up-Z (upright frame)
    box2d: np.ndarray       # [4] xmin ymin xmax ymax (or zeros)

    def to_camera(self):
        center = upright_to_camera(self.centroid.astype(np.float32))
        return (center, self.size.astype(np.float32),
                np.float32(heading_upright_to_camera(self.heading)))


@dataclasses.dataclass
class SunRgbdFrame:
    frame_id: str
    K: np.ndarray           # [3,3] intrinsics
    Rtilt: np.ndarray       # [3,3] gravity alignment
    depth_path: str
    image_path: str
    boxes: List[SunRgbdBox3d]


def _mat_str(x) -> str:
    if isinstance(x, np.ndarray):
        return str(x.item()) if x.size == 1 else ""
    return str(x)


def _parse_box_struct(bb) -> Optional[SunRgbdBox3d]:
    """One groundtruth3DBB struct -> SunRgbdBox3d (toolbox semantics).

    basis [3,3] rows = box axes in upright coords; coeffs [3] half-sizes
    along those axes; centroid [3]. The heading axis is the basis row
    with the largest |x| component in the x-y plane (toolbox convention:
    orientation stored separately, recoverable from basis row 0).
    """
    try:
        basis = np.asarray(bb.basis, np.float64).reshape(3, 3)
        coeffs = np.abs(np.asarray(bb.coeffs, np.float64).reshape(3))
        centroid = np.asarray(bb.centroid, np.float64).reshape(3)
        classname = _mat_str(bb.classname)
    except AttributeError:
        return None
    # Identify the vertical axis (z in upright coords).
    z_idx = int(np.argmax(np.abs(basis[:, 2])))
    plane_idx = [i for i in range(3) if i != z_idx]
    a0, a1 = plane_idx
    # Heading axis: first in-plane basis vector.
    heading = float(np.arctan2(basis[a0, 1], basis[a0, 0]))
    size = np.array([2 * coeffs[a0], 2 * coeffs[a1], 2 * coeffs[z_idx]],
                    np.float64)
    box2d = np.zeros(4, np.float32)
    if hasattr(bb, "gtBb2D") and bb.gtBb2D is not None:
        b = np.asarray(bb.gtBb2D, np.float64).reshape(-1)
        if b.size == 4:  # [x, y, w, h] in toolbox convention
            box2d = np.array([b[0], b[1], b[0] + b[2], b[1] + b[3]],
                             np.float32)
    return SunRgbdBox3d(classname=classname, centroid=centroid,
                        size=size, heading=heading, box2d=box2d)


def load_meta(meta_path: str, data_root: str = "") -> List[SunRgbdFrame]:
    """Parse SUNRGBDMeta.mat (v7 via scipy.io; v7.3 via h5py if present)."""
    import scipy.io as sio

    mat = sio.loadmat(meta_path, squeeze_me=True, struct_as_record=False)
    key = next(k for k in mat if not k.startswith("__"))
    metas = np.atleast_1d(mat[key])
    frames: List[SunRgbdFrame] = []
    for i, m in enumerate(metas):
        boxes = []
        gt = getattr(m, "groundtruth3DBB", None)
        if gt is not None:
            for bb in np.atleast_1d(gt):
                parsed = _parse_box_struct(bb)
                if parsed is not None:
                    boxes.append(parsed)
        frames.append(SunRgbdFrame(
            frame_id=_mat_str(getattr(m, "sequenceName", i)),
            K=np.asarray(m.K, np.float64).reshape(3, 3),
            Rtilt=np.asarray(m.Rtilt, np.float64).reshape(3, 3),
            depth_path=os.path.join(data_root, _mat_str(m.depthpath)),
            image_path=os.path.join(data_root, _mat_str(m.rgbpath))
            if hasattr(m, "rgbpath") else "",
            boxes=boxes))
    return frames


# ---------------------------------------------------------------------------
# Depth lifting
# ---------------------------------------------------------------------------

def decode_depth(depth_raw: np.ndarray) -> np.ndarray:
    """uint16 SUN-RGBD depth -> meters (toolbox bitshift semantics)."""
    d = (depth_raw.astype(np.uint16) >> 3).astype(np.float32) / 1000.0
    d[d > 8.0] = 8.0  # toolbox clamps far returns
    return d


def depth_to_upright_points(depth_m: np.ndarray, K: np.ndarray,
                            Rtilt: np.ndarray,
                            rgb: Optional[np.ndarray] = None
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """Depth (meters) [H,W] -> (points [N,3] upright, uv [N,2] pixels).

    If rgb [H,W,3] is given, returns [N,6] with normalized colors.
    """
    h, w = depth_m.shape
    u, v = np.meshgrid(np.arange(w), np.arange(h))
    valid = depth_m > 1e-6
    d = depth_m[valid]
    uu, vv = u[valid], v[valid]
    x = (uu - K[0, 2]) * d / K[0, 0]
    y = (vv - K[1, 2]) * d / K[1, 1]
    # camera (x right, y down, z fwd) -> pre-tilt (x right, y fwd, z up)
    pts = np.stack([x, d, -y], axis=1)
    pts = pts @ Rtilt.T  # gravity-aligned upright coords
    if rgb is not None:
        colors = rgb[valid].astype(np.float32) / 255.0
        pts = np.concatenate([pts.astype(np.float32), colors], axis=1)
    uv = np.stack([uu, vv], axis=1)
    return pts.astype(np.float32), uv


# ---------------------------------------------------------------------------
# Frustum extraction
# ---------------------------------------------------------------------------

def extract_frustum_records(frame: SunRgbdFrame,
                            points_upright: np.ndarray,
                            uv: np.ndarray,
                            cfg: bins_lib.BinConfig,
                            type_whitelist: Optional[Sequence[str]] = None,
                            perturb_box2d: bool = False,
                            augment_x: int = 1,
                            rng: Optional[np.random.RandomState] = None,
                            min_points: int = 10) -> List[FrustumRecord]:
    """Frustum records for one frame (2D GT boxes over the depth cloud)."""
    from transferable3d_torch.data.kitti import random_shift_box2d

    rng = rng or np.random.RandomState(0)
    whitelist = set(type_whitelist or cfg.classes)
    pts_cam = np.concatenate(
        [upright_to_camera(points_upright[:, :3]),
         points_upright[:, 3:]], axis=1).astype(np.float32)

    records: List[FrustumRecord] = []
    for box in frame.boxes:
        if box.classname not in whitelist or box.classname not in cfg.classes:
            continue
        center, size, heading = box.to_camera()
        corners = box_corners_np(center, size, heading)
        if not np.any(box.box2d):
            continue
        for aug in range(augment_x):
            b2d = (random_shift_box2d(box.box2d, rng)
                   if perturb_box2d and aug > 0 else box.box2d)
            sel = ((uv[:, 0] >= b2d[0]) & (uv[:, 0] < b2d[2])
                   & (uv[:, 1] >= b2d[1]) & (uv[:, 1] < b2d[3]))
            if sel.sum() < min_points:
                continue
            pts = pts_cam[sel]
            seg = box_np.in_hull_np(pts[:, :3], corners).astype(np.int64)
            # Frustum angle from the median frustum ray (2D box center ray
            # needs intrinsics post-Rtilt; the point centroid ray is
            # equivalent and robust).
            ray = pts[:, :3].mean(axis=0)
            angle = float(-np.arctan2(ray[0], ray[2]))
            records.append(FrustumRecord(
                points=pts, seg=seg,
                class_idx=cfg.class_index(box.classname),
                frustum_angle=angle, center=center, size=size,
                heading=heading, box2d=b2d.astype(np.float32),
                frame_id=frame.frame_id))
    return records
