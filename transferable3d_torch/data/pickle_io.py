"""Frustum-dataset pickle IO: native format + reference-format import.

Capability parity target: the reference's pickled frustum datasets
produced by `kitti/prepare_data.py` / the SUN-RGBD extraction (SURVEY.md
C2/C3, L1) and consumed by `train/provider.py` (C4).

Two formats are supported:

1. **Native ("t3d_v1")** — a dict with a format tag and per-example
   arrays; written by our prep scripts (`sunrgbd_prep.py`, `kitti_prep.py`)
   and the synthetic generator. Always preferred.

2. **Reference-style import** — the lineage's pickle layout: a sequence of
   parallel lists, one entry per frustum, pickled consecutively into one
   file (id, 2D box, 3D corner box, points, seg labels, class name,
   heading, size, frustum angle; detection variants carry a 2D score
   instead of labels). Corner boxes are converted to (center, size,
   heading) assuming the standard KITTI corner ordering. This is a
   best-effort importer so real reference pickles drop in when available
   (the reference mount was empty — see SURVEY.md provenance notice).

JAX-free copy of `transferable3d_tpu/data/pickle_io.py`: the same native
format (files written by either package load in the other) and the same
reference-format importer; tests/test_torch_data_prep.py holds it equal
to the original.
"""

from __future__ import annotations

import os
import pickle
from typing import List, Optional, Sequence

import numpy as np

from transferable3d_torch.core import bins as bins_lib
from transferable3d_torch.data.provider import FrustumRecord

FORMAT_TAG = "t3d_v1"


# ---------------------------------------------------------------------------
# Native format
# ---------------------------------------------------------------------------

def save_records(records: Sequence[FrustumRecord], path: str) -> None:
    payload = {
        "format": FORMAT_TAG,
        "examples": [
            {
                "points": r.points, "seg": r.seg,
                "class_idx": r.class_idx,
                "frustum_angle": r.frustum_angle,
                "center": r.center, "size": r.size, "heading": r.heading,
                "box2d": r.box2d, "score": r.score, "frame_id": r.frame_id,
            }
            for r in records
        ],
    }
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(payload, f, protocol=4)


def _records_from_native(payload: dict) -> List[FrustumRecord]:
    return [FrustumRecord(**ex) for ex in payload["examples"]]


# ---------------------------------------------------------------------------
# Reference-style import
# ---------------------------------------------------------------------------

def corners_to_box(corners: np.ndarray):
    """Recover (center, size(lwh), heading) from [8,3] KITTI-style corners.

    Assumes the conventional ring ordering shared by our canonical corners
    and the KITTI devkit pattern: corners 0-3 one horizontal face with
    x-signs (+,+,-,-) and z-signs (+,-,-,+) of (l/2, w/2) — so the edge
    c0->c1 spans w and c2->c1 spans +l (the heading axis). Heading is
    recovered exactly (mod 2*pi).
    """
    corners = np.asarray(corners, np.float64)
    center = corners.mean(axis=0)
    # Y axis = vertical in our frame (Y down). Height from Y extent.
    h = float(corners[:, 1].max() - corners[:, 1].min())
    # Ring on the horizontal plane: project to (x, z).
    ring = corners[:4][:, [0, 2]]
    w_vec = ring[1] - ring[0]
    l_vec = ring[1] - ring[2]  # points along the box +x (heading) axis
    l, w = float(np.linalg.norm(l_vec)), float(np.linalg.norm(w_vec))
    # Our +Y rotation maps the box x-axis (1, 0) to (cos h, -sin h) in
    # (x, z), so heading = arctan2(-z, x) of the l edge direction.
    heading = float(np.arctan2(-l_vec[1], l_vec[0]))
    return (center.astype(np.float32),
            np.array([l, w, h], np.float32), np.float32(heading))


def _load_consecutive_pickles(f) -> List:
    out = []
    while True:
        try:
            out.append(pickle.load(f, encoding="latin1"))
        except EOFError:
            return out


def _records_from_reference_lists(parts: List, cfg: bins_lib.BinConfig
                                  ) -> List[FrustumRecord]:
    """Convert the lineage's parallel-list pickle into records.

    Layouts (by number of lists):
      9: id, box2d, box3d(corners), points, seg, type, heading, size, angle
      6: id, box2d, points, type, angle, prob         (from 2D detections)
    """
    n = len(parts)
    if n == 9:
        (_ids, box2d, box3d, pts, seg, types, headings, sizes,
         angles) = parts
        recs = []
        for i in range(len(pts)):
            name = types[i]
            if name not in cfg.classes:
                continue
            center, size_lwh, heading_rec = corners_to_box(box3d[i])
            # Prefer the explicit heading/size when present.
            heading = np.float32(headings[i])
            size = np.asarray(sizes[i], np.float32)
            if size.shape != (3,):
                size = size_lwh
            recs.append(FrustumRecord(
                points=np.asarray(pts[i], np.float32),
                seg=np.asarray(seg[i], np.int64),
                class_idx=cfg.class_index(name),
                frustum_angle=float(angles[i]),
                center=center, size=size, heading=heading,
                box2d=np.asarray(box2d[i], np.float32),
                frame_id=str(_ids[i])))
        return recs
    if n == 6:
        _ids, box2d, pts, types, angles, probs = parts
        recs = []
        for i in range(len(pts)):
            name = types[i]
            if name not in cfg.classes:
                continue
            recs.append(FrustumRecord(
                points=np.asarray(pts[i], np.float32),
                seg=None, class_idx=cfg.class_index(name),
                frustum_angle=float(angles[i]),
                box2d=np.asarray(box2d[i], np.float32),
                score=float(probs[i]), frame_id=str(_ids[i])))
        return recs
    raise ValueError(
        f"unrecognized reference pickle layout with {n} lists")


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------

def load_records(path: str, split: str = "train",
                 classes: Optional[Sequence[str]] = None,
                 cfg: Optional[bins_lib.BinConfig] = None
                 ) -> List[FrustumRecord]:
    """Load records from `path` (a file, or a dir containing {split}.pkl)."""
    if os.path.isdir(path):
        path = os.path.join(path, f"{split}.pkl")
    with open(path, "rb") as f:
        first = pickle.load(f, encoding="latin1")
        if isinstance(first, dict) and first.get("format") == FORMAT_TAG:
            records = _records_from_native(first)
        else:
            cfg = cfg or bins_lib.SUNRGBD
            rest = _load_consecutive_pickles(f)
            records = _records_from_reference_lists([first] + rest, cfg)
    if classes:
        cfg = cfg or bins_lib.SUNRGBD
        keep = {cfg.class_index(c) for c in classes}
        records = [r for r in records if r.class_idx in keep]
    return records
