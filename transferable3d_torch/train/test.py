"""Batched inference -> detections in the original camera frame.

Port of `Detection`, `rotate_back` and `run_inference`
(`transferable3d_tpu/train/test.py:39-130`) without the BoxPC
refinement (`--boxpc_refine`, ROADMAP queue A, item 13). The writers,
the AP evaluation and the CLI are not ported yet (item 8).
"""

from __future__ import annotations

from typing import List

import numpy as np

from transferable3d_torch.core import bins as bins_lib
from transferable3d_torch.core.geometry import rotate_points_y_np
from transferable3d_torch.train import train_loop


class Detection:
    """One decoded detection in the *original* (un-rotated) camera frame."""

    __slots__ = ("frame_id", "classname", "center", "size", "heading",
                 "score", "box2d")

    def __init__(self, frame_id, classname, center, size, heading, score,
                 box2d=None):
        self.frame_id = frame_id
        self.classname = classname
        self.center = np.asarray(center, np.float32)
        self.size = np.asarray(size, np.float32)
        self.heading = float(heading)
        self.score = float(score)
        self.box2d = (np.zeros(4, np.float32) if box2d is None
                      else np.asarray(box2d, np.float32))


def rotate_back(center: np.ndarray, heading: float, frustum_angle: float):
    """Undo the rotate-to-center normalization for one box."""
    c = rotate_points_y_np(center[None, None, :],
                           np.float32(-frustum_angle))[0, 0]
    return c, heading - frustum_angle


def run_inference(model, ds, cfg: bins_lib.BinConfig,
                  batch_size: int = 32) -> List[Detection]:
    """Batched prediction over a dataset -> detections in original frame.

    `ds` is any object with `len(ds)`, `ds.records` (each with
    frame_id, class_idx, frustum_angle, score and box2d) and
    `ds.get_batch(indices)` returning the batch dict of numpy arrays.
    The last batch is padded by repeating its last index. The score is
    the 2D score times the seg confidence times the heading and size
    class probabilities, each floored at 1e-6.
    """
    predict = train_loop.make_predict_step(model, cfg)
    detections: List[Detection] = []
    n = len(ds)
    for start in range(0, n, batch_size):
        idxs = list(range(start, min(start + batch_size, n)))
        pad = batch_size - len(idxs)
        batch = ds.get_batch(idxs + [idxs[-1]] * pad)
        out = {k: v.cpu().numpy() for k, v in predict(batch).items()}
        for j, i in enumerate(idxs):
            rec = ds.records[i]
            center, heading = rotate_back(
                out["center"][j], float(out["heading"][j]),
                rec.frustum_angle)
            conf = (max(rec.score, 1e-6)
                    * max(float(out["seg_conf"][j]), 1e-6)
                    * max(float(out["heading_prob"][j]), 1e-6)
                    * max(float(out["size_prob"][j]), 1e-6))
            detections.append(Detection(
                frame_id=rec.frame_id,
                classname=cfg.classes[rec.class_idx],
                center=center, size=out["size"][j], heading=heading,
                score=conf, box2d=rec.box2d))
    return detections
