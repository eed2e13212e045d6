"""SUN-RGBD-style 3D detection AP evaluator (VOC protocol).

JAX-free copy of `transferable3d_tpu/eval/ap.py` (numpy on the host, in
both packages); tests/test_torch_eval.py holds it equal to the original.

Capability parity target: the reference's python evaluator (SURVEY.md
C12, `eval_det`-style): per-class average precision at a 3D IoU
threshold (0.25 for SUN-RGBD), greedy matching of detections to ground
truth in descending score order, each GT matched at most once.

Protocol details (classic VOC, as used by the F-PointNet lineage):
  * detections across all frames of a class are sorted by confidence;
  * each detection is matched to the best-IoU unmatched GT in its frame;
  * TP if best IoU >= threshold and that GT is unmatched, else FP;
  * AP = area under the interpolated precision-recall curve. Both the
    continuous trapezoid-free VOC integral (default, matches the
    lineage's `voc_ap` with use_07_metric=False) and the 11-point VOC07
    variant are provided.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Sequence, Tuple

import numpy as np

from transferable3d_torch.core import box_np
from transferable3d_torch.core.geometry import box_corners_np


class BoxDetection:
    """One detection or GT box: corners [8,3] + score + class + frame."""

    __slots__ = ("frame_id", "classname", "corners", "score")

    def __init__(self, frame_id, classname, corners, score=1.0):
        self.frame_id = frame_id
        self.classname = classname
        self.corners = np.asarray(corners, np.float32)
        self.score = float(score)

    @staticmethod
    def from_params(frame_id, classname, center, size, heading, score=1.0):
        return BoxDetection(frame_id, classname,
                            box_corners_np(np.asarray(center, np.float32),
                                           np.asarray(size, np.float32),
                                           np.float32(heading)), score)


def voc_ap(recall: np.ndarray, precision: np.ndarray,
           use_07_metric: bool = False) -> float:
    """AP from a PR curve (VOC integration)."""
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = precision[recall >= t].max() if (recall >= t).any() else 0.0
            ap += p / 11.0
        return float(ap)
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[0.0], precision, [0.0]])
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = max(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def eval_det_cls(detections: Sequence[BoxDetection],
                 groundtruths: Sequence[BoxDetection],
                 iou_thresh: float = 0.25,
                 use_07_metric: bool = False,
                 bev: bool = False) -> Tuple[np.ndarray, np.ndarray, float]:
    """(recall curve, precision curve, AP) for one class.

    Fully vectorized (round 3, VERDICT r02 item 6): one flat
    [nd, 1, Gmax] IoU call (each detection against only ITS frame's GT
    slots — no padded [frames, Dmax, Gmax] grid, so no Dmax waste) plus
    a first-occurrence scan replace the per-frame IoU loop and the
    per-detection greedy loop. The VOC greedy protocol ("match
    argmax-IoU GT; TP iff IoU >= thresh and that GT is unclaimed")
    factorizes exactly: a detection is TP iff its best IoU passes the
    threshold AND it is the first passing detection (in descending
    score order) whose argmax lands on that (frame, gt) slot — a
    `np.unique(..., return_index=True)` over keys. Matches the loop
    reference (kept below as `eval_det_cls_reference`) on all golden
    fixtures and random A/Bs.
    """
    npos = len(groundtruths)
    dets = sorted(detections, key=lambda d: -d.score)
    nd = len(dets)
    if nd == 0:
        return (np.zeros(0), np.zeros(0),
                0.0 if npos else voc_ap(np.zeros(0), np.zeros(0),
                                        use_07_metric))

    gt_by_frame: Dict = defaultdict(list)
    for g in groundtruths:
        gt_by_frame[g.frame_id].append(g)

    # Frame table over frames that HAVE ground truth; detections in
    # GT-less frames are unconditional FPs.
    frame_ids = sorted(gt_by_frame, key=repr)
    frame_idx = {fid: i for i, fid in enumerate(frame_ids)}
    f = len(frame_ids)

    det_frame = np.array([frame_idx.get(d.frame_id, -1) for d in dets])
    tp = np.zeros(nd)
    has_gt = det_frame >= 0
    if f and has_gt.any():
        gmax = max(len(gs) for gs in gt_by_frame.values())
        gt_corners = np.zeros((f, gmax, 8, 3), np.float32)
        gt_count = np.zeros(f, np.int64)
        for fid, gs in gt_by_frame.items():
            fi = frame_idx[fid]
            gt_count[fi] = len(gs)
            gt_corners[fi, :len(gs)] = [g.corners for g in gs]
        dets_f = det_frame[has_gt]                       # [nd_gt]
        all_corners = np.stack([d.corners for d in dets])[has_gt]

        iou3d, ioubev = box_np.box3d_iou_pairs_np(
            all_corners[:, None], gt_corners[dets_f])    # [nd_gt, 1, Gmax]
        rows_mat = (ioubev if bev else iou3d)[:, 0]      # [nd_gt, Gmax]
        # Padded GT slots must never win the argmax.
        gt_valid = np.arange(gmax)[None] < gt_count[dets_f, None]
        rows_mat = np.where(gt_valid, rows_mat, -1.0)
        best_j = np.argmax(rows_mat, axis=1)
        ok = rows_mat[np.arange(len(best_j)), best_j] >= iou_thresh
        # First passing detection per (frame, gt) key wins; order is
        # already descending score (stable sort above).
        key = det_frame[has_gt] * gmax + best_j
        ok_pos = np.nonzero(ok)[0]
        _, first = np.unique(key[ok_pos], return_index=True)
        tp_gt = np.zeros(len(best_j))
        tp_gt[ok_pos[first]] = 1.0
        tp[has_gt] = tp_gt

    fp = 1.0 - tp
    tp_cum = np.cumsum(tp)
    fp_cum = np.cumsum(fp)
    recall = tp_cum / max(npos, 1)
    precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-9)
    return recall, precision, voc_ap(recall, precision, use_07_metric)


def eval_det_cls_reference(detections: Sequence[BoxDetection],
                           groundtruths: Sequence[BoxDetection],
                           iou_thresh: float = 0.25,
                           use_07_metric: bool = False,
                           bev: bool = False
                           ) -> Tuple[np.ndarray, np.ndarray, float]:
    """Loop form of the VOC greedy protocol (kept as the executable
    spec; `eval_det_cls` must agree with it exactly)."""
    gt_by_frame: Dict = defaultdict(list)
    for g in groundtruths:
        gt_by_frame[g.frame_id].append(g)
    matched = {fid: np.zeros(len(gs), bool)
               for fid, gs in gt_by_frame.items()}
    npos = len(groundtruths)

    dets = sorted(detections, key=lambda d: -d.score)

    det_by_frame: Dict = defaultdict(list)
    for i, d in enumerate(dets):
        det_by_frame[d.frame_id].append(i)
    iou_row = [None] * len(dets)
    for fid, idxs in det_by_frame.items():
        gts = gt_by_frame.get(fid, [])
        if not gts:
            continue
        iou3d, ioubev = box_np.box3d_iou_pairs_np(
            np.stack([dets[i].corners for i in idxs]),
            np.stack([g.corners for g in gts]))
        mat = ioubev if bev else iou3d
        for row, i in enumerate(idxs):
            iou_row[i] = mat[row]

    tp = np.zeros(len(dets))
    fp = np.zeros(len(dets))
    for i, d in enumerate(dets):
        row = iou_row[i]
        if row is None:  # no GT in this frame
            fp[i] = 1.0
            continue
        best_j = int(np.argmax(row))
        if row[best_j] >= iou_thresh and not matched[d.frame_id][best_j]:
            tp[i] = 1.0
            matched[d.frame_id][best_j] = True
        else:
            fp[i] = 1.0

    tp_cum = np.cumsum(tp)
    fp_cum = np.cumsum(fp)
    recall = tp_cum / max(npos, 1)
    precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-9)
    return recall, precision, voc_ap(recall, precision, use_07_metric)


def eval_det(detections: Sequence[BoxDetection],
             groundtruths: Sequence[BoxDetection],
             iou_thresh: float = 0.25,
             use_07_metric: bool = False,
             bev: bool = False) -> Dict[str, float]:
    """Per-class AP + 'mAP' over classes that have ground truth."""
    classes = sorted({g.classname for g in groundtruths})
    det_by_cls = defaultdict(list)
    for d in detections:
        det_by_cls[d.classname].append(d)
    gt_by_cls = defaultdict(list)
    for g in groundtruths:
        gt_by_cls[g.classname].append(g)

    out = {}
    for c in classes:
        _, _, ap = eval_det_cls(det_by_cls.get(c, []), gt_by_cls[c],
                                iou_thresh, use_07_metric, bev)
        out[c] = ap
    out["mAP"] = float(np.mean([out[c] for c in classes])) if classes else 0.0
    return out
