"""Inference + detection-file writer + evaluation
(`python -m transferable3d_torch.train.test`, `t3d-torch-test`).

Port of `transferable3d_tpu/train/test.py` (`t3d-test`): restore the
newest checkpoint, batched forward, decode bins to boxes, rotate back
out of the frustum frame, write KITTI-format label files / SUN-RGBD
result lists with the same format strings (the same bytes), then run the
AP evaluator (and, for KITTI with `T3D_KITTI_GT_DIR` set, the native
offline evaluator). With `--boxpc_refine <dir>` (`evaluate(boxpc_dir=)`)
the decoded boxes are refined by a BoxPC checkpoint's deltas in the
frustum frame before the rotate-back (`make_boxpc_refine_step`).

Output formats:
  * KITTI: one `<frame_id>.txt` per frame in `result_dir/data/`, lines
    "type trunc occl alpha x1 y1 x2 y2 h w l x y z ry score" with the
    KITTI convention (3D y at the box bottom, sizes h w l).
  * SUN-RGBD: `result_dir/detections.txt`, lines
    "frame_id classname score cx cy cz l w h heading" in the upright
    camera frame.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from transferable3d_torch import resolve_device
from transferable3d_torch.core import bins as bins_lib
from transferable3d_torch.core.geometry import rotate_points_y_np
from transferable3d_torch.eval import ap as ap_lib
from transferable3d_torch.models import boxpc as boxpc_lib
from transferable3d_torch.train import config as config_lib
from transferable3d_torch.train import schedules, semisup, train_loop
from transferable3d_torch.train import train_sup
from transferable3d_torch.utils.checkpoint import CheckpointManager
from transferable3d_torch.utils.logging import Logger

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


def make_boxpc_refine_step(boxpc_model: torch.nn.Module,
                           iterations: int = 1):
    """BoxPC refinement: apply the fit net's deltas to decoded boxes
    (optionally iterated), in eval mode without autograd. The returned
    function takes points [B, N, C] and the boxes' center [B, 3], size
    [B, 3] and heading [B] (tensors on the BoxPC's device) and returns
    the refined (center, size, heading) and the last fit probability
    [B]."""

    def fn(points, center, size, heading):
        boxpc_model.eval()
        with torch.inference_mode():
            box = boxpc_lib.BoxParams(center=center, size=size,
                                      heading=heading)
            fit = torch.ones_like(heading)
            for _ in range(iterations):
                out = boxpc_model(points, box)
                box = boxpc_lib.apply_deltas(box, out)
                fit = torch.sigmoid(out["fit_logit"])
            return box.center, box.size, box.heading, fit

    return fn


def run_inference(model, ds, cfg: bins_lib.BinConfig,
                  batch_size: int = 32,
                  boxpc_model: Optional[torch.nn.Module] = None,
                  boxpc_steps: int = 1) -> List[Detection]:
    """Batched prediction over a dataset -> detections in original frame.

    `ds` is any object with `len(ds)`, `ds.records` (each with
    frame_id, class_idx, frustum_angle, score and box2d) and
    `ds.get_batch(indices)` returning the batch dict of numpy arrays.
    The last batch is padded by repeating its last index. The score is
    the 2D score times the seg confidence times the heading and size
    class probabilities, each floored at 1e-6. With `boxpc_model`, the
    decoded boxes are refined by its deltas (`boxpc_steps` times) in the
    frustum frame, before the rotate-back.
    """
    predict = train_loop.make_predict_step(model, cfg)
    refine = (make_boxpc_refine_step(boxpc_model, boxpc_steps)
              if boxpc_model is not None else None)
    detections: List[Detection] = []
    n = len(ds)
    for start in range(0, n, batch_size):
        idxs = list(range(start, min(start + batch_size, n)))
        pad = batch_size - len(idxs)
        batch = ds.get_batch(idxs + [idxs[-1]] * pad)
        out = predict(batch)
        if refine is not None:
            points = torch.as_tensor(batch["points"], dtype=torch.float32,
                                     device=out["center"].device)
            center, size, heading, fit = refine(
                points, out["center"], out["size"], out["heading"])
            out = dict(out, center=center, size=size, heading=heading,
                       boxpc_fit=fit)
        out = {k: v.cpu().numpy() for k, v in out.items()}
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


# ---------------------------------------------------------------------------
# Writers
# ---------------------------------------------------------------------------

def write_sunrgbd_results(detections: List[Detection],
                          result_dir: str) -> str:
    os.makedirs(result_dir, exist_ok=True)
    path = os.path.join(result_dir, "detections.txt")
    with open(path, "w") as f:
        for d in detections:
            f.write(
                f"{d.frame_id} {d.classname} {d.score:.6f} "
                f"{d.center[0]:.4f} {d.center[1]:.4f} {d.center[2]:.4f} "
                f"{d.size[0]:.4f} {d.size[1]:.4f} {d.size[2]:.4f} "
                f"{d.heading:.4f}\n")
    return path


def read_sunrgbd_results(path: str) -> List[Detection]:
    dets = []
    with open(path) as f:
        for line in f:
            p = line.split()
            dets.append(Detection(
                frame_id=p[0], classname=p[1], score=float(p[2]),
                center=[float(x) for x in p[3:6]],
                size=[float(x) for x in p[6:9]], heading=float(p[9])))
    return dets


def write_kitti_results(detections: List[Detection],
                        result_dir: str) -> str:
    """KITTI label files: one txt per frame under result_dir/data/."""
    data_dir = os.path.join(result_dir, "data")
    os.makedirs(data_dir, exist_ok=True)
    by_frame: Dict[str, List[Detection]] = {}
    for d in detections:
        by_frame.setdefault(d.frame_id, []).append(d)
    for frame_id, dets in by_frame.items():
        with open(os.path.join(data_dir, f"{frame_id}.txt"), "w") as f:
            for d in dets:
                l, w, h = d.size
                # KITTI: y is the box *bottom* (Y down => bottom = +h/2).
                x, y, z = d.center[0], d.center[1] + h / 2, d.center[2]
                ry = d.heading
                alpha = ry - np.arctan2(x, z)
                b = d.box2d
                f.write(
                    f"{d.classname} -1 -1 {alpha:.4f} "
                    f"{b[0]:.2f} {b[1]:.2f} {b[2]:.2f} {b[3]:.2f} "
                    f"{h:.4f} {w:.4f} {l:.4f} "
                    f"{x:.4f} {y:.4f} {z:.4f} {ry:.4f} {d.score:.6f}\n")
    return data_dir


def detections_to_eval_boxes(dets: List[Detection]) -> List:
    return [ap_lib.BoxDetection.from_params(
        d.frame_id, d.classname, d.center, d.size, d.heading, d.score)
        for d in dets]


def groundtruth_boxes(ds, cfg: bins_lib.BinConfig) -> List:
    """GT eval boxes in the original frame (records store un-rotated GT)."""
    gts = []
    for rec in ds.records:
        if rec.center is None:
            continue
        gts.append(ap_lib.BoxDetection.from_params(
            rec.frame_id, cfg.classes[rec.class_idx], rec.center,
            rec.size, float(rec.heading), 1.0))
    return gts


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def evaluate(cfg: config_lib.TrainConfig, result_dir: str,
             iou_thresh: float = 0.25, boxpc_dir: str = "",
             boxpc_steps: int = 1, device=None) -> Dict[str, float]:
    """Restore the newest checkpoint, run inference on val, write the
    files and return the APs (per class and "mAP"). On the card unless
    `device` says otherwise.

    `boxpc_dir` (--boxpc_refine): directory of a BoxPC checkpoint (phase
    A's output, `<log_dir>/boxpc_ckpt`); decoded boxes are refined by its
    deltas, iterated `boxpc_steps` times.
    """
    device = resolve_device(device)
    train_sup.f32_numerics()
    logger = Logger(result_dir, filename="log_test.txt")
    bins_cfg = cfg.bin_config()
    _, val_ds = train_sup.build_datasets(cfg)

    lr_sched = schedules.exponential_staircase_lr(batch_size=cfg.batch_size)
    tx = train_loop.make_optimizer(lr_sched)
    sample = val_ds.get_batch(list(range(min(cfg.batch_size, len(val_ds)))))
    model = train_sup.build_model(cfg, sample["points"].shape[-1], device)
    template = train_loop.create_train_state(model, tx)
    ckpt = CheckpointManager(
        cfg.restore_path or f"{cfg.log_dir}/ckpt")
    state = ckpt.restore_latest(template)
    if state is None:
        raise FileNotFoundError(f"no checkpoint found in {ckpt.directory}")
    logger.log_string(f"restored step {state.step}")

    boxpc_model = None
    if boxpc_dir:
        boxpc_model = boxpc_lib.BoxPCFitNet(bins_cfg, device=device)
        bp_ckpt = CheckpointManager(boxpc_dir)
        bp_state = bp_ckpt.restore_latest(
            semisup.create_boxpc_state(boxpc_model, tx))
        bp_ckpt.close()
        if bp_state is None:
            raise FileNotFoundError(f"no BoxPC checkpoint in {boxpc_dir}")
        logger.log_string(
            f"boxpc refinement on (step {bp_state.step}, "
            f"{boxpc_steps} iteration(s))")

    dets = run_inference(state.model, val_ds, bins_cfg, cfg.batch_size,
                         boxpc_model=boxpc_model, boxpc_steps=boxpc_steps)
    if cfg.dataset == "kitti":
        write_kitti_results(dets, result_dir)
        gt_dir = os.environ.get("T3D_KITTI_GT_DIR", "")
        if gt_dir:
            # Official-protocol offline eval via the native binary.
            from transferable3d_torch.eval import kitti_offline
            offline = kitti_offline.evaluate_offline(gt_dir, result_dir)
            for (c, m, d), v in sorted(offline.items()):
                logger.log_string(f"kitti_eval {c} {m} {d}: {v:.2f}")
    write_sunrgbd_results(dets, result_dir)

    aps = ap_lib.eval_det(detections_to_eval_boxes(dets),
                          groundtruth_boxes(val_ds, bins_cfg),
                          iou_thresh=iou_thresh)
    for k, v in sorted(aps.items()):
        logger.log_string(f"AP@{iou_thresh:.2f} {k}: {v:.4f}")
    logger.close()
    ckpt.close()
    return aps


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    config_lib.add_cli_args(parser)
    parser.add_argument("--result_dir", default="result")
    parser.add_argument("--iou_thresh", type=float, default=0.25)
    parser.add_argument("--boxpc_refine", default="",
                        help="BoxPC ckpt dir; refine decoded boxes with "
                             "its deltas before writing detections")
    parser.add_argument("--boxpc_refine_steps", type=int, default=1)
    args = parser.parse_args()
    cfg = config_lib.config_from_args(args)
    evaluate(cfg, args.result_dir, args.iou_thresh,
             boxpc_dir=args.boxpc_refine,
             boxpc_steps=args.boxpc_refine_steps)


if __name__ == "__main__":
    main()
