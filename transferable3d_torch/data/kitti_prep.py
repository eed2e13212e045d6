"""KITTI frustum-dataset preparation CLI (`t3d-torch-prepare-kitti`).

Capability parity target: the reference's `kitti/prepare_data.py`
(SURVEY.md C2, call stack §3.1): --gen_train (GT boxes, 2D jitter
augmentation) / --gen_val (GT boxes, no jitter) / --gen_val_rgb_detection
(2D detector outputs), writing frustum pickles in the native format.

JAX-free copy of `transferable3d_tpu/data/kitti_prep.py`
(`python -m transferable3d_torch.data.kitti_prep`). `--demo` draws the
first frustum of the first frame to `demo_frustum.png` through
`utils/viz.py` and prints the path.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional, Sequence

import numpy as np

from transferable3d_torch.core import bins as bins_lib
from transferable3d_torch.data import kitti, pickle_io
from transferable3d_torch.data.provider import FrustumRecord


def _frame_ids(dataset: kitti.KittiObjectDataset,
               idx_file: Optional[str]) -> List[str]:
    if idx_file:
        with open(idx_file) as f:
            return [l.strip().zfill(6) for l in f if l.strip()]
    return dataset.ids()


def prepare_split(root: str, out_path: str, split_ids: Optional[str],
                  perturb: bool, augment_x: int,
                  whitelist: Sequence[str] = ("Car", "Pedestrian",
                                              "Cyclist"),
                  seed: int = 0) -> int:
    ds = kitti.KittiObjectDataset(root, "training")
    rng = np.random.RandomState(seed)
    records: List[FrustumRecord] = []
    for idx in _frame_ids(ds, split_ids):
        records.extend(kitti.extract_frustum_records(
            ds, idx, cfg=bins_lib.KITTI, type_whitelist=whitelist,
            perturb_box2d=perturb, augment_x=augment_x, rng=rng))
    pickle_io.save_records(records, out_path)
    return len(records)


def prepare_from_detections(root: str, out_path: str, det_file: str,
                            split: str = "training",
                            whitelist: Sequence[str] = ("Car", "Pedestrian",
                                                        "Cyclist")) -> int:
    ds = kitti.KittiObjectDataset(root, split)
    dets_by_frame = kitti.read_det_file(det_file)
    records: List[FrustumRecord] = []
    for idx, dets in sorted(dets_by_frame.items()):
        dets = [d for d in dets if d[0] in whitelist]
        records.extend(kitti.extract_frustum_records_from_detections(
            ds, idx, dets, cfg=bins_lib.KITTI))
    pickle_io.save_records(records, out_path)
    return len(records)


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--kitti_root", required=True)
    p.add_argument("--out_dir", default="data/kitti_frustum")
    p.add_argument("--gen_train", action="store_true")
    p.add_argument("--gen_val", action="store_true")
    p.add_argument("--gen_val_rgb_detection", action="store_true")
    p.add_argument("--train_idx", default=None,
                   help="file of frame ids for the train split")
    p.add_argument("--val_idx", default=None)
    p.add_argument("--det_file", default=None,
                   help="2D detections: 'frame cls prob x1 y1 x2 y2' lines")
    p.add_argument("--augment_x", type=int, default=5)
    p.add_argument("--classes", default="Car,Pedestrian,Cyclist")
    p.add_argument("--demo", action="store_true",
                   help="render the first extracted frustum to PNG "
                        "(reference prepare_data.py --demo analog)")
    args = p.parse_args()

    if args.demo:
        ds = kitti.KittiObjectDataset(args.kitti_root, "training")
        idx = _frame_ids(ds, args.train_idx)[0]
        recs = kitti.extract_frustum_records(
            ds, idx, type_whitelist=tuple(args.classes.split(",")))
        if not recs:
            raise ValueError(f"no frustums in frame {idx}")
        from transferable3d_torch.utils import viz
        r = recs[0]
        path = viz.draw_frustum(
            r.points[:, :3], gt_box=(r.center, r.size, float(r.heading)),
            seg=r.seg, path="demo_frustum.png",
            title=f"frame {idx} ({bins_lib.KITTI.classes[r.class_idx]})")
        print(f"demo: wrote {path}")
        return

    whitelist = tuple(args.classes.split(","))
    os.makedirs(args.out_dir, exist_ok=True)
    if args.gen_train:
        n = prepare_split(args.kitti_root,
                          os.path.join(args.out_dir, "train.pkl"),
                          args.train_idx, perturb=True,
                          augment_x=args.augment_x, whitelist=whitelist)
        print(f"train: {n} frustums")
    if args.gen_val:
        n = prepare_split(args.kitti_root,
                          os.path.join(args.out_dir, "val.pkl"),
                          args.val_idx, perturb=False, augment_x=1,
                          whitelist=whitelist)
        print(f"val: {n} frustums")
    if args.gen_val_rgb_detection:
        assert args.det_file, "--det_file required"
        n = prepare_from_detections(
            args.kitti_root,
            os.path.join(args.out_dir, "val_rgb_detection.pkl"),
            args.det_file, whitelist=whitelist)
        print(f"val_rgb_detection: {n} frustums")


if __name__ == "__main__":
    main()
