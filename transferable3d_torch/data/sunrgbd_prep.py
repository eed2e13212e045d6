"""SUN-RGBD frustum-dataset preparation CLI (`t3d-torch-prepare-sunrgbd`).

Capability parity target: the reference's MATLAB `extract_*.m` + python
pickle step (SURVEY.md C3/N5, L1): SUNRGBDMeta.mat + depth/rgb images ->
frustum pickles for train/val, with strong/weak class splits for the
transfer-learning configs (BASELINE.json config 4).

JAX-free copy of `transferable3d_tpu/data/sunrgbd_prep.py`
(`python -m transferable3d_torch.data.sunrgbd_prep`; `cv2` is imported
inside the functions that read images, as there).
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional, Sequence

import numpy as np

from transferable3d_torch.core import bins as bins_lib
from transferable3d_torch.data import pickle_io, sunrgbd
from transferable3d_torch.data.provider import FrustumRecord


def _load_depth(path: str) -> np.ndarray:
    import cv2

    raw = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    assert raw is not None, f"cannot read depth image {path}"
    return sunrgbd.decode_depth(raw)


def _load_rgb(path: str) -> Optional[np.ndarray]:
    if not path or not os.path.exists(path):
        return None
    import cv2

    img = cv2.imread(path, cv2.IMREAD_COLOR)
    return None if img is None else img[:, :, ::-1]  # BGR -> RGB


def prepare(meta_path: str, data_root: str, out_path: str,
            frame_ids: Optional[Sequence[int]] = None,
            classes: Optional[Sequence[str]] = None,
            perturb: bool = False, augment_x: int = 1,
            use_rgb: bool = True, seed: int = 0) -> int:
    cfg = bins_lib.SUNRGBD
    frames = sunrgbd.load_meta(meta_path, data_root)
    if frame_ids is not None:
        frames = [frames[i] for i in frame_ids]
    rng = np.random.RandomState(seed)
    records: List[FrustumRecord] = []
    for frame in frames:
        depth = _load_depth(frame.depth_path)
        rgb = _load_rgb(frame.image_path) if use_rgb else None
        pts, uv = sunrgbd.depth_to_upright_points(depth, frame.K,
                                                  frame.Rtilt, rgb)
        records.extend(sunrgbd.extract_frustum_records(
            frame, pts, uv, cfg, type_whitelist=classes,
            perturb_box2d=perturb, augment_x=augment_x, rng=rng))
    pickle_io.save_records(records, out_path)
    return len(records)


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--meta", required=True, help="SUNRGBDMeta.mat path")
    p.add_argument("--data_root", default="",
                   help="root to resolve depth/rgb paths against")
    p.add_argument("--out_dir", default="data/sunrgbd_frustum")
    p.add_argument("--train_ids", default=None,
                   help="file with frame indices for the train split")
    p.add_argument("--val_ids", default=None)
    p.add_argument("--augment_x", type=int, default=5)
    p.add_argument("--classes", default=",".join(bins_lib.SUNRGBD_CLASSES))
    p.add_argument("--no_rgb", action="store_true")
    args = p.parse_args()

    def _ids(path):
        if path is None:
            return None
        with open(path) as f:
            return [int(l) for l in f if l.strip()]

    classes = tuple(args.classes.split(","))
    os.makedirs(args.out_dir, exist_ok=True)
    n = prepare(args.meta, args.data_root,
                os.path.join(args.out_dir, "train.pkl"),
                _ids(args.train_ids), classes, perturb=True,
                augment_x=args.augment_x, use_rgb=not args.no_rgb)
    print(f"train: {n} frustums")
    n = prepare(args.meta, args.data_root,
                os.path.join(args.out_dir, "val.pkl"),
                _ids(args.val_ids), classes, perturb=False, augment_x=1,
                use_rgb=not args.no_rgb)
    print(f"val: {n} frustums")


if __name__ == "__main__":
    main()
