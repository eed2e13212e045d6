"""Cross-category semi-supervised training driver
(`python -m transferable3d_torch.train.train_semisup`,
`t3d-torch-train-semisup`).

Port of `transferable3d_tpu/train/train_semisup.py` (`t3d-train-semisup`):
strong classes carry full 3D supervision, weak classes only 2D boxes and
class labels; the BoxPC net pretrained on the strong classes transfers 3D
box quality supervision to the weak ones.

Phases:
  A. pretrain BoxPC on the strong split (perturbed GT boxes), its
     checkpoint in `<log_dir>/boxpc_ckpt`, resumed from there;
  B. train the detector on interleaved (strong, weak) batch pairs with
     the semi-supervised step (`train/semisup.py`), an eval pass on the
     weak val split and a detector checkpoint in `<log_dir>/ckpt` on
     the epochs the config names.

The log lines and the CSV columns are JAX's (per-class diagnostic
vectors become indexed columns `diag_<name>_<i>`). The card unless
`train(cfg, device="cpu")`; `num_devices` and `multihost` run both
phases data-parallel on the ranks `train_sup.run_data_parallel` forms,
each rank on its rows of the global strong and weak batches, with rank 0
writing the logs and both checkpoints.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Sequence, Tuple

import numpy as np
import torch

from transferable3d_torch import resolve_device
from transferable3d_torch.core import bins as bins_lib
from transferable3d_torch.data import device_dataset, pickle_io, synthetic
from transferable3d_torch.data.provider import FrustumDataset
from transferable3d_torch.models.boxpc import BoxPCFitNet
from transferable3d_torch.parallel import mesh as mesh_lib
from transferable3d_torch.train import config as config_lib
from transferable3d_torch.train import semisup, train_loop, train_sup
from transferable3d_torch.utils.checkpoint import CheckpointManager
from transferable3d_torch.utils.logging import Logger

DEFAULT_STRONG = ("bed", "table", "sofa", "chair")
DEFAULT_WEAK = ("toilet", "desk", "dresser", "night_stand", "bookshelf",
                "bathtub")


@dataclasses.dataclass
class SemisupConfig(config_lib.TrainConfig):
    strong_classes: Tuple[str, ...] = DEFAULT_STRONG
    weak_classes: Tuple[str, ...] = DEFAULT_WEAK
    boxpc_epochs: int = 20
    # Joint cloud+box anisotropic rescale in BoxPC phase A (log-scale
    # range; 0 disables; semisup.shape_aug_from_draws).
    boxpc_aniso_aug: float = 0.8
    weak_weight: float = 1.0
    # Linear warmup of the weak losses (steps); 0 disables.
    weak_warmup_steps: int = 0
    boxpc_restore: str = ""
    # Per-term weak-loss weights (semisup.WeakLossWeights).
    weak_fit: float = 1.0
    weak_refine: float = 1.0
    weak_reproj: float = 1.0
    weak_size_prior: float = 0.5
    weak_size_cls: float = 0.0
    # BoxPC trust-region gating (semisup.WeakLossWeights.trust_gate).
    weak_trust_gate: bool = True
    # Per-class weak-loss diagnostics as diag_*_<i> CSV columns.
    per_class_diag: bool = False


def _filter(records, cfg: bins_lib.BinConfig, classes: Sequence[str]):
    keep = {cfg.class_index(c) for c in classes}
    return [r for r in records if r.class_idx in keep]


def build_semisup_datasets(cfg: SemisupConfig):
    """(strong train, weak train, weak val) datasets; the weak val split
    keeps its 3D labels for evaluation only."""
    bins_cfg = cfg.bin_config()
    if cfg.data_path:
        train_recs = pickle_io.load_records(cfg.data_path, split="train")
        val_recs = pickle_io.load_records(cfg.data_path, split="val")
    else:
        train_recs = synthetic.make_dataset(
            cfg.synthetic_train, bins_cfg, seed=cfg.seed,
            hard=cfg.synthetic_hard,
            extra_channels=cfg.num_channels - 3)
        val_recs = synthetic.make_dataset(
            cfg.synthetic_val, bins_cfg, seed=cfg.seed + 10_000,
            hard=cfg.synthetic_hard,
            extra_channels=cfg.num_channels - 3)

    def ds(records, train=True):
        return FrustumDataset(
            records, bins_cfg, npoints=cfg.num_point,
            rotate_to_center=True,
            random_flip=cfg.random_flip and train,
            random_shift=cfg.random_shift and train, seed=cfg.seed)

    strong_train = ds(_filter(train_recs, bins_cfg, cfg.strong_classes))
    weak_train = ds(_filter(train_recs, bins_cfg, cfg.weak_classes))
    weak_val = ds(_filter(val_recs, bins_cfg, cfg.weak_classes),
                  train=False)
    return strong_train, weak_train, weak_val


def pretrain_boxpc(cfg: SemisupConfig, strong_ds: FrustumDataset,
                   logger: Logger, device=None):
    """Phase A: BoxPC trained for `cfg.boxpc_epochs` epochs of the strong
    split (resuming from `<log_dir>/boxpc_ckpt`, saved there at the end);
    under a mesh, data-parallel. Returns (model, state)."""
    mesh = mesh_lib.active()
    device = resolve_device(device)
    bins_cfg = cfg.bin_config()
    if len(strong_ds) < cfg.batch_size:
        raise ValueError(
            f"the strong split has {len(strong_ds)} frustums, fewer than "
            f"a batch of {cfg.batch_size}: phase A would take no step")
    model = BoxPCFitNet(bins_cfg, device=device,
                        generator=torch.Generator().manual_seed(cfg.seed))
    lr_sched, bn_sched = train_sup.build_schedules(cfg)
    tx = train_loop.make_optimizer(lr_sched)
    state = semisup.create_boxpc_state(model, tx, seed=cfg.seed)
    ckpt = CheckpointManager(f"{cfg.log_dir}/boxpc_ckpt")
    if ckpt.restore_latest(state) is not None:
        logger.log_string(f"boxpc: resumed from step {state.step}")
    if mesh is not None:
        mesh_lib.replicate(state, mesh)
    step = semisup.make_boxpc_train_step(bins_cfg, bn_sched,
                                         aniso_aug=cfg.boxpc_aniso_aug)

    steps_done = state.step
    target_steps = cfg.boxpc_epochs * max(
        len(strong_ds) // cfg.batch_size, 1)
    epoch = 0
    while steps_done < target_steps:
        for batch in strong_ds.epoch_batches(cfg.batch_size):
            state, metrics = step(state, mesh_lib.local_rows(batch))
            steps_done = state.step
            if steps_done >= target_steps:
                break
        logger.log_string(
            f"boxpc epoch {epoch}: step={steps_done} "
            f"loss={float(metrics['total_loss']):.4f} "
            f"fit_acc={float(metrics['fit_accuracy']):.3f} "
            f"pos={float(metrics['pos_fraction']):.2f}")
        epoch += 1
    ckpt.save(steps_done, state)
    ckpt.wait()
    ckpt.close()
    return model, state


def _host_metrics(metrics: dict) -> dict:
    """Scalars as floats; per-class diagnostic vectors as indexed
    columns."""
    m = {}
    for k, v in metrics.items():
        arr = v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
        if arr.ndim == 0:
            m[k] = float(arr)
        else:
            m.update({f"{k}_{i}": float(x) for i, x in enumerate(arr)})
    return m


def train(cfg: SemisupConfig, device=None) -> dict:
    """Phase A then phase B on the ranks `num_devices` and `multihost`
    ask for; returns the last weak-val metrics."""
    return train_sup.run_data_parallel(cfg, device, _train)


def _train(cfg: SemisupConfig, device) -> dict:
    device = resolve_device(device)
    train_sup.f32_numerics()
    mesh = mesh_lib.active()
    lead = mesh_lib.rank() == 0
    logger = Logger(cfg.log_dir if lead else None, echo=lead)
    logger.log_string(f"semisup config: {dataclasses.asdict(cfg)}")
    bins_cfg = cfg.bin_config()
    strong_ds, weak_ds, weak_val = build_semisup_datasets(cfg)
    logger.log_string(
        f"strong={len(strong_ds)} weak={len(weak_ds)} "
        f"weak_val={len(weak_val)}")

    # Phase A.
    boxpc_model, _ = pretrain_boxpc(cfg, strong_ds, logger, device)

    # Phase B.
    lr_sched, bn_sched = train_sup.build_schedules(cfg)
    tx = train_loop.make_optimizer(lr_sched)
    sample = strong_ds.get_batch(
        list(range(min(cfg.batch_size, len(strong_ds)))))
    detector = train_sup.build_model(cfg, sample["points"].shape[-1], device)
    state = semisup.SemisupState(
        detector=train_loop.create_train_state(detector, tx, seed=cfg.seed),
        boxpc=boxpc_model)
    if mesh is not None:
        mesh_lib.replicate(state.detector, mesh)
    step = semisup.make_semisup_train_step(
        bins_cfg, lr_sched, bn_sched, weak_weight=cfg.weak_weight,
        weights=semisup.WeakLossWeights(
            fit=cfg.weak_fit, refine=cfg.weak_refine,
            reprojection=cfg.weak_reproj,
            size_prior=cfg.weak_size_prior,
            size_cls=cfg.weak_size_cls,
            trust_gate=cfg.weak_trust_gate),
        weak_warmup_steps=cfg.weak_warmup_steps,
        diag_classes=bins_cfg.num_classes if cfg.per_class_diag else 0)
    eval_step = train_loop.make_eval_step(bins_cfg)

    ckpt = CheckpointManager(f"{cfg.log_dir}/ckpt")

    # Optional device-resident datasets: per-step sampling on the device
    # for both streams (data/device_dataset.py).
    strong_dev = weak_dev = None
    if cfg.device_data:
        strong_dev, weak_dev = (
            device_dataset.DeviceEpochIterator(
                device_dataset.build_device_dataset(
                    ds.records, bins_cfg, max_points=cfg.max_points_device,
                    device=device),
                bins_cfg, cfg.batch_size, cfg.num_point, seed=seed,
                random_flip=cfg.random_flip, random_shift=cfg.random_shift)
            for ds, seed in ((strong_ds, cfg.seed), (weak_ds, cfg.seed + 1)))
        logger.log_string("device-resident strong/weak datasets in HBM")

    last_eval = {}
    stop = False
    for epoch in range(cfg.max_epoch):
        if stop:
            break
        t0, seen = time.time(), 0
        weak_rng = np.random.RandomState(cfg.seed + epoch)

        def next_weak(it):
            if weak_dev is not None:
                try:
                    return it, next(it)
                except StopIteration:
                    it = iter(weak_dev.epoch())
                    return it, next(it)
            # Weak splits can be smaller than a batch (few weak-class
            # frustums): fall back to sampling with replacement.
            if len(weak_ds) < cfg.batch_size:
                idxs = weak_rng.randint(0, len(weak_ds), cfg.batch_size)
                return it, weak_ds.get_batch(list(idxs))
            try:
                return it, next(it)
            except StopIteration:
                it = iter(weak_ds.epoch_batches(cfg.batch_size))
                return it, next(it)

        weak_iter = iter(weak_dev.epoch() if weak_dev is not None
                         else weak_ds.epoch_batches(cfg.batch_size))
        strong_batches = (strong_dev.epoch() if strong_dev is not None
                          else strong_ds.epoch_batches(cfg.batch_size))
        for strong_batch in strong_batches:
            weak_iter, weak_batch = next_weak(weak_iter)
            # Each rank draws the global batches and trains on its rows.
            state, metrics = step(state,
                                  mesh_lib.local_rows(strong_batch),
                                  mesh_lib.local_rows(weak_batch))
            seen += 2 * cfg.batch_size
            if cfg.max_steps and state.detector.step >= cfg.max_steps:
                stop = True
                break
        # Sync before reading the clock: launches are asynchronous.
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.time() - t0
        m = _host_metrics(metrics)
        logger.log_metrics(state.detector.step, m, "train")
        logger.log_string(
            f"epoch {epoch}: step={state.detector.step} "
            f"sup={m['total_loss']:.3f} weak={m['weak_total_loss']:.3f} "
            f"fit_prob={m['weak_fit_prob']:.3f} "
            f"trust={m.get('weak_trust_frac', 1.0):.2f} "
            f"({seen / max(dt, 1e-9):.1f} frustums/s)")

        if epoch % cfg.eval_every_epochs == 0 or stop:
            agg = []
            for batch in weak_val.epoch_batches(cfg.batch_size,
                                                shuffle=False):
                agg.append({k: float(v) for k, v in eval_step(
                    state.detector,
                    mesh_lib.local_rows(batch)).items()})
            if agg:
                last_eval = {k: float(np.mean([x[k] for x in agg]))
                             for k in agg[0]}
                logger.log_metrics(state.detector.step, last_eval,
                                   "weak_val")
                logger.log_string(
                    f"  weak-val: iou3d_ge_025="
                    f"{last_eval.get('iou3d_ge_025', 0):.3f} "
                    f"iou3d={last_eval.get('iou3d_mean', 0):.3f}")
        if epoch % cfg.ckpt_every_epochs == 0 or stop:
            ckpt.save(state.detector.step, state.detector)
    ckpt.wait()
    ckpt.close()
    logger.close()
    return last_eval


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    config_lib.add_cli_args(parser)
    parser.add_argument("--strong_classes",
                        default=",".join(DEFAULT_STRONG))
    parser.add_argument("--weak_classes", default=",".join(DEFAULT_WEAK))
    parser.add_argument("--boxpc_epochs", type=int, default=20)
    parser.add_argument("--weak_weight", type=float, default=1.0)
    args = parser.parse_args()
    base = config_lib.config_from_args(args)
    cfg = SemisupConfig(
        **dataclasses.asdict(base),
        strong_classes=tuple(args.strong_classes.split(",")),
        weak_classes=tuple(args.weak_classes.split(",")),
        boxpc_epochs=args.boxpc_epochs,
        weak_weight=args.weak_weight)
    train(cfg)


if __name__ == "__main__":
    main()
