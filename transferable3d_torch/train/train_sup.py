"""Supervised training driver (`python -m transferable3d_torch.train.train_sup`,
`t3d-torch-train`).

Port of `transferable3d_tpu/train/train_sup.py` (`t3d-train`), with the
same `TrainConfig`, presets and command line, and the same files under
`log_dir`: `log_train.txt`, `metrics_{train,val}.csv` and one
checkpoint directory a step under `ckpt/`. The model is selected by
name; the epoch loop runs train and eval passes on the staircase LR and
BN-momentum schedules, checkpoints periodically, on the last step and on
SIGTERM/SIGINT, and resumes from the newest checkpoint.

One device: the card unless `train(cfg, device="cpu")`. Data
parallelism (`num_devices` above 1, `multihost`) is not ported yet
(ROADMAP A14) and is refused rather than run on one device. The driver
turns off TF32 and cuBLAS's reduced-precision bf16 reductions, so
products accumulate in f32 as in the JAX package.

Dataset selection:
  --data_path <pickles>   real frustum pickles (SUN-RGBD / KITTI prep)
  (no data_path)          synthetic frustums (smoke/benchmarks)
  --device_data True      the records resident on the device, each
                          step's batch drawn there (data/device_dataset)
"""

from __future__ import annotations

import argparse
import dataclasses
import signal
import time

import numpy as np
import torch

from transferable3d_torch import resolve_device
from transferable3d_torch.data import device_dataset, pickle_io, synthetic
from transferable3d_torch.data.provider import FrustumDataset
from transferable3d_torch.models import registry
from transferable3d_torch.train import config as config_lib
from transferable3d_torch.train import schedules, train_loop
from transferable3d_torch.utils.checkpoint import CheckpointManager
from transferable3d_torch.utils.logging import Logger
from transferable3d_torch.utils.prefetch import prefetch


def build_datasets(cfg: config_lib.TrainConfig):
    bins_cfg = cfg.bin_config()
    if cfg.data_path:
        train_recs = pickle_io.load_records(
            cfg.data_path, split="train", classes=cfg.classes or None)
        val_recs = pickle_io.load_records(
            cfg.data_path, split="val", classes=cfg.classes or None)
    else:
        class_idx = (bins_cfg.class_index(cfg.classes[0])
                     if cfg.classes else None)
        train_recs = synthetic.make_dataset(
            cfg.synthetic_train, bins_cfg, seed=cfg.seed,
            hard=cfg.synthetic_hard,
            class_idx=class_idx,
            extra_channels=cfg.num_channels - 3)
        val_recs = synthetic.make_dataset(
            cfg.synthetic_val, bins_cfg, seed=cfg.seed + 10_000,
            hard=cfg.synthetic_hard,
            class_idx=class_idx,
            extra_channels=cfg.num_channels - 3)
    train_ds = FrustumDataset(
        train_recs, bins_cfg, npoints=cfg.num_point,
        rotate_to_center=True, random_flip=cfg.random_flip,
        random_shift=cfg.random_shift, seed=cfg.seed)
    val_ds = FrustumDataset(
        val_recs, bins_cfg, npoints=cfg.num_point, rotate_to_center=True,
        seed=cfg.seed)
    return train_ds, val_ds


def f32_numerics() -> None:
    """Products accumulate in f32, as in the JAX package: no TF32, and no
    bf16 partial sums in cuBLAS's split reductions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def build_model(cfg: config_lib.TrainConfig, in_channels: int, device):
    """The config's model with weights drawn from `cfg.seed`. Its point
    width is the data's (flax infers it from the sample batch); the
    box-only model reads xyz alone."""
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    kw = ({} if cfg.model == "box_estimation_v1"
          else {"in_channels": in_channels})
    return registry.get_model(
        cfg.model, cfg.bin_config(), dtype=dtype, device=device,
        generator=torch.Generator().manual_seed(cfg.seed), **kw)


def build_schedules(cfg: config_lib.TrainConfig):
    """The config's (LR, BN-momentum) staircase schedules."""
    lr = schedules.exponential_staircase_lr(
        cfg.learning_rate, cfg.lr_decay_rate, cfg.lr_decay_samples,
        cfg.batch_size, cfg.min_lr)
    bn = schedules.bn_momentum_schedule(
        cfg.bn_init_decay, cfg.bn_decay_rate, cfg.bn_decay_samples,
        cfg.batch_size, cfg.bn_decay_clip)
    return lr, bn


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(cfg: config_lib.TrainConfig, device=None) -> dict:
    if cfg.multihost or cfg.num_devices > 1:
        raise ValueError(
            "data-parallel training (num_devices > 1, multihost) is not "
            "ported yet (ROADMAP A14); the port trains on one device")
    device = resolve_device(device)
    f32_numerics()
    logger = Logger(cfg.log_dir)
    logger.log_string(f"config: {dataclasses.asdict(cfg)}")
    bins_cfg = cfg.bin_config()
    train_ds, val_ds = build_datasets(cfg)
    logger.log_string(
        f"datasets: train={len(train_ds)} val={len(val_ds)} "
        f"classes={bins_cfg.classes}")

    lr_sched, bn_sched = build_schedules(cfg)
    tx = train_loop.make_optimizer(
        lr_sched, grad_accum_steps=cfg.grad_accum_steps)

    sample = train_ds.get_batch(list(range(min(cfg.batch_size,
                                               len(train_ds)))))
    model = build_model(cfg, sample["points"].shape[-1], device)
    state = train_loop.create_train_state(model, tx, seed=cfg.seed)

    ckpt = CheckpointManager(f"{cfg.log_dir}/ckpt")
    if ckpt.restore_latest(state) is not None:
        logger.log_string(f"resumed from step {state.step}")

    step_cfg = train_loop.StepConfig(
        box_loss_weight=cfg.box_loss_weight,
        corner_loss_weight=cfg.corner_loss_weight)
    train_step = train_loop.make_train_step(bins_cfg, lr_sched, bn_sched,
                                            step_cfg)
    eval_step = train_loop.make_eval_step(bins_cfg, step_cfg)

    # Optional device-resident dataset: per-step sampling/augmentation
    # runs on the device (data/device_dataset.py), off the host's path.
    device_iter = None
    if cfg.device_data:
        dev_data = device_dataset.build_device_dataset(
            train_ds.records, bins_cfg, max_points=cfg.max_points_device,
            device=device)
        device_iter = device_dataset.DeviceEpochIterator(
            dev_data, bins_cfg, cfg.batch_size, cfg.num_point,
            seed=cfg.seed, random_flip=cfg.random_flip,
            random_shift=cfg.random_shift)
        logger.log_string(
            f"device-resident dataset: {dev_data.num_records} records x "
            f"{cfg.max_points_device} pts on {device}")

    # Failure handling: checkpoint on SIGTERM/SIGINT so a preemption
    # resumes from the current step instead of the last epoch.
    interrupted = {"flag": False}

    def _on_signal(signum, frame):
        interrupted["flag"] = True
        logger.log_string(f"signal {signum}: checkpointing and stopping")

    previous = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            previous[sig] = signal.signal(sig, _on_signal)
        except ValueError:
            pass  # not in the main thread

    last_eval = {}
    stop = False
    try:
        for epoch in range(cfg.max_epoch):
            if stop:
                break
            t0, seen = time.time(), 0
            if device_iter is not None:
                batches = device_iter.epoch()
            else:
                batches = prefetch(train_ds.epoch_batches(cfg.batch_size),
                                   device=device)
            for batch in batches:
                state, metrics = train_step(state, batch)
                seen += cfg.batch_size
                if interrupted["flag"] or (
                        cfg.max_steps and state.step >= cfg.max_steps):
                    stop = True
                    break
            # Sync before reading the clock: launches are asynchronous, so
            # without this frustums/s would measure the enqueueing.
            _sync(device)
            dt = time.time() - t0
            host_m = {k: float(v) for k, v in metrics.items()}
            logger.log_metrics(state.step, host_m, "train")
            logger.log_string(
                f"epoch {epoch}: step={state.step} "
                f"loss={host_m['total_loss']:.4f} "
                f"seg_acc={host_m.get('seg_accuracy', float('nan')):.3f} "
                f"iou3d={host_m.get('iou3d_mean', float('nan')):.3f} "
                f"({seen / max(dt, 1e-9):.1f} frustums/s)")

            if epoch % cfg.eval_every_epochs == 0 or stop:
                agg = []
                for batch in val_ds.epoch_batches(cfg.batch_size,
                                                  shuffle=False):
                    agg.append({k: float(v) for k, v in
                                eval_step(state, batch).items()})
                if agg:
                    last_eval = {k: float(np.mean([m[k] for m in agg]))
                                 for k in agg[0]}
                    logger.log_metrics(state.step, last_eval, "val")
                    logger.log_string(
                        f"  val: loss={last_eval['total_loss']:.4f} "
                        f"iou3d_ge_05={last_eval.get('iou3d_ge_05', 0):.3f} "
                        f"iou3d_ge_07={last_eval.get('iou3d_ge_07', 0):.3f}")

            if epoch % cfg.ckpt_every_epochs == 0 or stop:
                ckpt.save(state.step, state)
    finally:
        for sig, handler in previous.items():
            signal.signal(sig, handler)

    ckpt.wait()
    ckpt.close()
    logger.close()
    return last_eval


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    config_lib.add_cli_args(parser)
    cfg = config_lib.config_from_args(parser.parse_args())
    train(cfg)


if __name__ == "__main__":
    main()
