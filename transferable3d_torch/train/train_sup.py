"""Supervised training driver (`python -m transferable3d_torch.train.train_sup`,
`t3d-torch-train`).

Port of `transferable3d_tpu/train/train_sup.py` (`t3d-train`), with the
same `TrainConfig`, presets and command line, and the same files under
`log_dir`: `log_train.txt`, `metrics_{train,val}.csv` and one
checkpoint directory a step under `ckpt/`. The model is selected by
name; the epoch loop runs train and eval passes on the staircase LR and
BN-momentum schedules, checkpoints periodically, on the last step and on
SIGTERM/SIGINT, and resumes from the newest checkpoint.

The card unless `train(cfg, device="cpu")`. The driver turns off TF32
and cuBLAS's reduced-precision bf16 reductions, so products accumulate
in f32 as in the JAX package.

Data parallelism (`run_data_parallel`, `parallel/mesh.py`): with
`num_devices` N > 1 the driver spawns N ranks (`torch.multiprocessing`,
a `file://` rendezvous in a temporary directory), rank r on
`cuda:(r % device_count)`, or on the CPU with `device="cpu"`; 0 means
every local card (one rank on the CPU). Under a launcher that set
WORLD_SIZE (torchrun), and with `multihost`, the group forms from the
launcher's environment (`init_method="env://"`, the counterpart of
`jax.distributed.initialize()`). The backend is NCCL where each rank
has a card of its own and gloo where ranks share one or run on the CPU.
Every rank builds the same datasets and model from the seed, takes rank
0's state after a restore, draws the same global batch and trains on
its rows; the step is the 1-rank step on the whole batch. Rank 0 writes
the logs and checkpoints; a rank that fails makes `train` raise.

Dataset selection:
  --data_path <pickles>   real frustum pickles (SUN-RGBD / KITTI prep)
  (no data_path)          synthetic frustums (smoke/benchmarks)
  --device_data True      the records resident on the device, each
                          step's batch drawn there (data/device_dataset)
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import signal
import tempfile
import time

import numpy as np
import torch

from transferable3d_torch import resolve_device
from transferable3d_torch.data import device_dataset, pickle_io, synthetic
from transferable3d_torch.data.provider import FrustumDataset
from transferable3d_torch.models import registry
from transferable3d_torch.parallel import mesh as mesh_lib
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


def local_ranks(cfg: config_lib.TrainConfig, device=None) -> int:
    """The ranks `num_devices` asks for on this host: N, or with 0 every
    local card (one rank on the CPU)."""
    if cfg.num_devices:
        return cfg.num_devices
    if device is not None and torch.device(device).type == "cpu":
        return 1
    return max(torch.cuda.device_count(), 1)


def _rank_main(rank: int, world: int, body, cfg, device, init_method: str,
               threads: int, out_path: str) -> None:
    """One spawned rank: its mesh, `body` under it, and rank 0's result
    as JSON."""
    torch.set_num_threads(threads)
    mesh = mesh_lib.data_parallel_mesh(
        None if device is None else [device], rank=rank, world_size=world,
        local_rank=rank, local_world_size=world, init_method=init_method)
    try:
        with mesh_lib.use(mesh):
            out = body(cfg, mesh.device)
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(out, f)
    finally:
        mesh_lib.destroy(mesh)


def run_data_parallel(cfg: config_lib.TrainConfig, device, body) -> dict:
    """`body(cfg, device)` on every rank, under the rank's mesh
    (`mesh_lib.use`: the body reads it as `mesh_lib.active()`); rank 0's
    result.

    One rank: `body(cfg, device)` in this process without a mesh (the
    body resolves `device`; on a rank, `device` is the rank's).
    Under a launcher (WORLD_SIZE set) or with `multihost`: this process is
    one rank of the launcher's group. Otherwise `local_ranks` ranks are
    spawned here and joined; a rank that fails raises here."""
    launched = "WORLD_SIZE" in os.environ
    if cfg.multihost and not launched:
        raise ValueError(
            "multihost forms its group from a launcher's environment "
            "(RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT, as torchrun "
            "sets them); none is set")
    world = (int(os.environ["WORLD_SIZE"]) if launched
             else local_ranks(cfg, device))
    if cfg.batch_size % world:
        raise ValueError(f"batch {cfg.batch_size} not divisible by "
                         f"{world} ranks")
    if launched:
        mesh = mesh_lib.data_parallel_mesh(
            None if device is None else [device], init_method="env://")
        try:
            with mesh_lib.use(mesh):
                return body(cfg, mesh.device)
        finally:
            mesh_lib.destroy(mesh)
    if world == 1:
        return body(cfg, device)
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="t3d_ranks_") as tmp:
        out_path = os.path.join(tmp, "rank0.json")
        mp.start_processes(
            _rank_main, nprocs=world, join=True, start_method="spawn",
            args=(world, body, cfg, device,
                  "file://" + os.path.join(tmp, "rendezvous"),
                  max(1, torch.get_num_threads() // world), out_path))
        with open(out_path) as f:
            return json.load(f)


def train(cfg: config_lib.TrainConfig, device=None) -> dict:
    """Train `cfg` on `device` (default the card), on the ranks that
    `num_devices` and `multihost` ask for; the last eval metrics."""
    return run_data_parallel(cfg, device, _train)


def _train(cfg: config_lib.TrainConfig, device) -> dict:
    device = resolve_device(device)
    f32_numerics()
    mesh = mesh_lib.active()
    lead = mesh_lib.rank() == 0
    logger = Logger(cfg.log_dir if lead else None, echo=lead)
    logger.log_string(f"config: {dataclasses.asdict(cfg)}")
    if mesh is not None:
        logger.log_string(f"data parallel: {mesh.world_size} ranks, "
                          f"backend {mesh.backend}")
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
    if mesh is not None:
        mesh_lib.replicate(state, mesh)

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
            # Each rank draws the global batch and trains on its rows.
            if device_iter is not None:
                batches = (mesh_lib.local_rows(b)
                           for b in device_iter.epoch())
            else:
                batches = prefetch(
                    (mesh_lib.local_rows(b)
                     for b in train_ds.epoch_batches(cfg.batch_size)),
                    device=device)
            for batch in batches:
                state, metrics = train_step(state, batch)
                seen += cfg.batch_size
                if mesh_lib.any_rank(interrupted["flag"]) or (
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
                    agg.append({k: float(v) for k, v in eval_step(
                        state, mesh_lib.local_rows(batch)).items()})
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
