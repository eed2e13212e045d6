"""Typed training configs + the five BASELINE.json preset configs.

JAX-free copy of `transferable3d_tpu/train/config.py`, field for field:
the same `TrainConfig`, `PRESETS`, `add_cli_args` and
`config_from_args`, so `python -m transferable3d_torch.train.train_sup`
and `.test` parse the same command lines as `t3d-train` and `t3d-test`;
`bin_config()` returns the port's `core/bins` constants. Fields that name
the JAX runtime keep their names and meaning: `num_devices` is the
number of data-parallel ranks (0: every local card), `multihost` forms
the group from a launcher's environment (torchrun; see
`train_sup.run_data_parallel`), and `grad_accum_steps` is the port's
`Optimizer` accumulation. tests/test_torch_driver.py holds it equal to
the original.

Capability parity target: the reference's argparse/tf.app.flags CLI
surface (SURVEY.md §5.6) — same knobs (model, num_point, batch size, lr +
decay, max epochs, restore path, log dir), as a dataclass with CLI
overrides instead of scattered flags.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Tuple

from transferable3d_torch.core import bins as bins_lib


@dataclasses.dataclass
class TrainConfig:
    # model / data
    model: str = "frustum_pointnets_v1"
    dataset: str = "sunrgbd"            # sunrgbd | kitti | synthetic
    data_path: str = ""                  # pickle path ('' => synthetic)
    num_point: int = 1024
    num_channels: int = 4                # xyz + intensity (6 for rgb)
    classes: Tuple[str, ...] = ()        # () => dataset default whitelist
    # optimization (reference train.py defaults)
    batch_size: int = 32
    max_epoch: int = 201
    learning_rate: float = 1e-3
    lr_decay_rate: float = 0.7
    lr_decay_samples: float = 200000.0
    min_lr: float = 1e-5
    bn_init_decay: float = 0.5
    bn_decay_rate: float = 0.5
    bn_decay_samples: float = 200000.0
    bn_decay_clip: float = 0.99
    box_loss_weight: float = 1.0
    corner_loss_weight: float = 10.0
    # runtime
    compute_dtype: str = "float32"       # float32 | bfloat16
    num_devices: int = 0                 # 0 => all local devices (DP mesh)
    device_data: bool = False            # dataset resident in HBM,
    max_points_device: int = 2048        # per-step sampling on device
    grad_accum_steps: int = 1            # optax.MultiSteps microbatching
    multihost: bool = False              # jax.distributed.initialize()
    # augmentation
    random_flip: bool = True
    random_shift: bool = True
    # bookkeeping
    log_dir: str = "log"
    ckpt_every_epochs: int = 10
    eval_every_epochs: int = 5
    restore_path: str = ""
    seed: int = 0
    max_steps: int = 0                   # 0 => unlimited (for smoke runs)
    # synthetic-data knobs (tests / smoke)
    synthetic_train: int = 512
    synthetic_val: int = 128
    synthetic_hard: bool = False   # depth-sensor-like clouds (surface-only
    #                                + occlusion; see data/synthetic.py)

    def bin_config(self) -> bins_lib.BinConfig:
        if self.dataset == "kitti":
            return bins_lib.KITTI
        return bins_lib.SUNRGBD


# The five BASELINE.json configs, in build order (SURVEY.md §7).
PRESETS = {
    # 1. Box-estimation net only: single class (chair), 512-pt frustums
    #    from GT 2D boxes, mini split.
    "config1_boxonly_chair": TrainConfig(
        model="box_estimation_v1", dataset="sunrgbd", num_point=512,
        classes=("chair",), batch_size=32, max_epoch=31),
    # 2. Full F-PointNet v1, 1024 pts, SUN-RGBD 10-class supervised.
    "config2_fpointnet_v1_sunrgbd": TrainConfig(
        model="frustum_pointnets_v1", dataset="sunrgbd", num_point=1024,
        num_channels=6, batch_size=32),
    # 3. KITTI pipeline: car/ped/cyclist from 2D detections.
    "config3_kitti": TrainConfig(
        model="frustum_pointnets_v1", dataset="kitti", num_point=1024,
        num_channels=4, batch_size=32,
        classes=("Car", "Pedestrian", "Cyclist")),
    # 4. Cross-category transfer (semi-supervised; see train_semisup.py).
    "config4_transfer": TrainConfig(
        model="frustum_pointnets_v1", dataset="sunrgbd", num_point=1024,
        num_channels=6, batch_size=32),
    # 5. Large-batch TPU-mesh run with bf16 compute.
    "config5_mesh_large_batch": TrainConfig(
        model="frustum_pointnets_v1", dataset="sunrgbd", num_point=1024,
        num_channels=6, batch_size=256, compute_dtype="bfloat16",
        learning_rate=2e-3, lr_decay_samples=1600000.0,
        bn_decay_samples=1600000.0),
}


def add_cli_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--preset", choices=sorted(PRESETS), default=None,
                        help="start from a BASELINE.json preset config")
    for f in dataclasses.fields(TrainConfig):
        if f.name == "classes":
            parser.add_argument("--classes", type=str, default=None,
                                help="comma-separated class whitelist")
        elif f.type == "bool" or isinstance(f.default, bool):
            parser.add_argument(f"--{f.name}", type=lambda s: s == "True",
                                default=None, metavar="True|False")
        else:
            parser.add_argument(f"--{f.name}", type=type(f.default),
                                default=None)


def config_from_args(args: argparse.Namespace) -> TrainConfig:
    cfg = dataclasses.replace(
        PRESETS[args.preset]) if args.preset else TrainConfig()
    for f in dataclasses.fields(TrainConfig):
        v = getattr(args, f.name, None)
        if v is not None:
            if f.name == "classes":
                v = tuple(s for s in v.split(",") if s)
            setattr(cfg, f.name, v)
    return cfg
