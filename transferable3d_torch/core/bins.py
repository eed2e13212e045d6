"""Heading / size bin parameterization + dataset class constants.

JAX-free copy of `transferable3d_tpu/core/bins.py`: the constants,
`BinConfig` (without `from_boxes`, which nothing calls), the numpy
codecs (`angle_to_class_np`, `class_to_angle_np`, `size_to_class_np`,
`class_to_size_np`, bins.py:162-222) and the torch
codecs `angle_to_class`, `class_to_angle`, `size_to_class`,
`class_to_size` (bins.py:183-233). The JAX module imports `jax.numpy` at
import time, so the port cannot import it; tests/test_torch_layers.py and
tests/test_torch_geometry.py hold this copy equal to it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import numpy as np
import torch

NUM_HEADING_BIN = 12
NUM_OBJECT_POINT = 512  # points fed to T-Net / box head after masking

SUNRGBD_CLASSES: Tuple[str, ...] = (
    "bed", "table", "sofa", "chair", "toilet", "desk", "dresser",
    "night_stand", "bookshelf", "bathtub",
)

KITTI_CLASSES: Tuple[str, ...] = (
    "Car", "Van", "Truck", "Pedestrian", "Person_sitting", "Cyclist",
    "Tram", "Misc",
)

# Per-class mean (l, w, h) in meters (published training-split averages).
KITTI_MEAN_SIZES: Dict[str, Tuple[float, float, float]] = {
    "Car": (3.883, 1.629, 1.526),
    "Van": (5.068, 1.901, 2.205),
    "Truck": (10.136, 2.585, 3.252),
    "Pedestrian": (0.844, 0.661, 1.763),
    "Person_sitting": (0.801, 0.598, 1.275),
    "Cyclist": (1.763, 0.597, 1.737),
    "Tram": (16.172, 2.532, 3.531),
    "Misc": (3.643, 1.543, 1.923),
}

SUNRGBD_MEAN_SIZES: Dict[str, Tuple[float, float, float]] = {
    "bed": (2.114, 1.620, 0.927),
    "table": (1.280, 0.791, 0.718),
    "sofa": (1.867, 0.924, 0.845),
    "chair": (0.592, 0.553, 0.827),
    "toilet": (0.699, 0.454, 0.756),
    "desk": (1.346, 0.695, 0.736),
    "dresser": (0.529, 1.003, 1.173),
    "night_stand": (0.501, 0.632, 0.683),
    "bookshelf": (0.405, 1.071, 1.689),
    "bathtub": (0.766, 1.398, 0.473),
}


@dataclasses.dataclass(frozen=True)
class BinConfig:
    """Static bin configuration for one dataset."""

    classes: Tuple[str, ...]
    mean_sizes: Tuple[Tuple[float, float, float], ...]  # per class (l, w, h)
    num_heading_bin: int = NUM_HEADING_BIN

    @property
    def num_size_cluster(self) -> int:
        return len(self.mean_sizes)

    @property
    def num_classes(self) -> int:
        return len(self.classes)

    @property
    def box_output_dim(self) -> int:
        # 3 (center) + 2*NH (heading scores + residuals) + 4*NS (size
        # scores + 3 residuals per cluster)
        return 3 + 2 * self.num_heading_bin + 4 * self.num_size_cluster

    def mean_size_array(self) -> np.ndarray:
        return np.asarray(self.mean_sizes, dtype=np.float32)

    def class_index(self, name: str) -> int:
        return self.classes.index(name)

    @staticmethod
    def sunrgbd() -> "BinConfig":
        return BinConfig(
            classes=SUNRGBD_CLASSES,
            mean_sizes=tuple(SUNRGBD_MEAN_SIZES[c] for c in SUNRGBD_CLASSES))

    @staticmethod
    def kitti() -> "BinConfig":
        return BinConfig(
            classes=KITTI_CLASSES,
            mean_sizes=tuple(KITTI_MEAN_SIZES[c] for c in KITTI_CLASSES))


SUNRGBD = BinConfig.sunrgbd()
KITTI = BinConfig.kitti()


def angle_to_class_np(angle: np.ndarray, num_bin: int = NUM_HEADING_BIN):
    """Continuous heading -> (bin index, residual). Host numpy version."""
    angle = np.mod(angle, 2 * np.pi)
    w = 2 * np.pi / num_bin
    shifted = np.mod(angle + w / 2.0, 2 * np.pi)
    cls = np.floor(shifted / w).astype(np.int32)
    residual = shifted - (cls * w + w / 2.0)
    return cls, residual.astype(np.float32)


def class_to_angle_np(cls: np.ndarray, residual: np.ndarray,
                      num_bin: int = NUM_HEADING_BIN,
                      limit_period: bool = True) -> np.ndarray:
    w = 2 * np.pi / num_bin
    angle = cls * w + residual
    if limit_period:
        angle = np.mod(angle, 2 * np.pi)
        angle = np.where(angle > np.pi, angle - 2 * np.pi, angle)
    return angle.astype(np.float32)


def size_to_class_np(size: np.ndarray, class_idx: np.ndarray,
                     cfg: BinConfig):
    """Size cluster = semantic class: size [..., 3] (l, w, h) and
    class_idx [...] int -> (cluster, residual)."""
    means = cfg.mean_size_array()
    cluster = class_idx.astype(np.int32)
    residual = size - means[cluster]
    return cluster, residual.astype(np.float32)


def class_to_size_np(cluster: np.ndarray, residual: np.ndarray,
                     cfg: BinConfig) -> np.ndarray:
    means = cfg.mean_size_array()
    return (means[cluster] + residual).astype(np.float32)


def angle_to_class(angle: torch.Tensor, num_bin: int = NUM_HEADING_BIN):
    """Heading -> (bin index int32, residual)."""
    angle = torch.remainder(angle, 2 * math.pi)
    w = 2 * math.pi / num_bin
    shifted = torch.remainder(angle + w / 2.0, 2 * math.pi)
    cls = torch.floor(shifted / w).to(torch.int32)
    residual = shifted - (cls.to(angle.dtype) * w + w / 2.0)
    return cls, residual


def size_to_class(size: torch.Tensor, class_idx: torch.Tensor,
                  cfg: BinConfig):
    means = torch.as_tensor(cfg.mean_size_array(), device=size.device)
    cluster = class_idx.to(torch.int32)
    return cluster, size - means[cluster.long()]


def class_to_angle(cls: torch.Tensor, residual: torch.Tensor,
                   num_bin: int = NUM_HEADING_BIN) -> torch.Tensor:
    """Heading bin + residual -> angle in (-pi, pi]."""
    w = 2 * math.pi / num_bin
    angle = cls.to(residual.dtype) * w + residual
    angle = torch.remainder(angle, 2 * math.pi)
    return torch.where(angle > math.pi, angle - 2 * math.pi, angle)


def class_to_size(cluster: torch.Tensor, residual: torch.Tensor,
                  cfg: BinConfig) -> torch.Tensor:
    means = torch.as_tensor(cfg.mean_size_array(), device=residual.device)
    return means[cluster] + residual
