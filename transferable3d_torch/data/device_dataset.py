"""Device-resident frustum dataset: per-step sampling and augmentation on
the card.

Port of `transferable3d_tpu/data/device_dataset.py`. The whole dataset
(records padded to a fixed point budget, rotated to the frustum center
once) is uploaded at start-up; each training step then draws its batch
on the device:

  * gather B records,
  * sample `npoints` per record uniformly with replacement from the
    valid prefix (the reference's resampling semantics),
  * random flip (x-mirror, heading -> pi - heading) and depth shift,
    with the heading and size bins re-encoded on the device,
  * one-hot class vectors.

Torch's random streams cannot reproduce JAX's, so a draw is split in
two: `draw` takes the step's random numbers (`u` uniform [B, npoints],
`flip` [B] bool, `z` standard normal [B]) from a `torch.Generator` on
the device, and `batch_from_draws`, a pure function, builds the batch
from them exactly as JAX's `sample_batch` does from its own. Record
order is shuffled on the host with `np.random.RandomState(seed)`, as in
the JAX package. Under data parallelism every rank draws the same
global batch from the shared seed and the drivers keep the rank's rows
(`parallel.mesh.local_rows`).

Memory: R records x M points x C channels f32, e.g. 50k SUN RGB-D
frustums at M=2048, C=6 are some 2.5 GB.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from transferable3d_torch import resolve_device
from transferable3d_torch.core import bins as bins_lib
from transferable3d_torch.core import geometry
from transferable3d_torch.data.provider import FrustumRecord
from transferable3d_torch.utils import profiling


class DeviceFrustums(NamedTuple):
    """All-records device tensors (already rotated to the frustum frame)."""

    points: torch.Tensor       # [R, M, C] zero-padded
    seg: torch.Tensor          # [R, M] int8
    count: torch.Tensor        # [R] int32 valid points per record
    center: torch.Tensor       # [R, 3] GT center (frustum frame)
    size: torch.Tensor         # [R, 3]
    heading: torch.Tensor      # [R] GT heading (frustum frame)
    class_idx: torch.Tensor    # [R] int32

    @property
    def num_records(self) -> int:
        return self.points.shape[0]


def build_device_dataset(records: Sequence[FrustumRecord],
                         cfg: bins_lib.BinConfig, max_points: int = 2048,
                         device=None) -> DeviceFrustums:
    """One-time host pass: rotate-to-center, pad/truncate, upload (to the
    card unless `device` says otherwise)."""
    r = len(records)
    c = records[0].points.shape[1]
    points = np.zeros((r, max_points, c), np.float32)
    seg = np.zeros((r, max_points), np.int8)
    count = np.zeros(r, np.int32)
    center = np.zeros((r, 3), np.float32)
    size = np.ones((r, 3), np.float32)
    heading = np.zeros(r, np.float32)
    class_idx = np.zeros(r, np.int32)

    for i, rec in enumerate(records):
        pts = rec.points.astype(np.float32)
        m = min(pts.shape[0], max_points)
        ang = np.float32(rec.frustum_angle)
        pts = pts[:m].copy()
        pts[:, :3] = geometry.rotate_points_y_np(pts[None, :, :3], ang)[0]
        points[i, :m] = pts
        if rec.seg is not None:
            seg[i, :m] = rec.seg[:m]
        count[i] = m
        if rec.center is not None:
            center[i] = geometry.rotate_points_y_np(
                np.asarray(rec.center, np.float32)[None, None, :],
                ang)[0, 0]
            size[i] = rec.size
            heading[i] = float(rec.heading) + float(ang)
        class_idx[i] = rec.class_idx

    device = resolve_device(device)
    return DeviceFrustums(*(torch.from_numpy(a).to(device) for a in (
        points, seg, count, center, size, heading, class_idx)))


def draw(generator: torch.Generator, b: int, npoints: int
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One step's random numbers on the generator's device: `u` [b,
    npoints] uniform in [0, 1), `flip` [b] Bernoulli(0.5), `z` [b]
    standard normal."""
    dev = generator.device
    u = torch.rand((b, npoints), generator=generator, device=dev)
    flip = torch.rand((b,), generator=generator, device=dev) < 0.5
    z = torch.randn((b,), generator=generator, device=dev)
    return u, flip, z


def batch_from_draws(data: DeviceFrustums, idxs: torch.Tensor,
                     u: torch.Tensor, flip: torch.Tensor, z: torch.Tensor,
                     cfg: bins_lib.BinConfig, random_flip: bool = True,
                     random_shift: bool = True) -> Dict[str, torch.Tensor]:
    """The train batch of records `idxs` [B] from the draws (JAX's
    `sample_batch` after its `jax.random` calls)."""
    pts_all = data.points[idxs]                 # [B, M, C]
    seg_all = data.seg[idxs]                    # [B, M]
    count = torch.clamp_min(data.count[idxs], 1)
    center = data.center[idxs]
    size = data.size[idxs]
    heading = data.heading[idxs]
    class_idx = data.class_idx[idxs]

    # Uniform-with-replacement sampling from each record's valid prefix.
    sel = torch.floor(u * count[:, None].to(torch.float32)).to(torch.int64)
    sel = torch.minimum(sel, count[:, None].to(torch.int64) - 1)
    pts = torch.gather(pts_all, 1,
                       sel[..., None].expand(-1, -1, pts_all.shape[-1]))
    seg = torch.gather(seg_all, 1, sel).to(torch.int64)

    if random_flip:
        sign = torch.where(flip, -1.0, 1.0)
        pts = pts.clone()
        pts[..., 0] *= sign[:, None]
        center = center.clone()
        center[:, 0] *= sign
        heading = torch.where(flip, math.pi - heading, heading)
    if random_shift:
        dist = torch.sqrt(center[:, 0] ** 2 + center[:, 2] ** 2)
        shift = torch.clamp(z * dist * 0.05, -dist * 0.2, dist * 0.2)
        pts = pts.clone()
        pts[..., 2] += shift[:, None]
        center = center.clone()
        center[:, 2] += shift

    hcls, hres = bins_lib.angle_to_class(heading, cfg.num_heading_bin)
    scls, sres = bins_lib.size_to_class(size, class_idx, cfg)
    class_idx = class_idx.to(torch.int64)
    return {
        "points": pts,
        "seg": seg,
        "center": center,
        "heading_class": hcls.to(torch.int64),
        "heading_residual": hres,
        "size_class": scls.to(torch.int64),
        "size_residual": sres,
        "one_hot": torch.nn.functional.one_hot(
            class_idx, cfg.num_classes).to(torch.float32),
        "class_idx": class_idx,
    }


def sample_batch(data: DeviceFrustums, generator: torch.Generator,
                 idxs: torch.Tensor, npoints: int,
                 cfg: bins_lib.BinConfig, random_flip: bool = True,
                 random_shift: bool = True) -> Dict[str, torch.Tensor]:
    """Draw a train batch on the device. idxs [B] record indices."""
    with profiling.span("t3d.draw"):
        u, flip, z = draw(generator, idxs.shape[0], npoints)
        return batch_from_draws(data, idxs, u, flip, z, cfg, random_flip,
                                random_shift)


class DeviceEpochIterator:
    """Host-side shuffling of record indices; everything else on the
    device, drawn from a generator there seeded with `seed`."""

    def __init__(self, data: DeviceFrustums, cfg: bins_lib.BinConfig,
                 batch_size: int, npoints: int, seed: int = 0,
                 random_flip: bool = True, random_shift: bool = True):
        self.data = data
        self.cfg = cfg
        self.batch_size = batch_size
        self.npoints = npoints
        self.random_flip = random_flip
        self.random_shift = random_shift
        self._np_rng = np.random.RandomState(seed)
        self.generator = torch.Generator(
            device=data.points.device).manual_seed(seed)

    def epoch(self):
        order = self._np_rng.permutation(self.data.num_records)
        n_batches = len(order) // self.batch_size
        for i in range(n_batches):
            idxs = torch.as_tensor(
                order[i * self.batch_size:(i + 1) * self.batch_size],
                device=self.data.points.device)
            yield sample_batch(self.data, self.generator, idxs,
                               self.npoints, self.cfg, self.random_flip,
                               self.random_shift)
