"""PointNet++ set-abstraction / feature-propagation modules.

Port of `transferable3d_tpu/models/pointnet2.py`. The first layer of each
grouped MLP is factored through the grouping, exactly as in the JAX
module:

    Dense0(concat(xyz_j - c_s, feat_j)) == Dense0(concat(xyz, feat))[j]
                                           - c_s @ W0[:3]

so the grouping gathers layer-1 preactivations `pf` and a per-centroid
correction `qc`. `GroupedPointMLP` then takes the fused branch
(ops/fused_sa: one CUDA kernel per SA scale on the card) when its dtype
is bfloat16 and `T3D_FUSED_SA` is "1" (the default), read at call time;
otherwise the unfused branch: `grouped_payload` (kernels K3/K4 for bf16
on the card), then BN, ReLU and Dense per layer and the max over K
(pointnet2.py:146-162; the JAX package additionally requires a TPU for
the fused branch, the port's runs on any device). The fused branch has
no training kernels yet, so bf16 training needs `T3D_FUSED_SA=0`.
Parameter names match the flax tree (`dense_i`, `bn_i`, `mlp`, `mlp_i`).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import torch
from torch import nn

from transferable3d_torch.models.layers import (Dense, PointMLP,
                                                ScheduledBatchNorm)
from transferable3d_torch.ops import fused_sa
from transferable3d_torch.ops.grouping import grouped_payload
from transferable3d_torch.ops.interpolate import three_interpolate, three_nn
from transferable3d_torch.ops.sampling import (farthest_point_sample,
                                              gather_points)


class GroupedPointMLP(nn.Module):
    """Ball-query grouping + per-group shared MLP + max-pool over K.

    `in_channels` is the feature width besides xyz (0 for none)."""

    def __init__(self, in_channels: int, features: Sequence[int],
                 radius: float, nsample: int, *, dtype=torch.float32,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.features = tuple(features)
        self.radius = radius
        self.nsample = nsample
        self.dtype = dtype
        self.cin = 3 + in_channels
        f_in = self.cin
        for i, f in enumerate(self.features):
            self.add_module(f"dense_{i}", Dense(
                f_in, f, dtype=dtype, device=device, generator=generator))
            self.add_module(f"bn_{i}", ScheduledBatchNorm(
                f, dtype=dtype, device=device))
            f_in = f

    def forward(self, new_xyz, xyz, feats, bn_momentum: float = 0.9):
        dense0 = self.dense_0
        src = (xyz if feats is None
               else torch.cat([xyz, feats.to(xyz.dtype)], dim=-1))
        pf = dense0(src.to(self.dtype))  # [B, N, F1] (incl. bias)
        # Centroid term -c_s @ W0[:3]: the shared Dense on a zero-padded
        # centroid minus the Dense of zeros (the bias cancels).
        b, s, _ = new_xyz.shape
        cent_pad = torch.cat(
            [new_xyz.to(self.dtype),
             torch.zeros(b, s, self.cin - 3, dtype=self.dtype,
                         device=new_xyz.device)], dim=-1)
        qc = dense0(cent_pad) - dense0(torch.zeros_like(cent_pad))
        if (self.dtype == torch.bfloat16
                and os.environ.get("T3D_FUSED_SA", "1") == "1"):
            return self._fused(new_xyz, xyz, pf, qc)
        grouped_pf, _ = grouped_payload(new_xyz, xyz, pf, self.radius,
                                        self.nsample)  # [B, S, K, F1]
        x = grouped_pf - qc[:, :, None, :]
        for i in range(len(self.features)):
            if i:
                x = getattr(self, f"dense_{i}")(x)
            x = torch.relu(getattr(self, f"bn_{i}")(x, bn_momentum))
        return x.amax(dim=2)  # [B, S, features[-1]]

    def _fused(self, new_xyz, xyz, pf, qc):
        depth = len(self.features)
        bns = [getattr(self, f"bn_{i}") for i in range(depth)]
        dense = [getattr(self, f"dense_{i}") for i in range(1, depth)]
        pooled, _, _ = fused_sa.fused_grouped_chain(
            new_xyz, xyz, pf, qc,
            [bn.scale for bn in bns], [bn.bias for bn in bns],
            [d.weight.t() for d in dense], [d.bias for d in dense],
            self.radius, self.nsample, 1e-3, self.training,
            [(bn.mean, bn.var) for bn in bns])
        return pooled


class SetAbstraction(nn.Module):
    """Single-scale SA: FPS -> ball query -> grouped MLP -> max-pool;
    `group_all` collapses to one global group."""

    def __init__(self, npoint: int, radius: float, nsample: int,
                 mlp: Sequence[int], in_channels: int, *,
                 group_all: bool = False, dtype=torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.npoint = npoint
        self.group_all = group_all
        self.dtype = dtype
        if group_all:
            self.mlp = PointMLP(3 + in_channels, mlp, dtype=dtype,
                                device=device, generator=generator)
        else:
            self.mlp = GroupedPointMLP(in_channels, mlp, radius, nsample,
                                       dtype=dtype, device=device,
                                       generator=generator)

    def forward(self, xyz, features, bn_momentum: float = 0.9):
        if self.group_all:
            # torch.cat promotes [f32, bf16] to f32, as jnp.concatenate does.
            grouped = (xyz if features is None
                       else torch.cat([xyz, features], dim=-1))
            new_xyz = torch.zeros(xyz.shape[0], 1, 3, dtype=xyz.dtype,
                                  device=xyz.device)
            x = self.mlp(grouped[:, None].to(self.dtype), bn_momentum)
            return new_xyz, x.amax(dim=2)
        new_xyz = gather_points(xyz, farthest_point_sample(xyz, self.npoint))
        return new_xyz, self.mlp(new_xyz, xyz, features, bn_momentum)


class SetAbstractionMSG(nn.Module):
    """Multi-scale grouping SA: one FPS, one grouped MLP per radius."""

    def __init__(self, npoint: int, radii: Sequence[float],
                 nsamples: Sequence[int], mlps: Sequence[Sequence[int]],
                 in_channels: int, *, dtype=torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.npoint = npoint
        self.scales = len(radii)
        for i, (r, k, mlp) in enumerate(zip(radii, nsamples, mlps)):
            self.add_module(f"mlp_{i}", GroupedPointMLP(
                in_channels, mlp, r, k, dtype=dtype, device=device,
                generator=generator))
        self.out_channels = sum(m[-1] for m in mlps)

    def forward(self, xyz, features, bn_momentum: float = 0.9):
        new_xyz = gather_points(xyz, farthest_point_sample(xyz, self.npoint))
        outs = [getattr(self, f"mlp_{i}")(new_xyz, xyz, features,
                                          bn_momentum)
                for i in range(self.scales)]
        return new_xyz, torch.cat(outs, dim=-1)


class FeaturePropagation(nn.Module):
    """3-NN inverse-squared-distance upsampling + per-point MLP;
    `in_channels` = width of feat_from + width of feat_to."""

    def __init__(self, in_channels: int, mlp: Sequence[int], *,
                 dtype=torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.mlp = PointMLP(in_channels, mlp, dtype=dtype, device=device,
                            generator=generator)

    def forward(self, xyz_to, xyz_from, feat_to, feat_from,
                bn_momentum: float = 0.9):
        dist, idx = three_nn(xyz_to, xyz_from)
        up = three_interpolate(feat_from, idx, dist)
        if feat_to is not None:
            up = torch.cat([up, feat_to], dim=-1)
        return self.mlp(up.to(self.dtype), bn_momentum)
