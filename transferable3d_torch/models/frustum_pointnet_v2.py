"""F-PointNet v2: PointNet++ backbones for seg + box estimation.

Port of `transferable3d_tpu/models/frustum_pointnet_v2.py`:

  seg net:  SA-MSG(128; r .2/.4/.8; k 32/64/128) ->
            SA-MSG(32; r .4/.8/1.6; k 64/64/128) ->
            SA(group_all; 128,256,1024) -> FP x3 -> head -> 2 logits
  box net:  SA(128, r .2, k 64; 64,64,128) ->
            SA(32, r .4, k 64; 128,128,256) ->
            SA(group_all; 256,256,512) -> FC head

Input widths are explicit here (flax infers them at init): `in_channels`
is the point width C (xyz + extras) and the class count comes from the
bin config. The seg head's dropout (rate 0.5, train mode only) draws its
mask from the `generator` passed to `forward` (models/layers.dropout).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from transferable3d_torch.core import bins as bins_lib
from transferable3d_torch.models import model_util
from transferable3d_torch.models.frustum_pointnet_v1 import TNet
from transferable3d_torch.models import layers
from transferable3d_torch.models.layers import Dense, MLPHead, PointMLP
from transferable3d_torch.models.pointnet2 import (FeaturePropagation,
                                                  SetAbstraction,
                                                  SetAbstractionMSG)


class InstanceSegNetV2(nn.Module):
    def __init__(self, num_classes: int, in_channels: int = 4, *,
                 dtype=torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.dtype = dtype
        extra = in_channels - 3
        self.sa1 = SetAbstractionMSG(
            128, (0.2, 0.4, 0.8), (32, 64, 128),
            ((32, 32, 64), (64, 64, 128), (64, 96, 128)), extra, **kw)
        c1 = self.sa1.out_channels
        self.sa2 = SetAbstractionMSG(
            32, (0.4, 0.8, 1.6), (64, 64, 128),
            ((64, 64, 128), (128, 128, 256), (128, 128, 256)), c1, **kw)
        c2 = self.sa2.out_channels
        self.sa3 = SetAbstraction(0, 0.0, 0, (128, 256, 1024), c2,
                                  group_all=True, **kw)
        self.fp1 = FeaturePropagation(1024 + num_classes + c2, (128, 128),
                                      **kw)
        self.fp2 = FeaturePropagation(128 + c1, (128, 128), **kw)
        skip = in_channels if extra > 0 else 3
        self.fp3 = FeaturePropagation(128 + skip, (128, 128), **kw)
        self.head_mlp = PointMLP(128, [128], **kw)
        self.seg_out = Dense(128, 2, dtype=torch.float32, device=device,
                             generator=generator)

    def forward(self, points, one_hot, bn_momentum: float = 0.9,
                generator: Optional[torch.Generator] = None):
        xyz = points[..., :3].contiguous()
        feats = points[..., 3:] if points.shape[-1] > 3 else None
        xyz1, f1 = self.sa1(xyz, feats, bn_momentum)
        xyz2, f2 = self.sa2(xyz1, f1, bn_momentum)
        xyz3, f3 = self.sa3(xyz2, f2, bn_momentum)
        g = torch.cat([f3, one_hot.to(f3.dtype)[:, None, :]], dim=-1)
        u2 = self.fp1(xyz2, xyz3, f2, g, bn_momentum)
        u1 = self.fp2(xyz1, xyz2, f1, u2, bn_momentum)
        skip = points if feats is not None else xyz
        u0 = self.fp3(xyz, xyz1, skip.to(self.dtype), u1, bn_momentum)
        x = self.head_mlp(u0, bn_momentum)
        if self.training:
            if generator is None:
                raise ValueError("train-mode dropout draws its mask from an "
                                 "explicit torch.Generator; pass one")
            x = layers.dropout(x, 0.5, generator)
        return self.seg_out(x)


class BoxEstimationNetV2(nn.Module):
    def __init__(self, cfg: bins_lib.BinConfig, *, dtype=torch.float32,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.sa1 = SetAbstraction(128, 0.2, 64, (64, 64, 128), 0, **kw)
        self.sa2 = SetAbstraction(32, 0.4, 64, (128, 128, 256), 128, **kw)
        self.sa3 = SetAbstraction(0, 0.0, 0, (256, 256, 512), 256,
                                  group_all=True, **kw)
        self.head = MLPHead(512 + cfg.num_classes, [512, 256],
                            cfg.box_output_dim, **kw)

    def forward(self, obj_points, one_hot, bn_momentum: float = 0.9):
        xyz1, f1 = self.sa1(obj_points, None, bn_momentum)
        xyz2, f2 = self.sa2(xyz1, f1, bn_momentum)
        _, f3 = self.sa3(xyz2, f2, bn_momentum)
        g = torch.cat([f3[:, 0], one_hot.to(f3.dtype)], dim=-1)
        return self.head(g, bn_momentum)


class FrustumPointNetV2(nn.Module):
    """Full v2 pipeline -> the end_points dict of the JAX model.

    Weights are drawn on the CPU from `generator` (default: a generator
    seeded with 0) and then moved to `device`."""

    def __init__(self, cfg: bins_lib.BinConfig, *, dtype=torch.float32,
                 num_object_point: int = model_util.NUM_OBJECT_POINT,
                 in_channels: int = 4, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.cfg = cfg
        self.num_object_point = num_object_point
        self.seg_net = InstanceSegNetV2(cfg.num_classes, in_channels, **kw)
        self.tnet = TNet(cfg.num_classes, **kw)
        self.box_net = BoxEstimationNetV2(cfg, **kw)

    def forward(self, points, one_hot, bn_momentum: float = 0.9,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """`generator` draws the seg head's dropout mask in train mode
        (required there, as flax requires a dropout rng)."""
        seg_logits = self.seg_net(points, one_hot, bn_momentum, generator)
        masked = model_util.point_cloud_masking(points, seg_logits,
                                                self.num_object_point)
        delta_c1 = self.tnet(masked.object_points, one_hot, bn_momentum)
        stage1_center = delta_c1 + masked.mask_centroid
        obj_recentered = masked.object_points - delta_c1[:, None, :]
        box_out = self.box_net(obj_recentered, one_hot, bn_momentum)
        end_points = model_util.parse_box_output(box_out, self.cfg)
        end_points["seg_logits"] = seg_logits
        end_points["mask"] = masked.mask
        end_points["mask_centroid"] = masked.mask_centroid
        end_points["stage1_center"] = stage1_center
        end_points["center"] = end_points["center_delta"] + stage1_center
        return end_points
