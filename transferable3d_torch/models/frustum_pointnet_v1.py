"""F-PointNet v1: instance segmentation + T-Net + amodal box estimation.

Port of `transferable3d_tpu/models/frustum_pointnet_v1.py`:

  stage 1 (seg):   per-point MLP (64,64,64,128,1024) -> global max-pool ->
                   concat(point feat 64, global 1024, one-hot K) ->
                   per-point MLP (512,256,128,128) + dropout -> 2 logits
  masking:         hard mask, masked centroid, 512 object points
  stage 2 (T-Net): MLP (128,128,256) -> pool -> concat one-hot ->
                   FC (256,128) -> delta-center c1
  stage 3 (box):   MLP (128,128,256,512) -> pool -> concat one-hot ->
                   FC (512,256) -> [3 + 2*NH + 4*NS]

  center = c2 + c1 + mask_centroid ; stage1_center = c1 + mask_centroid

Every "1x1 conv" is a Dense over [B, N, C]; the model reaches no
hand-written kernel. Module names are the flax names, so
`utils/bridge.py` maps a flax variable tree onto `state_dict()` one to
one. Input widths are explicit (flax infers them at init): `in_channels`
is the point width C and the class count comes from the bin config. The
seg net's dropout (rate 0.5, train mode only) draws its mask from the
`generator` passed to `forward` (models/layers.dropout).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from transferable3d_torch.core import bins as bins_lib
from transferable3d_torch.models import layers, model_util
from transferable3d_torch.models.layers import (Dense, MLPHead, PointMLP,
                                                ScheduledBatchNorm)
from transferable3d_torch.parallel import mesh as mesh_lib
from transferable3d_torch.utils import profiling


class InstanceSegNetV1(nn.Module):
    """Per-point foreground/background logits. [B,N,C],[B,K] -> [B,N,2]."""

    def __init__(self, num_classes: int, in_channels: int = 4, *,
                 dtype=torch.float32, dropout_rate: float = 0.5,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.dtype = dtype
        self.dropout_rate = dropout_rate
        self.mlp1 = PointMLP(in_channels, [64, 64], **kw)
        self.mlp2 = PointMLP(64, [64, 128, 1024], pool=True, **kw)
        # Dense(concat(point_feat, global, one_hot)) with its weight
        # matrix split by rows: the global and one-hot part is computed
        # once per frustum and broadcast over the points, so no
        # [B, N, 1088 + K] tensor is built (same function, same
        # parameter count; the bias lives in `mlp3_point`).
        self.mlp3_point = Dense(64, 512, **kw)
        self.mlp3_global = Dense(1024 + num_classes, 512, use_bias=False,
                                 **kw)
        self.mlp3_bn = ScheduledBatchNorm(512, dtype=dtype, device=device)
        self.mlp3 = PointMLP(512, [256, 128, 128], **kw)
        self.seg_out = Dense(128, 2, dtype=torch.float32, device=device,
                             generator=generator)

    def forward(self, points, one_hot, bn_momentum: float = 0.9,
                generator: Optional[torch.Generator] = None):
        x = self.mlp1(points.to(self.dtype), bn_momentum)
        point_feat = x                                        # [B, N, 64]
        global_feat = self.mlp2(x, bn_momentum)               # [B, 1024]
        g = torch.cat([global_feat, one_hot.to(self.dtype)], dim=-1)
        x = self.mlp3_point(point_feat) + self.mlp3_global(g)[:, None, :]
        x = torch.relu(self.mlp3_bn(x, bn_momentum))
        x = self.mlp3(x, bn_momentum)
        if self.training and self.dropout_rate > 0:
            if generator is None:
                raise ValueError("train-mode dropout draws its mask from an "
                                 "explicit torch.Generator; pass one")
            x = layers.dropout(x, self.dropout_rate, generator)
        return self.seg_out(x)


class TNet(nn.Module):
    """Object points [B, M, 3] + one-hot [B, K] -> delta-center [B, 3]."""

    def __init__(self, num_classes: int, *, dtype=torch.float32,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.mlp = PointMLP(3, [128, 128, 256], pool=True, dtype=dtype,
                            device=device, generator=generator)
        self.head = MLPHead(256 + num_classes, [256, 128], 3, dtype=dtype,
                            device=device, generator=generator)

    def forward(self, obj_points, one_hot, bn_momentum: float = 0.9):
        x = self.mlp(obj_points.to(self.dtype), bn_momentum)  # [B, 256]
        x = torch.cat([x, one_hot.to(self.dtype)], dim=-1)
        return self.head(x, bn_momentum)


class BoxEstimationNetV1(nn.Module):
    """Amodal box head: object points -> [B, 3 + 2*NH + 4*NS]."""

    def __init__(self, cfg: bins_lib.BinConfig, *, dtype=torch.float32,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.mlp = PointMLP(3, [128, 128, 256, 512], pool=True, dtype=dtype,
                            device=device, generator=generator)
        self.head = MLPHead(512 + cfg.num_classes, [512, 256],
                            cfg.box_output_dim, dtype=dtype, device=device,
                            generator=generator)

    def forward(self, obj_points, one_hot, bn_momentum: float = 0.9):
        """On a points mesh outside the replicated scope (in
        `BoxEstimationOnly`), the point MLP runs on the rank's slice and
        pools across the points group, and the head runs under
        `replicated_over_points`; inside it (in the v1 and v2 models) the
        whole net sees the whole object points."""
        x = mesh_lib.to_replicated(
            self.mlp(obj_points.to(self.dtype), bn_momentum))  # [B, 512]
        with mesh_lib.replicated_over_points():
            x = torch.cat([x, one_hot.to(self.dtype)], dim=-1)
            return self.head(x, bn_momentum)


def _model_generator(generator):
    return (torch.Generator().manual_seed(0) if generator is None
            else generator)


class FrustumPointNetV1(nn.Module):
    """Full 3-stage pipeline -> the end_points dict of the JAX model.

    Weights are drawn on the CPU from `generator` (default: a generator
    seeded with 0) and then moved to `device`. On a (data, points) mesh
    the seg net runs on the rank's points and the stages named in
    `points_replicated` on the whole frustum's object points, under
    `mesh.replicated_over_points` (their gradients are summed over the
    data group); `seg_logits` are the rank's, `mask` the whole
    frustum's."""

    points_replicated = ("tnet", "box_net")

    def __init__(self, cfg: bins_lib.BinConfig, *, dtype=torch.float32,
                 num_object_point: int = model_util.NUM_OBJECT_POINT,
                 dropout_rate: float = 0.5, in_channels: int = 4,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(dtype=dtype, device=device,
                  generator=_model_generator(generator))
        self.cfg = cfg
        self.num_object_point = num_object_point
        self.seg_net = InstanceSegNetV1(cfg.num_classes, in_channels,
                                        dropout_rate=dropout_rate, **kw)
        self.tnet = TNet(cfg.num_classes, **kw)
        self.box_net = BoxEstimationNetV1(cfg, **kw)

    def forward(self, points, one_hot, bn_momentum: float = 0.9,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """`generator` draws the seg net's dropout mask in train mode
        (required there, as flax requires a dropout rng)."""
        with profiling.span("t3d.seg_net"):
            seg_logits = self.seg_net(points, one_hot, bn_momentum,
                                      generator)
        with profiling.span("t3d.box_stages"):
            masked = model_util.point_cloud_masking(points, seg_logits,
                                                    self.num_object_point)
            # The box stages see only the whole frustum's object points.
            with mesh_lib.replicated_over_points():
                delta_c1 = self.tnet(masked.object_points, one_hot,
                                     bn_momentum)
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


class BoxEstimationOnly(nn.Module):
    """The box head alone on ground-truth-cropped points (no seg stage,
    no T-Net): the smallest end-to-end model. On a (data, points) mesh
    the box net's point MLP runs on the rank's points around the whole
    frustum's centroid and its head (`points_replicated`) under
    `mesh.replicated_over_points`; `seg_logits` and `mask` are the
    rank's."""

    points_replicated = ("box_net.head",)

    def __init__(self, cfg: bins_lib.BinConfig, *, dtype=torch.float32,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.box_net = BoxEstimationNetV1(
            cfg, dtype=dtype, device=device,
            generator=_model_generator(generator))

    def forward(self, points, one_hot, bn_momentum: float = 0.9,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """`generator` is unused (the model has no dropout); it is taken
        so that the train step calls every model alike."""
        xyz = points[..., :3]
        centroid = mesh_lib.points_mean(xyz)                  # [B, 3]
        box_out = self.box_net(xyz - centroid[:, None, :], one_hot,
                               bn_momentum)
        end_points = model_util.parse_box_output(box_out, self.cfg)
        b, n, _ = points.shape
        end_points["seg_logits"] = torch.zeros(b, n, 2, device=points.device)
        end_points["mask"] = torch.ones(b, n, device=points.device)
        end_points["mask_centroid"] = centroid
        end_points["stage1_center"] = centroid
        end_points["center"] = end_points["center_delta"] + centroid
        return end_points
