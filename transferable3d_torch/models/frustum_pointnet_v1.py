"""F-PointNet v1 pieces shared with v2.

Port of `TNet` (`transferable3d_tpu/models/frustum_pointnet_v1.py:82-95`),
the center-regression network both model versions use. The rest of v1
(its seg net, box net and full model) is not ported yet (ROADMAP queue
A, item 4).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from transferable3d_torch.models.layers import MLPHead, PointMLP


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
