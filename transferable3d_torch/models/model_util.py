"""Model utilities: masking, box-output parsing and box decoding.

Port of `transferable3d_tpu/models/model_util.py:42-190`. The TPU
version selects the object points with a one-hot matrix contracted on
the MXU from bf16 hi/lo parts (exact to about 2^-17 relative); here the
same selection is a gather, which is exact. The loss and metrics are
not ported yet (ROADMAP queue A, item 3).
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple

import torch

from transferable3d_torch.core import bins as bins_lib

NUM_OBJECT_POINT = bins_lib.NUM_OBJECT_POINT


class MaskedPoints(NamedTuple):
    object_points: torch.Tensor  # [B, k, 3] centroid-centered
    mask_centroid: torch.Tensor  # [B, 3]
    mask: torch.Tensor           # [B, N] float 0/1


def point_cloud_masking(points: torch.Tensor, seg_logits: torch.Tensor,
                        num_object_point: int = NUM_OBJECT_POINT
                        ) -> MaskedPoints:
    """Hard mask from the seg argmax, masked xyz centroid, and exactly
    `num_object_point` masked points translated by -centroid: the first
    ones in index order, wrapping cyclically past the masked count; an
    empty mask takes point 0 (and centroid 0)."""
    xyz = points[..., :3]
    mask = (seg_logits[..., 1] > seg_logits[..., 0]).float()
    count = mask.sum(dim=1, keepdim=True)                      # [B, 1]
    centroid = ((xyz * mask[..., None]).sum(dim=1)
                / torch.clamp_min(count, 1.0))                 # [B, 3]
    k = num_object_point
    n = mask.shape[1]
    n_masked = count.to(torch.int32)
    rank = torch.cumsum(mask.to(torch.int32), dim=1, dtype=torch.int32)
    slot = torch.arange(k, dtype=torch.int32, device=points.device)
    want = torch.remainder(slot[None, :],
                           torch.clamp(n_masked, 1, min(k, n))) + 1
    # rank steps by one at each masked point: the first position whose
    # rank reaches `want` is the want-th masked point.
    idx = torch.searchsorted(rank.contiguous(), want.contiguous())
    idx = torch.where(n_masked == 0, 0, idx)
    obj = torch.gather(xyz, 1, idx[..., None].expand(-1, -1, 3))
    return MaskedPoints(object_points=obj - centroid[:, None, :],
                        mask_centroid=centroid, mask=mask)


def parse_box_output(output: torch.Tensor, cfg: bins_lib.BinConfig
                     ) -> Dict[str, torch.Tensor]:
    """Split the box head's [B, 3 + 2*NH + 4*NS] vector into named parts
    (heading residual = normalized * pi/NH, size residual = normalized *
    the class mean size)."""
    nh, ns = cfg.num_heading_bin, cfg.num_size_cluster
    size_res_norm = output[:, 3 + 2 * nh + ns:].reshape(-1, ns, 3)
    heading_res_norm = output[:, 3 + nh:3 + 2 * nh]
    mean_sizes = torch.as_tensor(cfg.mean_size_array(), device=output.device)
    return {
        "center_delta": output[:, 0:3],
        "heading_scores": output[:, 3:3 + nh],
        "heading_residuals_normalized": heading_res_norm,
        "heading_residuals": heading_res_norm * (math.pi / nh),
        "size_scores": output[:, 3 + 2 * nh:3 + 2 * nh + ns],
        "size_residuals_normalized": size_res_norm,
        "size_residuals": size_res_norm * mean_sizes[None],
    }


def decode_box(end_points: Dict, cfg: bins_lib.BinConfig, class_idx=None):
    """argmax-decode (center, size, heading, heading class, size class).

    With `class_idx` [B] the size cluster is the known class, as in the
    JAX `decode_box`; sizes are floored at 1 cm."""
    center = end_points["center"]
    rows = torch.arange(center.shape[0], device=center.device)
    hcls = torch.argmax(end_points["heading_scores"], dim=-1)
    hres = end_points["heading_residuals"][rows, hcls]
    heading = bins_lib.class_to_angle(hcls, hres, cfg.num_heading_bin)
    if class_idx is not None:
        scls = class_idx.long()
    else:
        scls = torch.argmax(end_points["size_scores"], dim=-1)
    sres = end_points["size_residuals"][rows, scls]
    size = torch.clamp_min(bins_lib.class_to_size(scls, sres, cfg), 0.01)
    return center, size, heading, hcls, scls
