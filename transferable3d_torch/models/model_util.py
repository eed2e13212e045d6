"""Model utilities: masking, box-output parsing, box decoding, the
multi-task loss and the in-step metrics.

Port of `transferable3d_tpu/models/model_util.py`. The TPU version
selects the object points with a one-hot matrix contracted on the MXU
from bf16 hi/lo parts (exact to about 2^-17 relative); here the same
selection is a gather, which is exact. The loss takes the corner loss at
the ground-truth (heading bin, size cluster) slot only, as the JAX
`get_loss` does; `get_box3d_corners_grid` gives the full grid.

Under data parallelism (`parallel/mesh.py`) every mean over the batch is
the sum over the rank's rows over the whole batch's count
(`mesh_lib.global_count`): each rank's loss and metrics are its share of
the whole batch's, and the shares add up to it. On a points mesh the
seg terms are shares over every rank (B x N split over both axes) and
the per-frustum terms over the data group (`replicated_over_points`);
the masking sees the whole frustum.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from transferable3d_torch.core import bins as bins_lib
from transferable3d_torch.core import geometry
from transferable3d_torch.parallel import mesh as mesh_lib

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
    empty mask takes point 0 (and centroid 0). On a points mesh the
    points group's xyz and masks are gathered first, so every rank of
    the group picks the 1-rank step's points and returns the whole
    frustum's mask."""
    xyz = mesh_lib.points_gather(points[..., :3])
    mask = mesh_lib.points_gather(
        (seg_logits[..., 1] > seg_logits[..., 0]).float())
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


def get_box3d_corners_grid(center: torch.Tensor, end_points: Dict,
                           cfg: bins_lib.BinConfig) -> torch.Tensor:
    """Corners for every (heading bin, size cluster): [B, NH, NS, 8, 3]."""
    nh, ns = cfg.num_heading_bin, cfg.num_size_cluster
    b = center.shape[0]
    bin_centers = (torch.arange(nh, dtype=torch.float32, device=center.device)
                   * (2 * math.pi / nh))
    headings = bin_centers[None, :] + end_points["heading_residuals"]
    mean_sizes = torch.as_tensor(cfg.mean_size_array(), device=center.device)
    sizes = mean_sizes[None] + end_points["size_residuals"]   # [B, NS, 3]
    return geometry.box_corners(
        center[:, None, None, :].expand(b, nh, ns, 3),
        sizes[:, None].expand(b, nh, ns, 3),
        headings[:, :, None].expand(b, nh, ns))


def huber_loss(error: torch.Tensor, delta: float) -> torch.Tensor:
    """Mean Huber loss."""
    abs_err = torch.abs(error)
    quad = torch.clamp_max(abs_err, delta)
    lin = abs_err - quad
    return mesh_lib.batch_mean(0.5 * quad ** 2 + delta * lin)


def int_cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                      ) -> torch.Tensor:
    """Mean softmax cross entropy with integer labels (float32)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    one_hot = F.one_hot(labels.long(), logits.shape[-1]).float()
    return mesh_lib.batch_mean(logz - torch.sum(logits * one_hot, dim=-1))


class Labels(NamedTuple):
    """Ground truth for the supervised loss (the provider's label keys)."""
    seg: torch.Tensor               # [B, N] int {0, 1}
    center: torch.Tensor            # [B, 3]
    heading_class: torch.Tensor     # [B] int
    heading_residual: torch.Tensor  # [B]
    size_class: torch.Tensor        # [B] int
    size_residual: torch.Tensor     # [B, 3]


def get_loss(end_points: Dict, labels: Labels, cfg: bins_lib.BinConfig,
             box_loss_weight: float = 1.0, corner_loss_weight: float = 10.0,
             seg_weight: float = 1.0,
             example_weights: Optional[torch.Tensor] = None
             ) -> Dict[str, torch.Tensor]:
    """Multi-task loss (model_util.py:232-348):

      total = seg_CE + w_box * (center_huber(d=2) + stage1_huber(d=1)
              + heading_CE + size_CE + 20*heading_res_huber(d=1)
              + 20*size_res_huber(d=1) + w_corner * corner_huber(d=1))

    The corner loss is the min over (GT heading, GT heading + pi) of the
    mean corner distance, at the GT (heading bin, size cluster) slot.
    `example_weights` [B] (optional) weights each example's terms.
    """
    nh, ns = cfg.num_heading_bin, cfg.num_size_cluster
    dev = labels.center.device
    b = labels.center.shape[0]
    w = (torch.ones(b, dtype=torch.float32, device=dev)
         if example_weights is None else example_weights.float())
    # The whole batch's weight: summed over the ranks under data
    # parallelism (a frustum's weight once: over the data group of a
    # points mesh), so each rank's terms are its share of the global mean.
    with mesh_lib.replicated_over_points():
        denom = torch.clamp_min(mesh_lib.global_count(torch.sum(w)), 1e-6)

    def wmean(per_example):
        return torch.sum(per_example * w) / denom

    def whuber(err, delta):
        a = torch.abs(err)
        q = torch.clamp_max(a, delta)
        per = 0.5 * q ** 2 + delta * (a - q)
        if per.dim() > 1:
            per = torch.mean(per.reshape(per.shape[0], -1), dim=1)
        return wmean(per)

    def wce(logits, lab):
        logits = logits.float()
        logz = torch.logsumexp(logits, dim=-1)
        picked = torch.sum(
            logits * F.one_hot(lab.long(), logits.shape[-1]).float(), dim=-1)
        per = logz - picked
        if per.dim() > 1:  # the seg terms: a mean over the frustum's points
            per = mesh_lib.mean_over_points(per)
        return wmean(per)

    def dist_huber(pred, gt, delta):
        d = torch.sqrt(torch.sum((pred - gt) ** 2, dim=-1) + 1e-12)
        return whuber(d, delta)

    seg_loss = wce(end_points["seg_logits"], labels.seg)
    center_loss = dist_huber(end_points["center"], labels.center, 2.0)
    stage1_loss = dist_huber(end_points["stage1_center"], labels.center, 1.0)

    heading_cls_loss = wce(end_points["heading_scores"],
                           labels.heading_class)
    h_onehot = F.one_hot(labels.heading_class.long(), nh).float()
    hres_pred = torch.sum(
        end_points["heading_residuals_normalized"] * h_onehot, dim=1)
    hres_gt = labels.heading_residual / (math.pi / nh)
    heading_res_loss = whuber(hres_pred - hres_gt, 1.0)

    size_cls_loss = wce(end_points["size_scores"], labels.size_class)
    s_onehot = F.one_hot(labels.size_class.long(), ns).float()  # [B, NS]
    sres_pred = torch.sum(
        end_points["size_residuals_normalized"] * s_onehot[..., None], dim=1)
    mean_sizes = torch.as_tensor(cfg.mean_size_array(), device=dev)
    gt_means = mean_sizes[labels.size_class.long()]
    size_res_loss = whuber(sres_pred - labels.size_residual / gt_means, 1.0)

    bin_centers = (torch.arange(nh, dtype=torch.float32, device=dev)
                   * (2 * math.pi / nh))
    pred_heading_at_gt = (
        torch.sum(bin_centers[None] * h_onehot, dim=1)
        + torch.sum(end_points["heading_residuals"] * h_onehot, dim=1))
    pred_size_at_gt = gt_means + torch.sum(
        end_points["size_residuals"] * s_onehot[..., None], dim=1)
    pred_corners = geometry.box_corners(
        end_points["center"], pred_size_at_gt, pred_heading_at_gt)
    gt_heading = bins_lib.class_to_angle(
        labels.heading_class, labels.heading_residual, nh)
    gt_size = bins_lib.class_to_size(labels.size_class.long(),
                                     labels.size_residual, cfg)
    gt_corners = geometry.box_corners(labels.center, gt_size, gt_heading)
    gt_corners_flip = geometry.box_corners(labels.center, gt_size,
                                           gt_heading + math.pi)
    d = torch.sqrt(torch.sum((pred_corners - gt_corners) ** 2, dim=-1)
                   + 1e-12)
    d_flip = torch.sqrt(
        torch.sum((pred_corners - gt_corners_flip) ** 2, dim=-1) + 1e-12)
    corner_dist = torch.minimum(d.mean(dim=1), d_flip.mean(dim=1))
    corner_loss = whuber(corner_dist, 1.0)

    terms = {
        "seg_loss": seg_loss,
        "center_loss": center_loss,
        "stage1_center_loss": stage1_loss,
        "heading_class_loss": heading_cls_loss,
        "heading_residual_loss": heading_res_loss,
        "size_class_loss": size_cls_loss,
        "size_residual_loss": size_res_loss,
        "corner_loss": corner_loss,
    }
    return {"total_loss": total_loss(terms, box_loss_weight,
                                     corner_loss_weight, seg_weight),
            **terms}


def total_loss(terms: Dict[str, torch.Tensor], box_loss_weight: float = 1.0,
               corner_loss_weight: float = 10.0, seg_weight: float = 1.0
               ) -> torch.Tensor:
    """`get_loss`'s total from its terms."""
    box_loss = (terms["center_loss"] + terms["stage1_center_loss"]
                + terms["heading_class_loss"] + terms["size_class_loss"]
                + 20.0 * terms["heading_residual_loss"]
                + 20.0 * terms["size_residual_loss"]
                + corner_loss_weight * terms["corner_loss"])
    return seg_weight * terms["seg_loss"] + box_loss_weight * box_loss


def compute_metrics(end_points: Dict, labels: Labels,
                    cfg: bins_lib.BinConfig,
                    class_idx: Optional[torch.Tensor] = None
                    ) -> Dict[str, torch.Tensor]:
    """Seg accuracy and box IoU ratios (model_util.py:355-385); with
    `class_idx` the size cluster is the known class, as in the
    inference decode."""
    seg_pred = torch.argmax(end_points["seg_logits"], dim=-1)
    seg_acc = mesh_lib.batch_mean((seg_pred == labels.seg).float())
    center, size, heading, _, _ = decode_box(end_points, cfg,
                                             class_idx=class_idx)
    gt_heading = bins_lib.class_to_angle(
        labels.heading_class, labels.heading_residual, cfg.num_heading_bin)
    gt_size = bins_lib.class_to_size(labels.size_class.long(),
                                     labels.size_residual, cfg)
    iou3d, ioubev = geometry.box3d_iou(center, size, heading,
                                       labels.center, gt_size, gt_heading)
    with mesh_lib.replicated_over_points():  # means over the frustums
        return {
            "seg_accuracy": seg_acc,
            "iou3d_mean": mesh_lib.batch_mean(iou3d),
            "ioubev_mean": mesh_lib.batch_mean(ioubev),
            "iou3d_ge_025": mesh_lib.batch_mean((iou3d >= 0.25).float()),
            "iou3d_ge_05": mesh_lib.batch_mean((iou3d >= 0.5).float()),
            "iou3d_ge_07": mesh_lib.batch_mean((iou3d >= 0.7).float()),
        }
