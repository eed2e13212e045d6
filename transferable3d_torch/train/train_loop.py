"""Inference step (port of `make_predict_step`, train_loop.py:155-187).

The train and eval steps, the optimizer and the schedules are not
ported yet (ROADMAP queue A, item 5).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from transferable3d_torch.core import bins as bins_lib
from transferable3d_torch.models import model_util


def make_predict_step(model: torch.nn.Module, cfg: bins_lib.BinConfig
                      ) -> Callable[[Dict], Dict[str, torch.Tensor]]:
    """Inference step -> decoded boxes + scores, per example: center /
    size / heading (frustum frame), heading and size classes, the seg
    confidence over the predicted mask, the heading and size class
    probabilities, and the mask count.

    The step takes a batch dict with `points` [B, N, C], `one_hot`
    [B, K] and optionally `class_idx` [B] (numpy arrays or tensors) and
    runs the model in eval mode without autograd on the model's device.
    """
    device = next(model.parameters()).device

    def step(batch: Dict) -> Dict[str, torch.Tensor]:
        model.eval()
        with torch.inference_mode():
            points = torch.as_tensor(batch["points"], dtype=torch.float32,
                                     device=device)
            one_hot = torch.as_tensor(batch["one_hot"], dtype=torch.float32,
                                      device=device)
            class_idx = batch.get("class_idx")
            if class_idx is not None:
                class_idx = torch.as_tensor(class_idx, device=device)
            end_points = model(points, one_hot)
            center, size, heading, hcls, scls = model_util.decode_box(
                end_points, cfg, class_idx=class_idx)
            seg_prob = torch.softmax(end_points["seg_logits"], dim=-1)[..., 1]
            mask = end_points["mask"]
            heading_prob = torch.softmax(
                end_points["heading_scores"], dim=-1).amax(dim=-1)
            size_prob = torch.softmax(
                end_points["size_scores"], dim=-1).amax(dim=-1)
            seg_conf = ((seg_prob * mask).sum(dim=1)
                        / torch.clamp_min(mask.sum(dim=1), 1.0))
            return {
                "center": center, "size": size, "heading": heading,
                "heading_class": hcls, "size_class": scls,
                "seg_conf": seg_conf, "heading_prob": heading_prob,
                "size_prob": size_prob, "mask_count": mask.sum(dim=1),
            }

    return step
