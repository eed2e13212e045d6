"""Train, eval and predict steps, the optimizer and the train state.

Port of `transferable3d_tpu/train/train_loop.py`. The JAX step is one
jitted function of an immutable state; here the state is a mutable
`TrainState` holding the step counter, the model (parameters and BN
running statistics), the optimizer and the dropout generator, and the
steps run eagerly:

  * `make_train_step`: BN momentum from the schedule at `state.step`,
    forward in train mode (batch statistics, running statistics updated
    in place, seg-head dropout drawn from `state.generator`),
    `get_loss`, backward, one optimizer call, then the in-step box-IoU
    metrics;
  * `make_eval_step`: losses and metrics with the running statistics;
  * `make_predict_step`: decoded boxes and scores (train_loop.py:155-187).

`make_optimizer` is optax `adam(lr_schedule, eps=1e-8)`, optionally
behind `clip_by_global_norm` and `MultiSteps` (train_loop.py:240-258),
on `torch.optim.Adam`. `_flatten_lane_safe` is a TPU layout workaround
and has no counterpart.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Tuple

import torch

from transferable3d_torch.core import bins as bins_lib
from transferable3d_torch.models import model_util


@dataclasses.dataclass(frozen=True)
class StepConfig:
    """Static options of the train and eval steps."""
    box_loss_weight: float = 1.0
    corner_loss_weight: float = 10.0
    compute_iou_metrics: bool = True
    # Weight examples by batch["valid"] (padded frustums get weight 0).
    use_valid_weights: bool = False


class Optimizer:
    """optax `adam(lr_schedule, eps=1e-8)`, optionally after
    `clip_by_global_norm(clip_norm)` and inside
    `MultiSteps(every_k_schedule=grad_accum_steps)`, over `params`.

    `step()` reads each parameter's `.grad` (None counts as zero). With
    accumulation it keeps the running mean of the microbatch gradients
    (optax's `acc + (g - acc) / (n + 1)`) and updates the parameters on
    every k-th call only. The LR is `lr_schedule(count)` with `count` the
    number of real updates made before this one, as optax's schedule
    counter; clipping scales by max_norm / norm only when
    norm >= max_norm, as optax does.
    """

    def __init__(self, params, lr_schedule: Callable[[int], float],
                 clip_norm: Optional[float] = None,
                 grad_accum_steps: int = 1):
        self.params: List[torch.nn.Parameter] = list(params)
        self.lr_schedule = lr_schedule
        self.clip_norm = clip_norm
        self.k = grad_accum_steps
        self.count = 0       # real updates so far
        self.mini_step = 0   # microbatches accumulated towards the next
        self.acc: Optional[List[torch.Tensor]] = None
        self.adam = torch.optim.Adam(self.params, lr=lr_schedule(0),
                                     betas=(0.9, 0.999), eps=1e-8)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def _grads(self) -> List[torch.Tensor]:
        return [torch.zeros_like(p) if p.grad is None else p.grad
                for p in self.params]

    @torch.no_grad()
    def step(self) -> bool:
        """Apply (or accumulate) the current gradients; True when the
        parameters were updated."""
        grads = self._grads()
        if self.k > 1:
            if self.acc is None:
                self.acc = [torch.zeros_like(p) for p in self.params]
            n = self.mini_step
            for a, g in zip(self.acc, grads):
                a.add_((g - a) / (n + 1))
            self.mini_step = (n + 1) % self.k
            if self.mini_step:
                return False
            grads = [a.clone() for a in self.acc]
            for a in self.acc:
                a.zero_()
        if self.clip_norm:
            norm = torch.sqrt(sum(torch.sum(g.float() * g.float())
                                  for g in grads))
            if float(norm) >= self.clip_norm:
                grads = [g / norm * self.clip_norm for g in grads]
        for p, g in zip(self.params, grads):
            p.grad = g
        for group in self.adam.param_groups:
            group["lr"] = self.lr_schedule(self.count)
        self.adam.step()
        self.count += 1
        return True


def make_optimizer(lr_schedule: Callable[[int], float],
                   clip_norm: Optional[float] = None,
                   grad_accum_steps: int = 1
                   ) -> Callable[..., Optimizer]:
    """Adam with the reference's defaults (TF1 AdamOptimizer eps 1e-8);
    `grad_accum_steps > 1` updates every k-th microbatch. Returns what
    optax's `init` is to its transformation: a function of the
    parameters that builds the `Optimizer` over them."""
    return functools.partial(Optimizer, lr_schedule=lr_schedule,
                             clip_norm=clip_norm,
                             grad_accum_steps=grad_accum_steps)


@dataclasses.dataclass
class TrainState:
    step: int
    model: torch.nn.Module
    optimizer: Optimizer
    generator: torch.Generator  # draws the dropout masks


def create_train_state(model: torch.nn.Module,
                       tx: Callable[..., Optimizer],
                       seed: int = 0,
                       generator: Optional[torch.Generator] = None
                       ) -> TrainState:
    """State at step 0 around an initialised model. The dropout
    generator defaults to one on the model's device seeded with `seed`;
    pass a CPU generator to draw the same masks on any device."""
    if generator is None:
        device = next(model.parameters()).device
        generator = torch.Generator(device=device).manual_seed(seed)
    return TrainState(step=0, model=model,
                      optimizer=tx(model.parameters()),
                      generator=generator)


_FLOAT_KEYS = ("points", "one_hot", "center", "heading_residual",
               "size_residual", "valid")
_INT_KEYS = ("seg", "heading_class", "size_class", "class_idx")


def batch_to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """The model and label entries of a provider batch (numpy arrays or
    tensors) as tensors on `device`: float32, and int64 for classes."""
    out = {}
    for keys, dt in ((_FLOAT_KEYS, torch.float32), (_INT_KEYS, torch.long)):
        for k in keys:
            if k in batch:
                out[k] = torch.as_tensor(batch[k]).to(device=device,
                                                      dtype=dt)
    return out


def labels_from_batch(batch: Dict[str, torch.Tensor]) -> model_util.Labels:
    return model_util.Labels(
        seg=batch["seg"], center=batch["center"],
        heading_class=batch["heading_class"],
        heading_residual=batch["heading_residual"],
        size_class=batch["size_class"],
        size_residual=batch["size_residual"])


def _losses(cfg, step_cfg: StepConfig, batch, end_points,
            with_weights: bool):
    weights = (batch["valid"] if with_weights and step_cfg.use_valid_weights
               else None)
    return model_util.get_loss(
        end_points, labels_from_batch(batch), cfg,
        box_loss_weight=step_cfg.box_loss_weight,
        corner_loss_weight=step_cfg.corner_loss_weight,
        example_weights=weights)


def make_train_step(cfg: bins_lib.BinConfig,
                    lr_schedule: Callable[[int], float],
                    bn_schedule: Callable[[int], float],
                    step_cfg: StepConfig = StepConfig()
                    ) -> Callable[[TrainState, Dict],
                                  Tuple[TrainState, Dict]]:
    """One supervised step on `state.model` with `state.optimizer`.

    Returns (state, metrics): the state is updated in place (parameters,
    running statistics, optimizer, step + 1) and the metrics are the
    loss terms, `lr` and `bn_momentum` at the step, and the box-IoU
    metrics when `step_cfg.compute_iou_metrics`, as detached tensors.
    """

    def step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        model = state.model
        device = next(model.parameters()).device
        batch = batch_to_device(batch, device)
        bn_momentum = bn_schedule(state.step)
        model.train()
        state.optimizer.zero_grad()
        end_points = model(batch["points"], batch["one_hot"],
                           bn_momentum=bn_momentum,
                           generator=state.generator)
        losses = _losses(cfg, step_cfg, batch, end_points, True)
        losses["total_loss"].backward()
        state.optimizer.step()
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["lr"] = lr_schedule(state.step)
        metrics["bn_momentum"] = bn_momentum
        if step_cfg.compute_iou_metrics:
            with torch.no_grad():
                metrics.update(model_util.compute_metrics(
                    {k: v.detach() for k, v in end_points.items()},
                    labels_from_batch(batch), cfg,
                    class_idx=batch.get("class_idx")))
        state.step += 1
        return state, metrics

    return step


def make_eval_step(cfg: bins_lib.BinConfig,
                   step_cfg: StepConfig = StepConfig()
                   ) -> Callable[[TrainState, Dict], Dict]:
    """Losses and metrics of `state.model` with the running BN
    statistics; no update."""

    def step(state: TrainState, batch: Dict) -> Dict[str, torch.Tensor]:
        model = state.model
        batch = batch_to_device(batch, next(model.parameters()).device)
        model.eval()
        with torch.no_grad():
            end_points = model(batch["points"], batch["one_hot"])
            metrics = _losses(cfg, step_cfg, batch, end_points, False)
            if step_cfg.compute_iou_metrics:
                metrics.update(model_util.compute_metrics(
                    end_points, labels_from_batch(batch), cfg,
                    class_idx=batch.get("class_idx")))
        return metrics

    return step


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
