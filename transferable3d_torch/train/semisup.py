"""Semi-supervised transfer training: BoxPC pretraining + weak-class losses.

Port of `transferable3d_tpu/train/semisup.py`, the Transferable3D
mechanism:

  phase A: pretrain the BoxPC fit net on strong classes with perturbed
           GT boxes (`models/boxpc.py`), `make_boxpc_train_step`;
  phase B: train the detector with
             strong batches -> the full supervised loss, and
             weak batches (2D box + class only) ->
               * BoxPC fit-score maximization on the predicted box,
               * the BoxPC-refined box as a pseudo-label (no gradient),
               * 2D reprojection consistency (calib-exact where the batch
                 carries a camera matrix, the frustum's angular span
                 otherwise),
               * the per-class mean-size prior,
           `make_semisup_train_step`.

BoxPC is frozen in phase B, as JAX's `stop_gradient(boxpc_variables)`:
eval mode (running BN statistics, no dropout), `requires_grad_(False)`,
outside the optimizer, so its parameters and statistics stay
bit-identical while gradients still reach the predicted box through it.

The JAX steps are one jitted function of an immutable state; here they
run eagerly on a mutable `TrainState` (`train/train_loop.py`). Draws come
from the state's `torch.Generator`; where JAX splits a key, the port
takes the draws in the key order (see `make_boxpc_train_step`), and
each draw is split from a pure function of it, so the tests feed JAX's
own draws.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from transferable3d_torch.core import bins as bins_lib
from transferable3d_torch.core import geometry
from transferable3d_torch.models import boxpc as boxpc_lib
from transferable3d_torch.models import model_util
from transferable3d_torch.parallel import mesh as mesh_lib
from transferable3d_torch.train import train_loop


# ---------------------------------------------------------------------------
# Phase A: BoxPC pretraining
# ---------------------------------------------------------------------------

def gt_boxes_from_batch(batch: Dict[str, torch.Tensor],
                        cfg: bins_lib.BinConfig) -> boxpc_lib.BoxParams:
    heading = bins_lib.class_to_angle(
        batch["heading_class"], batch["heading_residual"],
        cfg.num_heading_bin)
    size = bins_lib.class_to_size(
        batch["size_class"], batch["size_residual"], cfg)
    return boxpc_lib.BoxParams(center=batch["center"], size=size,
                               heading=heading)


def create_boxpc_state(model: torch.nn.Module,
                       tx: Callable[..., train_loop.Optimizer],
                       seed: int = 0,
                       generator: Optional[torch.Generator] = None
                       ) -> train_loop.TrainState:
    """Phase A's state at step 0 around a BoxPC (`create_train_state`:
    its generator draws the perturbations, the dropout masks and the
    shape augmentation)."""
    return train_loop.create_train_state(model, tx, seed=seed,
                                         generator=generator)


def shape_aug_draws(generator: torch.Generator, b: int,
                    log_range: float = 0.8
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The random numbers of one anisotropic shape aug (JAX's
    `anisotropic_shape_aug`), in JAX's key order: `s_log` [b, 3] uniform in [-log_range, log_range) and `u_on`
    [b] uniform in [0, 1)."""
    dev = generator.device
    s_log = ((torch.rand((b, 3), generator=generator, device=dev) * 2.0
              - 1.0) * log_range)
    u_on = torch.rand((b,), generator=generator, device=dev)
    return s_log, u_on


def shape_aug_from_draws(points: torch.Tensor, gt: boxpc_lib.BoxParams,
                         s_log: torch.Tensor, u_on: torch.Tensor,
                         frac: float = 0.5
                         ) -> Tuple[torch.Tensor, boxpc_lib.BoxParams]:
    """Jointly rescale the cloud and the GT box per dimension in the box
    frame (JAX's `anisotropic_shape_aug` after its draws).

    A fraction `frac` of the batch (`u_on < frac`) takes the per-dim
    scales exp(s_log); the rest keeps scale 1. Canonicalized coordinates
    are invariant, so only the scale-context channels carry the new
    shapes: phase A then sees thin clouds with well-fitting boxes, which
    the strong classes alone never show (the JAX docstring has the
    bookshelf forensics behind it).
    """
    dev = points.device
    s = torch.exp(s_log.to(dev))
    on = (u_on.to(dev) < frac)[:, None]
    s = torch.where(on, s, torch.ones_like(s))
    xyz = points[..., :3]
    rel = geometry.rotate_points_y(xyz - gt.center[:, None, :],
                                   -gt.heading)
    # box frame: x spans l = size[0], y spans h = size[2],
    # z spans w = size[1] (see boxpc.canonicalize_points).
    rel = rel * torch.stack([s[:, 0], s[:, 2], s[:, 1]], dim=-1)[:, None, :]
    xyz = geometry.rotate_points_y(rel, gt.heading) + gt.center[:, None, :]
    points = torch.cat([xyz, points[..., 3:]], dim=-1)
    return points, boxpc_lib.BoxParams(center=gt.center, size=gt.size * s,
                                       heading=gt.heading)


def fork_generator(generator: torch.Generator) -> torch.Generator:
    """A new generator on the same device, seeded from one draw of
    `generator` (the counterpart of one `jax.random.split` branch)."""
    seed = torch.randint(0, 2 ** 62, (1,), generator=generator,
                         device=generator.device)
    return torch.Generator(device=generator.device).manual_seed(
        int(seed.item()))


def make_boxpc_train_step(cfg: bins_lib.BinConfig, bn_schedule: Callable,
                          fit_iou_thresh: float = 0.5,
                          aniso_aug: float = 0.8):
    """One BoxPC step on `state.model`: the anisotropic shape aug (when
    `aniso_aug` > 0, its log range), the perturbation, the IoU-labelled
    targets, the forward in train mode with dropout, `boxpc_loss`,
    backward and one optimizer call. Returns (state, losses), the state
    updated in place.

    JAX splits the step's key into (sample, dropout, aug); the port draws
    from `state.generator` in that order: the perturbation's numbers,
    then the seed of the dropout masks' own generator, then the aug's.
    Under a mesh (`train_loop.make_train_step`'s data parallelism) every
    rank draws the whole batch's numbers and keeps its own rows. On a
    (data, points) mesh the batch's points are the rank's slice: the aug
    scales each point by its frustum's draws, and the loss, its means
    over the data group, runs under `mesh.replicated_over_points` with
    BoxPC's head.
    """

    def step(state: train_loop.TrainState, batch: Dict
             ) -> Tuple[train_loop.TrainState, Dict]:
        model = state.model
        device = next(model.parameters()).device
        batch = train_loop.batch_to_device(batch, device)
        gt = gt_boxes_from_batch(batch, cfg)
        # The whole batch's rows: D times the rank's on a (D, P) mesh.
        b = mesh_lib.whole_shape(gt.center.shape, per_point=False)[0]
        sample = mesh_lib.local_rows(
            boxpc_lib.perturbation_draws(state.generator, b))
        dropout_gen = fork_generator(state.generator)
        points = batch["points"]
        if aniso_aug > 0:
            points, gt = shape_aug_from_draws(
                points, gt, *mesh_lib.local_rows(
                    shape_aug_draws(state.generator, b, aniso_aug)))
        perturbed = boxpc_lib.perturbed_from_draws(gt, *sample)
        targets = boxpc_lib.boxpc_targets(perturbed, gt, fit_iou_thresh)
        bn_momentum = bn_schedule(state.step)
        model.train()
        state.optimizer.zero_grad()
        out = model(points, perturbed, bn_momentum=bn_momentum,
                    generator=dropout_gen)
        with mesh_lib.replicated_over_points():
            losses = boxpc_lib.boxpc_loss(out, targets)
        losses["total_loss"].backward()
        mesh_lib.all_reduce_grads(
            state.optimizer.params,
            replicated=train_loop.points_replicated_params(model))
        state.optimizer.step()
        state.step += 1
        with mesh_lib.replicated_over_points():
            return state, mesh_lib.reduce_metrics(
                {k: v.detach() for k, v in losses.items()})

    return step


# ---------------------------------------------------------------------------
# Phase B: weak-class losses
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class WeakLossWeights:
    """Weights of the weak losses and the BoxPC trust gate (the JAX
    dataclass's defaults and the reasons for each are documented there).
    `size_cls` defaults off; the gate zeroes the BoxPC-derived losses
    (fit, refine) per example whenever BoxPC's own delta leaves the
    perturbation sampler's support or the predicted size leaves a log
    window around the class prior."""
    fit: float = 1.0
    refine: float = 1.0
    reprojection: float = 1.0
    size_prior: float = 0.5
    size_cls: float = 0.0
    trust_gate: bool = True
    trust_center: float = 0.7   # |delta_center| / max(size)
    trust_size: float = 0.7     # max |log-size delta|
    trust_heading: float = 1.0  # |heading delta| (rad)
    trust_prior_logsize: float = 1.0  # max |log(size / class prior)|


def differentiable_box(end_points: Dict, cfg: bins_lib.BinConfig,
                       class_idx: Optional[torch.Tensor] = None
                       ) -> boxpc_lib.BoxParams:
    """Predicted box with gradients through the center and residuals.

    Bin selection is an argmax (first index on ties) without gradient:
    the scores are trained by the strong-class CE, the weak losses shape
    the residuals and the center. With `class_idx`, the size cluster is
    the known class instead of the score argmax (cluster == class in this
    lineage), which routes the weak gradients into the residual slot the
    eval decode reads.
    """
    nh = cfg.num_heading_bin
    hcls = end_points["heading_scores"].argmax(dim=-1).detach()
    hres = torch.gather(end_points["heading_residuals"], 1,
                        hcls[:, None])[:, 0]
    heading = hcls.to(torch.float32) * (2 * math.pi / nh) + hres
    if class_idx is not None:
        scls = class_idx.to(torch.int64)
    else:
        scls = end_points["size_scores"].argmax(dim=-1).detach()
    sres = end_points["size_residuals"][
        torch.arange(scls.shape[0], device=scls.device), scls]
    mean_sizes = torch.as_tensor(cfg.mean_size_array(),
                                 device=sres.device)
    raw = mean_sizes[scls] + sres
    # Straight-through floor: the forward value is clipped (corner / IoU
    # math needs positive extents) but the gradient sees the raw size; a
    # hard clamp has zero gradient below the floor, a one-way trap.
    size = raw + (torch.clamp_min(raw, 0.01) - raw).detach()
    return boxpc_lib.BoxParams(center=end_points["center"], size=size,
                               heading=heading)


def angular_span_residual(corners: torch.Tensor, points: torch.Tensor
                          ) -> torch.Tensor:
    """Per-example 2D-reprojection surrogate in frustum coordinates.

    corners [B, 8, 3] of the predicted box; points [B, N, C] the frustum
    cloud (on a points mesh, under the sharded scope, the rank's slice:
    its bounds are taken across the points group). Matches the (x/z,
    y/z) angular bounds; returns the mean absolute span error [B].
    """
    def spans(xyz, amin, amax):
        z = torch.clamp_min(xyz[..., 2], 0.5)  # frustums look down +Z
        az = xyz[..., 0] / z
        el = xyz[..., 1] / z
        return (amin(az, 1), amax(az, 1), amin(el, 1), amax(el, 1))

    ca = spans(corners, torch.amin, torch.amax)
    pa = spans(points[..., :3], mesh_lib.points_min, mesh_lib.points_max)
    return sum((c - p).abs() for c, p in zip(ca, pa)) / 4.0


def calib_reprojection_residual(corners: torch.Tensor,
                                frustum_angle: torch.Tensor,
                                calib_p: torch.Tensor,
                                box2d: torch.Tensor) -> torch.Tensor:
    """Calib-exact 2D reprojection error: the 8 corners projected with
    the camera matrix against the given 2D box.

    corners [B, 8, 3] in the FRUSTUM frame; frustum_angle [B] undoes the
    rotate-to-center normalization; calib_p [B, 3, 4] is the rect->image
    projection; box2d [B, 4] = (xmin, ymin, xmax, ymax). Returns the mean
    absolute bound error [B], normalized by the 2D box size.
    """
    rect = geometry.rotate_points_y(corners, -frustum_angle)  # [B, 8, 3]
    hom = torch.cat([rect, torch.ones_like(rect[..., :1])], dim=-1)
    uvw = torch.einsum("bnc,bdc->bnd", hom, calib_p)  # [B, 8, 3]
    w = torch.clamp_min(uvw[..., 2], 0.1)  # guard degenerate depths
    u, v = uvw[..., 0] / w, uvw[..., 1] / w
    pred = torch.stack([u.amin(dim=1), v.amin(dim=1), u.amax(dim=1),
                        v.amax(dim=1)], dim=-1)
    wh = torch.clamp_min(box2d[:, 2:4] - box2d[:, 0:2], 1.0)  # [B, 2]
    norm = torch.cat([wh, wh], dim=-1)
    return torch.mean((pred - box2d).abs() / norm, dim=-1)


def trust_gate_components(out: Dict, box: boxpc_lib.BoxParams,
                          prior: Optional[torch.Tensor] = None) -> Dict:
    """Per-example [B] magnitudes the trust gate thresholds on (also the
    per-class diagnostics' inputs)."""
    scale = torch.clamp_min(box.size.amax(dim=-1), 0.1)
    comp = {
        "dc_mag": torch.linalg.norm(out["delta_center"], dim=-1) / scale,
        "ds_mag": out["delta_size"].abs().amax(dim=-1),
        "dh_mag": out["delta_heading"].abs(),
    }
    if prior is not None:
        comp["prior_dev"] = torch.log(
            torch.clamp_min(box.size, 1e-3) / prior).abs().amax(dim=-1)
    return comp


def boxpc_trust_gate(out: Dict, box: boxpc_lib.BoxParams,
                     weights: WeakLossWeights,
                     prior: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-example gate [B] (1.0 or 0.0, no gradient) on the
    BoxPC-derived losses: 1 iff BoxPC's predicted delta stays inside the
    perturbation sampler's support and, with the per-class mean size
    `prior` [B, 3], the predicted size stays inside the log window
    around it. The consumer multiplies per-example losses by the gate
    under a mean over the whole batch."""
    if not weights.trust_gate:
        return torch.ones_like(out["fit_logit"]).detach()
    comp = trust_gate_components(out, box, prior)
    ok = ((comp["dc_mag"] <= weights.trust_center)
          & (comp["ds_mag"] <= weights.trust_size)
          & (comp["dh_mag"] <= weights.trust_heading))
    if prior is not None:
        ok = ok & (comp["prior_dev"] <= weights.trust_prior_logsize)
    return ok.to(torch.float32).detach()


def _huber(x: torch.Tensor, d: float = 1.0) -> torch.Tensor:
    a = x.abs()
    q = torch.clamp_max(a, d)
    return 0.5 * q ** 2 + d * (a - q)


def _huber_ex(x: torch.Tensor, d: float = 1.0) -> torch.Tensor:
    """Per-example huber: mean over trailing dims, keep the batch."""
    h = _huber(x, d)
    return h if h.dim() == 1 else h.mean(dim=-1)


def freeze(boxpc_model: torch.nn.Module) -> torch.nn.Module:
    """BoxPC as phase B uses it: eval mode, and no parameter takes or
    holds a gradient (JAX's `stop_gradient` on its variables; phase A's
    last gradients are dropped); returns the module."""
    boxpc_model.eval()
    for p in boxpc_model.parameters():
        p.requires_grad_(False)
        p.grad = None
    return boxpc_model


def weak_losses(end_points: Dict, batch: Dict[str, torch.Tensor],
                boxpc_model: torch.nn.Module, cfg: bins_lib.BinConfig,
                weights: WeakLossWeights = WeakLossWeights(),
                diag_classes: int = 0) -> Dict[str, torch.Tensor]:
    """Transferable supervision for weak (2D-only) examples, with BoxPC
    frozen (`freeze`).

    `diag_classes > 0` adds per-class `[diag_classes]` vectors (mean over
    each class's batch members) of the gate pass rate, the gated
    fit/refine losses and every gate-component magnitude.

    On a (data, points) mesh `batch["points"]` is the rank's slice and
    the detector's outputs are every rank's whole: BoxPC reads the slice
    with the whole box (its features' cotangent of the box summed over
    the points group), the angular spans are the whole frustum's, and
    the losses, per frustum, run under `mesh.replicated_over_points`."""
    box = differentiable_box(end_points, cfg,
                             class_idx=batch.get("class_idx"))
    out = freeze(boxpc_model)(batch["points"], box)
    corners = geometry.box_corners(box.center, box.size, box.heading)
    span_res = angular_span_residual(corners, batch["points"])
    # The losses are per frustum: every rank of a points group holds
    # them whole, and their means run over the data group.
    with mesh_lib.replicated_over_points():
        mean_sizes = torch.as_tensor(cfg.mean_size_array(),
                                     device=box.size.device)
        prior = mean_sizes[batch["class_idx"]]  # [B, 3]
        gate = boxpc_trust_gate(out, box, weights, prior=prior)

        # (a) maximize BoxPC's fit probability of the predicted box.
        logit = out["fit_logit"]
        fit_ex = gate * F.softplus(-logit)  # -log sigmoid, [B]
        fit_loss = mesh_lib.batch_mean(fit_ex)

        # (b) the BoxPC-refined box as a pseudo-label; the size term is
        # prior-normalized linear huber (bounded gradient as the box shrinks).
        with torch.no_grad():
            refined = boxpc_lib.apply_deltas(box, out)
        refine_ex = gate * (
            _huber_ex(box.center - refined.center)
            + _huber_ex(box.heading - refined.heading)
            + _huber_ex((box.size - refined.size) / prior))
        refine_loss = mesh_lib.batch_mean(refine_ex)

        # (c) 2D reprojection consistency: calib-exact corner projection for
        # examples that carry a camera matrix (has_calib == 1), the
        # angular-span surrogate otherwise, and everywhere when the batch has
        # no `calib_p` (device-drawn batches).
        if "calib_p" in batch:
            calib_res = calib_reprojection_residual(
                corners, batch["frustum_angle"], batch["calib_p"],
                batch["box2d"])
            err = torch.where(batch["has_calib"] > 0, calib_res, span_res)
        else:
            err = span_res
        reproj_loss = mesh_lib.batch_mean(_huber(err))

        # (d) the per-class mean-size prior (normalized).
        size_prior_loss = mesh_lib.batch_mean(
            _huber((box.size - prior) / prior))

        # (e) size-class CE from the known 2D class label.
        logp = torch.log_softmax(end_points["size_scores"], dim=-1)
        size_cls_loss = -mesh_lib.batch_mean(
            torch.gather(logp, 1, batch["class_idx"][:, None])[:, 0])

        total = (weights.fit * fit_loss + weights.refine * refine_loss
                 + weights.reprojection * reproj_loss
                 + weights.size_prior * size_prior_loss
                 + weights.size_cls * size_cls_loss)
        losses = {
            "weak_total_loss": total,
            "weak_size_cls_loss": size_cls_loss,
            "weak_fit_loss": fit_loss,
            "weak_refine_loss": refine_loss,
            "weak_reproj_loss": reproj_loss,
            "weak_size_prior_loss": size_prior_loss,
            "weak_fit_prob": mesh_lib.batch_mean(torch.sigmoid(logit)),
            "weak_trust_frac": mesh_lib.batch_mean(gate),
        }
        if diag_classes:
            oh = F.one_hot(batch["class_idx"], diag_classes).to(torch.float32)
            # each class's count over the whole batch; diag_count is the
            # rank's, and the metrics' all-reduce adds the ranks' counts.
            cnt = torch.clamp_min(mesh_lib.global_count(oh.sum(dim=0)), 1.0)

            def per_class(x):
                return torch.einsum("b,bc->c", x, oh) / cnt

            comp = trust_gate_components(out, box, prior=prior)
            losses.update(
                diag_count=oh.sum(dim=0),
                diag_trust_frac=per_class(gate),
                diag_fit_loss=per_class(fit_ex),
                diag_refine_loss=per_class(refine_ex),
                **{f"diag_{k}": per_class(v) for k, v in comp.items()})
        return losses


# ---------------------------------------------------------------------------
# Phase B: the semi-supervised train step
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SemisupState:
    detector: train_loop.TrainState
    boxpc: torch.nn.Module  # frozen by `weak_losses`, never updated


def make_semisup_train_step(cfg: bins_lib.BinConfig,
                            lr_schedule: Callable, bn_schedule: Callable,
                            weak_weight: float = 1.0,
                            weights: WeakLossWeights = WeakLossWeights(),
                            step_cfg: train_loop.StepConfig =
                            train_loop.StepConfig(),
                            weak_warmup_steps: int = 0,
                            diag_classes: int = 0):
    """The supervised loss on the strong batch + the weak losses on the
    weak batch, one backward pass and one optimizer call on the detector.

    The detector runs twice in train mode, the strong pass first: the
    weak pass's BN running statistics start from the strong pass's
    updated ones (JAX threads `upd["batch_stats"]`), and the dropout
    masks are drawn from `state.detector.generator` strong then weak.
    `weak_warmup_steps` ramps the weak weight linearly from 0 (at step 0
    the weak boxes are noise). Returns (state, metrics): the losses,
    `combined_loss`, `lr` and, with `step_cfg.compute_iou_metrics`, the
    strong pass's IoU metrics, as detached tensors. Under a mesh, both
    batches are this rank's block of the global batches (its rows and,
    on a points mesh, its point slices), as in
    `train_loop.make_train_step`; each metric is reduced over its own
    scope and `combined_loss` is taken from the reduced terms.
    """

    def step(state: SemisupState, strong: Dict, weak: Dict
             ) -> Tuple[SemisupState, Dict]:
        det = state.detector
        model = det.model
        device = next(model.parameters()).device
        strong = train_loop.batch_to_device(strong, device)
        weak = train_loop.batch_to_device(weak, device)
        labels = train_loop.labels_from_batch(strong)
        bn_momentum = bn_schedule(det.step)
        model.train()
        det.optimizer.zero_grad()
        ep_s = model(strong["points"], strong["one_hot"],
                     bn_momentum=bn_momentum, generator=det.generator)
        sup = model_util.get_loss(
            ep_s, labels, cfg, box_loss_weight=step_cfg.box_loss_weight,
            corner_loss_weight=step_cfg.corner_loss_weight)
        ep_w = model(weak["points"], weak["one_hot"],
                     bn_momentum=bn_momentum, generator=det.generator)
        wk = weak_losses(ep_w, weak, state.boxpc, cfg, weights,
                         diag_classes=diag_classes)
        w_eff = weak_weight
        if weak_warmup_steps > 0:
            w_eff = weak_weight * float(np.clip(
                np.float32(det.step) / np.float32(weak_warmup_steps),
                0.0, 1.0))
        total = sup["total_loss"] + w_eff * wk["weak_total_loss"]
        total.backward()
        mesh_lib.all_reduce_grads(
            det.optimizer.params,
            replicated=train_loop.points_replicated_params(model))
        det.optimizer.step()

        metrics = {k: v.detach() for k, v in {**sup, **wk}.items()}
        if step_cfg.compute_iou_metrics:
            with torch.no_grad():
                metrics.update(model_util.compute_metrics(
                    {k: v.detach() for k, v in ep_s.items()}, labels, cfg,
                    class_idx=strong.get("class_idx")))
        metrics = train_loop.reduce_step_metrics(metrics, step_cfg)
        metrics["combined_loss"] = (metrics["total_loss"]
                                    + w_eff * metrics["weak_total_loss"])
        metrics["lr"] = lr_schedule(det.step)
        det.step += 1
        return state, metrics

    return step
