"""BoxPC fit network: the Transferable3D transfer signal.

Port of `transferable3d_tpu/models/boxpc.py`. Given a frustum point
cloud and a candidate 3D box, the net predicts (a) how well the box fits
the cloud (a logit) and (b) a refinement delta toward the true box.
Trained on strong classes with perturbed ground-truth boxes, it is
class-agnostic, and serves as the supervision signal for weak (2D-only)
classes (`train/semisup.py`) and as a refinement at inference
(`train/test.py`, `--boxpc_refine`).

Points are expressed in the candidate box's frame (translate by -center,
rotate by -heading, normalize by the half sizes) with an inside-box
indicator channel: that is what makes the signal class-agnostic.

The JAX perturbation sampler draws from `jax.random`, whose streams
torch cannot reproduce, so the draw is split in two: `perturbation_draws`
takes the random numbers from a `torch.Generator`, and
`perturbed_from_draws`, a pure function, builds the boxes from them
exactly as JAX's `sample_perturbed_boxes` does from its own.

The net is float32, as the JAX package builds it; module names follow
the flax tree (`mlp.*`, `head.fc_i`, `head.bn_i`, `head.out`), so
`utils/bridge.py` carries its variables across.

On a (data, points) mesh (`parallel/mesh.py`) the net takes the rank's
point slice and the whole box: the canonical features and the point MLP
run on the slice (BN statistics over every rank), the pool across the
points group, and the head (`points_replicated`) under
`mesh.replicated_over_points`, whose gradients are summed over the data
group.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from transferable3d_torch.core import bins as bins_lib
from transferable3d_torch.core import geometry
from transferable3d_torch.models.layers import (MLPHead, PointMLP,
                                                 masked_max_pool)
from transferable3d_torch.parallel import mesh as mesh_lib


class BoxParams(NamedTuple):
    center: torch.Tensor   # [B, 3]
    size: torch.Tensor     # [B, 3] (l, w, h)
    heading: torch.Tensor  # [B]


def canonicalize_points(points: torch.Tensor, box: BoxParams
                        ) -> torch.Tensor:
    """Express points [B, N, 3] in the box frame; add the inside indicator.

    Returns [B, N, 7]: xyz normalized by the half sizes in the box-frame
    axis order (l, h, w), tanh of the raw box-frame xyz, and the inside-box
    mask.
    """
    rel = points - box.center[:, None, :]
    rel = geometry.rotate_points_y(rel, -box.heading)
    half = torch.clamp_min(box.size / 2.0, 1e-3)  # (l, w, h)
    # box frame: x spans l, y spans h, z spans w.
    denom = torch.stack([half[:, 0], half[:, 2], half[:, 1]], dim=-1)
    normed = rel / denom[:, None, :]
    inside = (normed.abs().amax(dim=-1) <= 1.0).to(points.dtype)
    return torch.cat([normed, torch.tanh(rel), inside[..., None]], dim=-1)


class BoxPCFitNet(nn.Module):
    """(points, box) -> fit logit + box refinement deltas.

    Deltas are in the *candidate box frame*: `apply_deltas` rotates the
    center delta back by the box heading. Weights are drawn on the CPU
    from `generator` (default: a generator seeded with 0) and then moved
    to `device` (the card unless `device` says otherwise).
    """

    def __init__(self, cfg: bins_lib.BinConfig, *, dtype=torch.float32,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg  # kept for the registry's signature
        gen = (torch.Generator().manual_seed(0) if generator is None
               else generator)
        kw = dict(dtype=dtype, device=device, generator=gen)
        self.dtype = dtype
        self.mlp = PointMLP(7, [64, 64, 128, 256], **kw)
        self.head = MLPHead(256 + 3, [256, 128], 1 + 3 + 1 + 3,
                            dropout_rate=0.3, **kw)

    points_replicated = ("head",)

    def forward(self, points: torch.Tensor, box: BoxParams,
                bn_momentum: float = 0.9,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """`generator` draws the head's dropout masks in train mode. On a
        points mesh the slice's features read the box through
        `mesh.from_replicated`: their cotangent of it is the slice's
        share, summed over the points group."""
        feats = canonicalize_points(
            points[..., :3], BoxParams(*map(mesh_lib.from_replicated, box)))
        x = self.mlp(feats.to(self.dtype), bn_momentum)
        g = mesh_lib.to_replicated(masked_max_pool(x))  # [B, 256]
        with mesh_lib.replicated_over_points():
            # Box scale context (log-size is scale-equivariant).
            g = torch.cat(
                [g, torch.log(torch.clamp_min(box.size, 1e-3)).to(
                    self.dtype)], dim=-1)
            out = self.head(g, bn_momentum, generator)
        return {
            "fit_logit": out[:, 0],
            "delta_center": out[:, 1:4],
            "delta_heading": out[:, 4],
            "delta_size": out[:, 5:8],
        }


def apply_deltas(box: BoxParams, deltas: Dict[str, torch.Tensor]
                 ) -> BoxParams:
    """Refine a candidate box with predicted deltas (box-frame center)."""
    dc_world = geometry.rotate_points_y(
        deltas["delta_center"][:, None, :], box.heading)[:, 0]
    # Log-size deltas are unbounded network outputs: clamp to a sane
    # refinement range so exp() cannot overflow on an untrained head.
    dsize = torch.clamp(deltas["delta_size"], -2.0, 2.0)
    return BoxParams(
        center=box.center + dc_world,
        size=torch.clamp_min(box.size * torch.exp(dsize), 0.01),
        heading=box.heading + deltas["delta_heading"])


# ---------------------------------------------------------------------------
# Perturbation sampling + training loss
# ---------------------------------------------------------------------------

def perturbation_draws(generator: torch.Generator, b: int
                       ) -> Tuple[torch.Tensor, ...]:
    """The random numbers of one perturbation of `b` boxes, on the
    generator's device, in the order of JAX's four keys: `u` [b] uniform
    in [0, 1) (the arm), `n_c` [b, 3] standard normal (center), `u_s`
    [b, 3] uniform in [-1, 1) (log-size), `n_h` [b] standard normal
    (heading)."""
    dev = generator.device
    u = torch.rand((b,), generator=generator, device=dev)
    n_c = torch.randn((b, 3), generator=generator, device=dev)
    u_s = torch.rand((b, 3), generator=generator, device=dev) * 2.0 - 1.0
    n_h = torch.randn((b,), generator=generator, device=dev)
    return u, n_c, u_s, n_h


def perturbed_from_draws(gt: BoxParams, u: torch.Tensor, n_c: torch.Tensor,
                         u_s: torch.Tensor, n_h: torch.Tensor,
                         small_frac: float = 0.5, wide_frac: float = 0.25
                         ) -> BoxParams:
    """Random perturbations of GT boxes from the draws (JAX's
    `sample_perturbed_boxes` after its `jax.random` calls).

    A per-sample mixture of small perturbations (mostly still "fit"),
    medium ones (mostly "no fit") and a wide arm (log-size in +-1.4,
    center offsets ~0.5x size, headings ~0.8 rad) that pins the fit
    landscape down wherever the semi-supervised step can move a
    predicted box (see the JAX module's docstring for the collapse this
    prevents).
    """
    dev = gt.center.device
    u, n_c, u_s, n_h = (x.to(dev) for x in (u, n_c, u_s, n_h))
    small = u < small_frac
    wide = u >= 1.0 - wide_frac

    def arm(s, w, m):
        return torch.where(small, s, torch.where(wide, w, m)).to(
            gt.center.dtype)

    c_std = arm(0.05, 0.5, 0.35)[:, None]
    s_rng = arm(0.05, 1.4, 0.35)[:, None]
    h_std = arm(0.05, 0.8, 0.5)
    dc = n_c * c_std * torch.clamp_min(gt.size, 0.1)
    ds = torch.exp(u_s * s_rng)
    dh = n_h * h_std
    return BoxParams(center=gt.center + dc, size=gt.size * ds,
                     heading=gt.heading + dh)


def sample_perturbed_boxes(generator: torch.Generator, gt: BoxParams,
                           small_frac: float = 0.5, wide_frac: float = 0.25
                           ) -> BoxParams:
    """`perturbed_from_draws` on a fresh draw from `generator`."""
    return perturbed_from_draws(
        gt, *perturbation_draws(generator, gt.center.shape[0]),
        small_frac=small_frac, wide_frac=wide_frac)


def boxpc_targets(perturbed: BoxParams, gt: BoxParams,
                  fit_iou_thresh: float = 0.5) -> Dict[str, torch.Tensor]:
    """Supervision for BoxPC: the fit label from the rotated 3D IoU and
    the exact deltas that map the perturbed box back onto the GT box."""
    iou3d, _ = geometry.box3d_iou(
        perturbed.center, perturbed.size, perturbed.heading,
        gt.center, gt.size, gt.heading)
    fit_label = (iou3d >= fit_iou_thresh).to(torch.float32)
    dc_world = gt.center - perturbed.center
    dc_box = geometry.rotate_points_y(
        dc_world[:, None, :], -perturbed.heading)[:, 0]
    return {
        "fit_label": fit_label,
        "iou3d": iou3d,
        "delta_center": dc_box,
        "delta_heading": gt.heading - perturbed.heading,
        "delta_size": torch.log(torch.clamp_min(gt.size, 1e-3)
                                / torch.clamp_min(perturbed.size, 1e-3)),
    }


def _huber_mean(x: torch.Tensor, d: float = 1.0) -> torch.Tensor:
    a = x.abs()
    q = torch.clamp_max(a, d)
    return mesh_lib.batch_mean(0.5 * q ** 2 + d * (a - q))


def boxpc_loss(outputs: Dict[str, torch.Tensor],
               targets: Dict[str, torch.Tensor],
               delta_weight: float = 10.0) -> Dict[str, torch.Tensor]:
    """BCE fit loss + Huber delta losses (deltas on all samples: the net
    must push any box toward the GT, not only near-fits)."""
    logit = outputs["fit_logit"]
    label = targets["fit_label"]
    fit_loss = mesh_lib.batch_mean(
        torch.clamp_min(logit, 0) - logit * label
        + torch.log1p(torch.exp(-logit.abs())))
    dc = _huber_mean(outputs["delta_center"] - targets["delta_center"])
    dh = _huber_mean(outputs["delta_heading"] - targets["delta_heading"])
    ds = _huber_mean(outputs["delta_size"] - targets["delta_size"])
    total = fit_loss + delta_weight * (dc + dh + ds)
    acc = mesh_lib.batch_mean(
        ((logit > 0) == (label > 0.5)).to(torch.float32))
    return {
        "total_loss": total, "fit_loss": fit_loss, "fit_accuracy": acc,
        "delta_center_loss": dc, "delta_heading_loss": dh,
        "delta_size_loss": ds,
        "pos_fraction": mesh_lib.batch_mean(label),
    }
