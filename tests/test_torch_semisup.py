"""Phase B of the transfer loop (train/semisup.py: the weak losses, the
trust gate, `make_semisup_train_step`), the semi-supervised driver
(train/train_semisup.py) and the BoxPC refinement of train/test.py,
against the JAX package from the same numpy inputs and bridged weights,
on the CPU. Mirrors tests/test_boxpc_semisup.py.

Tolerances:
* `weak_losses` term by term (and the per-class diagnostic vectors)
  within rtol 1e-5 / atol 1e-6, the gradients to the end points within
  rtol 1e-4 / atol 1e-6 of each leaf's largest value; the gate equal;
* `differentiable_box`, both reprojection residuals and the trust gate's
  components within 1e-5 (values and gradients), the gates and the bin
  choices (first index on ties) equal;
* one phase-B step of F-PointNet v1 in float32, with both passes'
  dropout masks injected, as tests/test_torch_train_step_v1.py holds one
  supervised step: every loss term within rtol 3e-4 (the per-class
  vectors of BoxPC's outputs within 1e-3 of their largest entry:
  measured 4.2e-4 relative, 5e-5 absolute on a fit loss of 0.022), the
  gradient
  (without the leaves that are zero in exact arithmetic) within relative
  L2 1e-2 and cosine 0.9999, the BN running statistics (chained strong
  -> weak) within 1e-4 / 1e-3 of each leaf's largest value, the new
  parameters off by an Adam sign flip in at most 1% of entries; BoxPC
  bit-identical;
* the refine step within rtol 1e-4 / atol 1e-5;
* `evaluate(boxpc_dir=...)` against JAX's `evaluate` on bridged
  checkpoints: the same frames and classes, centers, sizes and headings
  within 2e-4 (the files' 4 decimals), scores within 1e-5 relative, the
  same APs within 1e-6.
"""

import copy
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_boxpc import bridged_boxpc, strong_batch
from torch_parity import (one_torch_thread,  # noqa: F401
                          perturb_stats, split_noise_grads, to_numpy_tree,
                          tree_leaves)
from transferable3d_tpu.core import bins as jbins
from transferable3d_tpu.core import geometry as jgeom
from transferable3d_tpu.models import boxpc as jboxpc
from transferable3d_tpu.train import schedules as jsched
from transferable3d_tpu.train import semisup as jsemi
from transferable3d_tpu.train import train_loop as jloop
from transferable3d_torch.core import bins as tbins
from transferable3d_torch.core import geometry as tgeom
from transferable3d_torch.models import boxpc as tboxpc
from transferable3d_torch.models import layers as tlayers
from transferable3d_torch.train import schedules as tsched
from transferable3d_torch.train import semisup as tsemi
from transferable3d_torch.train import test as ttest
from transferable3d_torch.train import train_loop as tloop
from transferable3d_torch.train import train_semisup
from transferable3d_torch.utils import bridge
from transferable3d_torch.utils.checkpoint import CheckpointManager

pytestmark = pytest.mark.usefixtures("one_torch_thread")
CFG = jbins.SUNRGBD
TCFG = tbins.SUNRGBD
CPU = torch.device("cpu")
NC, NH, NS = CFG.num_classes, CFG.num_heading_bin, CFG.num_size_cluster


def test_weak_loss_weights_and_config_fields_equal_jax():
    from transferable3d_tpu.train import train_semisup as jdrv

    def fields(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]

    assert fields(tsemi.WeakLossWeights) == fields(jsemi.WeakLossWeights)
    assert fields(train_semisup.SemisupConfig) == fields(jdrv.SemisupConfig)
    assert (train_semisup.DEFAULT_STRONG, train_semisup.DEFAULT_WEAK) == (
        jdrv.DEFAULT_STRONG, jdrv.DEFAULT_WEAK)


def _camera(rng, b):
    p = np.zeros((b, 3, 4), np.float32)
    p[:, 0, 0] = p[:, 1, 1] = 700.0
    p[:, 0, 2], p[:, 1, 2], p[:, 2, 2] = 620.0, 190.0, 1.0
    p[:, 0, 3] = rng.uniform(-40, 40, b)
    return p


def weak_batch(seed=4, calib=True):
    """A provider batch of 8 frustums (128 points); with `calib`, camera
    matrices and 2D boxes from the projected GT corners (plus noise),
    with `has_calib` on every other example."""
    batch = strong_batch(n=8, npoints=128, seed=seed)
    rng = np.random.RandomState(seed)
    if not calib:
        for k in ("calib_p", "has_calib", "box2d", "frustum_angle"):
            batch.pop(k)
        return batch
    b = len(batch["points"])
    gt = jsemi.gt_boxes_from_batch(batch, CFG)
    corners = np.array(jgeom.rotate_points_y(
        jgeom.box_corners(gt.center, gt.size, gt.heading),
        -jnp.asarray(batch["frustum_angle"])))
    corners[..., 2] += 6.0  # in front of the camera
    p = _camera(rng, b)
    uvw = np.einsum("bnc,bdc->bnd", np.concatenate(
        [corners, np.ones((b, 8, 1), np.float32)], -1), p)
    uv = uvw[..., :2] / uvw[..., 2:3]
    batch["box2d"] = (np.concatenate([uv.min(1), uv.max(1)], -1)
                      + rng.normal(0, 5, (b, 4))).astype(np.float32)
    batch["calib_p"] = p
    batch["has_calib"] = np.float32(np.arange(b) % 2 == 0)
    return batch


def end_points(batch, seed=0):
    """Random detector outputs around the batch's GT boxes, with the
    heading scores of two examples tied (argmax: first index)."""
    rng = np.random.RandomState(seed)
    b = len(batch["points"])
    ep = {"center": batch["center"] + rng.normal(0, 0.2, (b, 3)),
          "heading_scores": rng.normal(0, 1, (b, NH)),
          "heading_residuals": rng.normal(0, 0.1, (b, NH)),
          "size_scores": rng.normal(0, 1, (b, NS)),
          "size_residuals": rng.normal(0, 0.15, (b, NS, 3))}
    ep["heading_scores"][:2] = 0.5
    return {k: np.float32(v) for k, v in ep.items()}


OPEN_GATE = dict(trust_center=10.0, trust_size=10.0, trust_heading=10.0,
                 trust_prior_logsize=10.0, size_cls=0.5)


def mixed_gate(batch, ep, model):
    """Gate thresholds that pass some examples and stop others: the
    median of the untrained BoxPC's centre deltas (whose other deltas and
    prior deviations are let through)."""
    tep = {k: torch.from_numpy(v) for k, v in ep.items()}
    cls = torch.from_numpy(batch["class_idx"])
    box = tsemi.differentiable_box(tep, TCFG, cls)
    with torch.no_grad():
        comp = tsemi.trust_gate_components(
            tsemi.freeze(model)(torch.from_numpy(batch["points"]), box), box)
    return dict(OPEN_GATE, size_cls=0.0,
                trust_center=float(comp["dc_mag"].median()))


@pytest.mark.parametrize("case", ["default", "gate_mixed", "gate_open",
                                  "no_calib"])
def test_weak_losses_term_by_term_equal_jax(case):
    """The untrained BoxPC's deltas close the default gate on every
    example; `gate_mixed` passes half of them, `gate_open` all (with the
    size-class term on); `no_calib` is a device-drawn batch's form (no
    `calib_p`: the angular span everywhere). The per-class vectors'
    count-weighted means reproduce the batch scalars."""
    batch = weak_batch(calib=case != "no_calib")
    jm, params, stats, model = bridged_boxpc(batch)
    ep = end_points(batch)
    kw = {"gate_open": OPEN_GATE,
          "gate_mixed": mixed_gate(batch, ep, model)}.get(case, {})
    jw = jsemi.WeakLossWeights(**kw)
    tw = tsemi.WeakLossWeights(**dataclasses.asdict(jw))

    def f(e):
        losses = jsemi.weak_losses(e, batch, jm, {"params": params,
                                                  "batch_stats": stats},
                                   CFG, jw, diag_classes=NC)
        return losses["weak_total_loss"], losses

    (_, want), jgrad = jax.value_and_grad(f, has_aux=True)(
        {k: jnp.asarray(v) for k, v in ep.items()})
    tep = {k: torch.tensor(v, requires_grad=True) for k, v in ep.items()}
    before = copy.deepcopy(model.state_dict())
    got = tsemi.weak_losses(tep, tloop.batch_to_device(batch, CPU), model,
                            TCFG, tw, diag_classes=NC)
    got["weak_total_loss"].backward()
    assert sorted(got) == sorted(want)
    print(case, {k: float(v) for k, v in want.items() if np.ndim(v) == 0})
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    trust = float(want["weak_trust_frac"])
    assert trust == {"gate_mixed": 0.5, "gate_open": 1.0}.get(case, 0.0)
    cnt = got["diag_count"].numpy()
    assert cnt.sum() == 8
    for key, scalar in (("diag_trust_frac", "weak_trust_frac"),
                        ("diag_fit_loss", "weak_fit_loss"),
                        ("diag_refine_loss", "weak_refine_loss")):
        np.testing.assert_allclose(
            (got[key].detach().numpy() * cnt).sum() / 8,
            float(got[scalar].detach()), rtol=1e-5, atol=1e-7)
    for k, g in jgrad.items():
        g = np.asarray(g)
        tg = tep[k].grad
        tg = np.zeros_like(g) if tg is None else tg.numpy()
        np.testing.assert_allclose(tg, g, rtol=1e-4,
                                   atol=1e-6 * max(np.abs(g).max(), 1e-30),
                                   err_msg=k)
    assert np.abs(np.asarray(jgrad["size_residuals"])).max() > 0
    # BoxPC is frozen: no gradient, the same weights and statistics.
    assert all(p.grad is None and not p.requires_grad
               for p in model.parameters())
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    if case == "gate_open":  # the size-class term reaches the scores
        assert np.abs(np.asarray(jgrad["size_scores"])).max() > 0


@pytest.mark.parametrize("known_class", [True, False])
def test_differentiable_box_equal_jax(known_class):
    batch = weak_batch()
    ep = end_points(batch, seed=2)
    ep["size_residuals"][3, batch["class_idx"][3], 0] = -10.0  # floored
    ep["size_residuals"][4, :, 1] = -10.0
    cls = batch["class_idx"] if known_class else None
    prior = CFG.mean_size_array()[batch["class_idx"]]

    def jloss(e):
        box = jsemi.differentiable_box(
            e, CFG, None if cls is None else jnp.asarray(cls))
        return (jnp.sum(((box.size - prior) / prior) ** 2)
                + jnp.sum(box.center * 0.3) + jnp.sum(box.heading ** 2)), box

    (_, jbox), jg = jax.value_and_grad(jloss, has_aux=True)(
        {k: jnp.asarray(v) for k, v in ep.items()})
    tep = {k: torch.tensor(v, requires_grad=True) for k, v in ep.items()}
    tbox = tsemi.differentiable_box(
        tep, TCFG, None if cls is None else torch.from_numpy(cls))
    loss = (torch.sum(((tbox.size - torch.from_numpy(prior))
                       / torch.from_numpy(prior)) ** 2)
            + torch.sum(tbox.center * 0.3) + torch.sum(tbox.heading ** 2))
    loss.backward()
    for a, b in zip(tbox, jbox):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=1e-6, atol=1e-6)
    assert float(tbox.size.detach().min()) >= 0.01 - 1e-6
    for k in ("center", "heading_residuals", "size_residuals"):
        np.testing.assert_allclose(tep[k].grad.numpy(), np.asarray(jg[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    # ties pick the first bin: the tied rows' gradient sits in bin 0
    hg = tep["heading_residuals"].grad.numpy()
    assert (hg[:2, 0] != 0).all() and (hg[:2, 1:] == 0).all()
    # the straight-through floor: a restoring gradient below it
    if known_class:
        assert tep["size_residuals"].grad[3, batch["class_idx"][3], 0] < -1e-3
    assert tep["heading_scores"].grad is None or float(
        tep["heading_scores"].grad.abs().max()) == 0


def test_reprojection_residuals_equal_jax():
    """Both residuals and their gradients against JAX; the calib-exact
    one is zero at the true box and positive off it."""
    rng = np.random.RandomState(3)
    b = 6
    p = _camera(rng, b)
    center = np.stack([rng.uniform(-4, 4, b), rng.uniform(-0.5, 1.0, b),
                       rng.uniform(8, 30, b)], -1).astype(np.float32)
    size = rng.uniform(0.8, 3.0, (b, 3)).astype(np.float32)
    heading = rng.uniform(-np.pi, np.pi, b).astype(np.float32)
    rect = tgeom.box_corners_np(center, size, heading)
    hom = np.concatenate([rect, np.ones((b, 8, 1))], -1)
    uvw = np.einsum("bnc,bdc->bnd", hom, p)
    uv = uvw[..., :2] / uvw[..., 2:3]
    box2d = np.concatenate([uv.min(1), uv.max(1)], -1).astype(np.float32)
    ang = rng.uniform(-0.5, 0.5, b).astype(np.float32)
    pts = rng.uniform(-3, 3, (b, 50, 4)).astype(np.float32)
    pts[..., 2] += 10

    def j_res(c):
        corners = jgeom.rotate_points_y(
            jgeom.box_corners(c, jnp.asarray(size), jnp.asarray(heading)),
            jnp.asarray(ang))
        return (jsemi.calib_reprojection_residual(
            corners, jnp.asarray(ang), jnp.asarray(p), jnp.asarray(box2d)),
            jsemi.angular_span_residual(corners, jnp.asarray(pts)))

    def t_res(c):
        corners = tgeom.rotate_points_y(
            tgeom.box_corners(c, torch.from_numpy(size),
                              torch.from_numpy(heading)),
            torch.from_numpy(ang))
        return (tsemi.calib_reprojection_residual(
            corners, torch.from_numpy(ang), torch.from_numpy(p),
            torch.from_numpy(box2d)),
            tsemi.angular_span_residual(corners, torch.from_numpy(pts)))

    at_true = t_res(torch.from_numpy(center))[0].numpy()
    np.testing.assert_allclose(at_true, 0.0, atol=1e-4)
    shifted = center + np.array([1.0, 0.3, -0.5], np.float32)
    want = j_res(jnp.asarray(shifted))
    tc = torch.tensor(shifted, requires_grad=True)
    got = t_res(tc)
    assert float(got[0].detach().min()) > 1e-3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-6)
    for i in range(2):
        jg = jax.grad(lambda c: jnp.sum(j_res(c)[i]))(jnp.asarray(shifted))
        tc.grad = None
        torch.sum(t_res(tc)[i]).backward()
        np.testing.assert_allclose(tc.grad.numpy(), np.asarray(jg),
                                   rtol=1e-5, atol=1e-6)
        assert float(tc.grad.abs().max()) > 0


def test_trust_gate_and_prior_window_equal_jax():
    """tests/test_boxpc_semisup.py's gate examples, and random ones,
    against JAX: the gate values, their components, no gradient."""
    out = {"fit_logit": np.zeros(4),
           "delta_center": np.array([[0.1, 0, 0], [5.0, 0, 0], [0.1, 0, 0],
                                     [0.1, 0, 0]]),
           "delta_size": np.array([[0.1, 0, 0], [0.1, 0, 0], [1.8, 0, 0],
                                   [0.1, 0, 0]]),
           "delta_heading": np.array([0.2, 0.2, 0.2, 2.5])}
    box = (np.zeros((4, 3)), np.ones((4, 3)), np.zeros(4))
    rng = np.random.RandomState(0)
    rnd = {"fit_logit": rng.normal(0, 1, 64),
           "delta_center": rng.normal(0, 0.6, (64, 3)),
           "delta_size": rng.normal(0, 0.5, (64, 3)),
           "delta_heading": rng.normal(0, 0.8, 64)}
    rbox = (rng.normal(0, 1, (64, 3)), rng.uniform(0.1, 3, (64, 3)),
            rng.uniform(-3, 3, 64))
    cases = [(out, box, None, [1, 0, 0, 0]),
             ({k: np.full((3,) + np.shape(v)[1:], 0.05)
               for k, v in out.items() if k != "fit_logit"}
              | {"fit_logit": np.zeros(3)},
              (np.zeros((3, 3)), np.array([[1.0, 1, 1], [0.02, 1, 1],
                                           [4.0, 1, 1]]), np.zeros(3)),
              np.ones((3, 3)), [1, 0, 0]),
             (rnd, rbox, rng.uniform(0.3, 2, (64, 3)), None)]
    for o, bx, prior, expect in cases:
        o = {k: np.float32(v) for k, v in o.items()}
        bx = [np.float32(x) for x in bx]
        pr = None if prior is None else np.float32(prior)
        for on in (True, False):
            jw = jsemi.WeakLossWeights(trust_gate=on)
            tw = tsemi.WeakLossWeights(trust_gate=on)
            want = np.asarray(jsemi.boxpc_trust_gate(
                {k: jnp.asarray(v) for k, v in o.items()},
                jboxpc.BoxParams(*map(jnp.asarray, bx)), jw,
                None if pr is None else jnp.asarray(pr)))
            tdc = torch.tensor(o["delta_center"], requires_grad=True)
            got = tsemi.boxpc_trust_gate(
                {k: torch.from_numpy(v) for k, v in o.items()}
                | {"delta_center": tdc},
                tboxpc.BoxParams(*map(torch.from_numpy, bx)), tw,
                None if pr is None else torch.from_numpy(pr))
            assert not got.requires_grad
            np.testing.assert_array_equal(got.numpy(), want)
            if on and expect is not None:
                np.testing.assert_array_equal(want, expect)
            if not on:
                np.testing.assert_array_equal(want, 1.0)
        if expect is None:
            assert 0 < want.mean() < 1 or not on
        jc = jsemi.trust_gate_components(
            {k: jnp.asarray(v) for k, v in o.items()},
            jboxpc.BoxParams(*map(jnp.asarray, bx)),
            None if pr is None else jnp.asarray(pr))
        tc = tsemi.trust_gate_components(
            {k: torch.from_numpy(v) for k, v in o.items()},
            tboxpc.BoxParams(*map(torch.from_numpy, bx)),
            None if pr is None else torch.from_numpy(pr))
        assert sorted(tc) == sorted(jc)
        for k in jc:
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                       rtol=1e-5, atol=1e-6, err_msg=k)


# ---------------------------------------------------------------------------
# One phase-B step, F-PointNet v1, float32
# ---------------------------------------------------------------------------

# The phase-B step's weights: the gate's thresholds raised (with the
# untrained BoxPC the default gate closes on every example), so the fit
# and refine terms' gradients pass through the frozen BoxPC into the
# detector for most examples.
STEP_WEIGHTS = dict(OPEN_GATE, size_cls=0.0)
# BoxPC's outputs on the weak pass's boxes: its untrained deltas reach 59
# box sizes and carry the weak pass's 1e-4 differences (the JAX masking
# rebuilds the object points from bf16 hi + lo parts).
BOXPC_DIAG = ("diag_dc_mag", "diag_ds_mag", "diag_dh_mag", "diag_prior_dev",
              "diag_fit_loss", "diag_refine_loss")


def _jax_semisup_step(strong, weak):
    from transferable3d_tpu.models import model_util as jmu
    from transferable3d_tpu.models.frustum_pointnet_v1 import (
        FrustumPointNetV1)

    b = len(strong["points"])
    det = FrustumPointNetV1(cfg=CFG, num_object_point=64)
    bp = jboxpc.BoxPCFitNet(cfg=CFG)
    lr = jsched.exponential_staircase_lr(base_lr=1e-3, batch_size=b)
    bn = jsched.bn_momentum_schedule(batch_size=b)
    tx = jloop.make_optimizer(lr)
    det_state = jloop.create_train_state(det, CFG, tx, strong, seed=0)
    det_state = det_state.replace(batch_stats=jax.tree_util.tree_map(
        jnp.asarray, perturb_stats(to_numpy_tree(det_state.batch_stats),
                                   np.random.RandomState(7))))
    bp_state = jsemi.create_boxpc_state(bp, CFG, jloop.make_optimizer(lr),
                                        strong, seed=1)
    bp_stats = perturb_stats(to_numpy_tree(bp_state.batch_stats),
                             np.random.RandomState(8))
    state = jsemi.SemisupState(
        detector=det_state, boxpc_params=bp_state.params,
        boxpc_batch_stats=jax.tree_util.tree_map(jnp.asarray, bp_stats))
    snap = {"det_params": to_numpy_tree(det_state.params),
            "det_stats": to_numpy_tree(det_state.batch_stats),
            "bp_params": to_numpy_tree(bp_state.params),
            "bp_stats": bp_stats}
    rng = jax.random.fold_in(det_state.rng, det_state.step)
    r_s, r_w = jax.random.split(rng)
    labels = jloop.labels_from_batch(
        {k: jnp.asarray(v) for k, v in strong.items()})
    bvars = {"params": state.boxpc_params,
             "batch_stats": state.boxpc_batch_stats}
    m = bn(det_state.step)

    def run(params, stats, batch, r):
        ep, upd = det.apply(
            {"params": params, "batch_stats": stats}, batch["points"],
            batch["one_hot"], train=True, bn_momentum=m,
            rngs={"dropout": r}, mutable=["batch_stats", "intermediates"],
            capture_intermediates=lambda mdl, _: mdl.name in ("dp", "mlp3"))
        seg = upd["intermediates"]["seg_net"]
        return ep, upd, (seg["dp"]["__call__"][0],
                         seg["mlp3"]["__call__"][0])

    def loss_fn(params):
        ep_s, upd, dps = run(params, det_state.batch_stats, strong, r_s)
        sup = jmu.get_loss(ep_s, labels, CFG)
        ep_w, _, dpw = run(params, upd["batch_stats"], weak, r_w)
        wk = jsemi.weak_losses(ep_w, weak, bp, bvars, CFG,
                               jsemi.WeakLossWeights(**STEP_WEIGHTS),
                               diag_classes=NC)
        return (sup["total_loss"] + wk["weak_total_loss"],
                (dps, dpw, ep_s["mask"], ep_w["mask"]))

    grads, (dps, dpw, mask_s, mask_w) = jax.jit(
        jax.grad(loss_fn, has_aux=True))(det_state.params)
    keep = [torch.from_numpy((np.asarray(o) != 0) | (np.asarray(i) == 0))
            for o, i in (dps, dpw)]
    jstep = jsemi.make_semisup_train_step(
        det, bp, CFG, tx, lr, bn,
        weights=jsemi.WeakLossWeights(**STEP_WEIGHTS), diag_classes=NC)
    new, metrics = jstep(state, strong, weak)
    return {**snap, "keep": keep, "masks": [np.asarray(mask_s),
                                            np.asarray(mask_w)],
            "jax_grads": tree_leaves(to_numpy_tree(grads)),
            "params": tree_leaves(to_numpy_tree(new.detector.params)),
            "stats": tree_leaves(to_numpy_tree(new.detector.batch_stats)),
            "metrics": {k: np.asarray(v) for k, v in metrics.items()},
            "lr": float(lr(0))}


def test_semisup_step_v1_f32_equal_jax(monkeypatch):
    from transferable3d_torch.models.frustum_pointnet_v1 import (
        FrustumPointNetV1)

    strong = strong_batch(n=8, npoints=128, seed=3)
    weak = weak_batch(seed=4)
    j = _jax_semisup_step(strong, weak)
    det = FrustumPointNetV1(TCFG, num_object_point=64, in_channels=4,
                            device="cpu")
    bridge.load_flax_variables(det, j["det_params"], j["det_stats"])
    bp = tboxpc.BoxPCFitNet(TCFG, device="cpu")
    bridge.load_flax_variables(bp, j["bp_params"], j["bp_stats"])
    bp_before = copy.deepcopy(bp.state_dict())
    tlr = tsched.exponential_staircase_lr(base_lr=1e-3, batch_size=8)
    tbn = tsched.bn_momentum_schedule(batch_size=8)
    state = tsemi.SemisupState(
        detector=tloop.create_train_state(det, tloop.make_optimizer(tlr),
                                          generator=torch.Generator()),
        boxpc=bp)
    assert not {id(p) for p in bp.parameters()} & {
        id(p) for p in state.detector.optimizer.params}
    masks = list(j["keep"])
    monkeypatch.setattr(tlayers, "dropout_keep_mask",
                        lambda shape, rate, gen: masks.pop(0))
    seen = []
    hook = det.register_forward_hook(
        lambda mod, args, out: seen.append(out["mask"].numpy()))
    step = tsemi.make_semisup_train_step(
        TCFG, tlr, tbn, weights=tsemi.WeakLossWeights(**STEP_WEIGHTS),
        diag_classes=NC)
    state, tmet = step(state, strong, weak)
    hook.remove()
    assert masks == [] and state.detector.step == 1
    for got, want in zip(seen, j["masks"]):
        np.testing.assert_array_equal(got, want)

    jm = j["metrics"]
    assert sorted(tmet) == sorted(jm)
    gaps = {k: float(np.max(np.abs(np.asarray(tmet[k], np.float32) - v)
                            / np.maximum(np.abs(v), 1e-30)))
            for k, v in jm.items()}
    print("phase-B metrics, largest relative gaps:",
          sorted(gaps.items(), key=lambda kv: -kv[1])[:6])
    for k, v in jm.items():
        tol = {"lr": 1e-6}.get(k, 1e-3 if k in BOXPC_DIAG else 3e-4)
        atol = 1e-3 * np.abs(v).max() if k in BOXPC_DIAG else 1e-7
        np.testing.assert_allclose(np.asarray(tmet[k], np.float32), v,
                                   rtol=tol, atol=atol, err_msg=k)
    assert 0 < float(jm["weak_trust_frac"]) < 1  # 0.75: a 59-size delta
    assert float(jm["weak_fit_loss"]) > 0 and float(jm["weak_refine_loss"]) > 0

    res = {"jax_grads": j["jax_grads"],
           "port_grads": tree_leaves(bridge.grads_to_flax(det))}
    pairs, noise = split_noise_grads(res, pooled=True, n_noise=21)
    jg = np.concatenate([a.ravel() for a, _ in pairs.values()])
    tg = np.concatenate([b.ravel() for _, b in pairs.values()])
    rel = np.linalg.norm(tg - jg) / np.linalg.norm(jg)
    cos = jg @ tg / (np.linalg.norm(jg) * np.linalg.norm(tg))
    print(f"phase-B gradient: rel L2 {rel:.3g}, cosine {cos:.7f}")
    assert rel <= 1e-2 and cos >= 0.9999

    tparams, tstats = (tree_leaves(x) for x in
                       bridge.state_dict_to_flax(det))
    for p, v in j["stats"].items():
        tol = 1e-4 if p.startswith("seg_net") else 1e-3
        np.testing.assert_allclose(tstats[p], v, rtol=tol,
                                   atol=tol * np.abs(v).max(), err_msg=p)
    p0, lr = tree_leaves(j["det_params"]), j["lr"]
    off = total = 0
    for p, v in j["params"].items():
        assert np.abs(tparams[p] - p0[p]).max() <= 1.01 * lr, p
        if p in noise:
            continue
        bad = ~np.isclose(tparams[p], v, rtol=1e-4, atol=1e-3 * lr)
        off += int(bad.sum())
        total += bad.size
    print(f"new-parameter entries off by an Adam sign flip: {off} of {total}")
    assert off <= 1e-2 * total
    assert all(p.grad is None and not p.requires_grad
               for p in bp.parameters()) and not bp.training
    for k, v in bp.state_dict().items():
        assert torch.equal(v, bp_before[k]), k


def test_semisup_step_v2_bf16_fused_two_passes_port(monkeypatch):
    """Port only (no interpret-mode JAX compile): two v2 bf16 steps on
    the fused set-abstraction path (its plain twins on the CPU). Both
    passes' fused chains share one autograd graph: the step's gradient
    equals the sum of the strong and weak passes' gradients taken in
    separate graphs (within 1e-5 of each leaf's largest entry, for
    autograd may add a leaf's several uses in another order; measured
    bit-identical), and the BN running
    statistics chain strong -> weak exactly as two train-mode forwards
    in that order leave them. A step runs the chain's forward (K5's
    twin) for 16 scales and its backward (K9's) for 10: the strong
    pass's 8 and the weak pass's box net's 2, for the weak losses do not
    reach the weak pass's seg net (its mask is an argmax), as on the
    card. BoxPC stays bit-identical; the weak warmup weighs step 1 of 4
    by 0.25."""
    from transferable3d_torch.ops import fused_sa

    calls = {"sa_extract": 0, "sa_bwd_step0": 0}
    for name in calls:
        def counted(*a, _fn=getattr(fused_sa, name), _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(fused_sa, name, counted)
    from transferable3d_torch.models.frustum_pointnet_v2 import (
        FrustumPointNetV2)
    from transferable3d_torch.models import model_util as tmu

    os.environ.pop("T3D_FUSED_SA", None)
    strong = strong_batch(n=8, npoints=128, seed=5)
    weak = weak_batch(seed=6)
    det = FrustumPointNetV2(TCFG, num_object_point=64, in_channels=4,
                            dtype=torch.bfloat16, device="cpu")
    bp = tboxpc.BoxPCFitNet(TCFG, device="cpu",
                            generator=torch.Generator().manual_seed(1))
    bp_before = copy.deepcopy(bp.state_dict())
    twin = copy.deepcopy(det)
    lr = tsched.exponential_staircase_lr(base_lr=1e-3, batch_size=8)
    bn = tsched.bn_momentum_schedule(batch_size=8)
    state = tsemi.SemisupState(
        tloop.create_train_state(det, tloop.make_optimizer(lr), seed=3), bp)
    step = tsemi.make_semisup_train_step(TCFG, lr, bn, diag_classes=NC)
    grads = {}
    orig_step = state.detector.optimizer.step

    def capture():
        grads.update({k: p.grad.clone() for k, p in det.named_parameters()
                      if p.grad is not None})
        return orig_step()

    state.detector.optimizer.step = capture
    state, m1 = step(state, strong, weak)
    state.detector.optimizer.step = orig_step
    assert calls == {"sa_extract": 16, "sa_bwd_step0": 10}, calls

    # the same two passes in separate graphs, from a copy
    gen = torch.Generator().manual_seed(3)
    sb, wb = (tloop.batch_to_device(x, CPU) for x in (strong, weak))
    twin.train()
    mom = bn(0)
    params = list(twin.parameters())
    ep_s = twin(sb["points"], sb["one_hot"], bn_momentum=mom, generator=gen)
    sup = tmu.get_loss(ep_s, tloop.labels_from_batch(sb), TCFG)
    g_s = torch.autograd.grad(sup["total_loss"], params, allow_unused=True)
    ep_w = twin(wb["points"], wb["one_hot"], bn_momentum=mom, generator=gen)
    wk = tsemi.weak_losses(ep_w, wb, bp, TCFG, diag_classes=NC)
    g_w = torch.autograd.grad(wk["weak_total_loss"], params,
                              allow_unused=True)
    assert float(m1["weak_total_loss"]) == float(wk["weak_total_loss"])
    assert float(m1["total_loss"]) == float(sup["total_loss"])
    worst = 0.0
    for (k, p), a, b in zip(twin.named_parameters(), g_s, g_w):
        want = sum(x for x in (a, b) if x is not None)
        if k not in grads:
            assert a is None and b is None, k
            continue
        scale = max(float(want.abs().max()), 1e-30)
        worst = max(worst, float((grads[k] - want).abs().max()) / scale)
    print(f"two passes in one graph vs separate graphs: worst leaf {worst}")
    assert worst <= 1e-5
    assert len(grads) == len(params)
    for k, v in twin.state_dict().items():
        if k.rsplit(".", 1)[-1] in ("mean", "var"):
            assert torch.equal(v, det.state_dict()[k]), k

    step = tsemi.make_semisup_train_step(TCFG, lr, bn, diag_classes=NC,
                                         weak_warmup_steps=4)
    state, m2 = step(state, strong, weak)
    assert all(np.isfinite(np.asarray(v, np.float32)).all()
               for v in m2.values())
    assert m2["diag_trust_frac"].shape == (NC,)
    np.testing.assert_allclose(  # the warmup's weight at step 1 of 4
        float(m2["combined_loss"]),
        float(m2["total_loss"]) + 0.25 * float(m2["weak_total_loss"]),
        rtol=1e-6)
    assert state.detector.step == 2
    for k, v in bp.state_dict().items():
        assert torch.equal(v, bp_before[k]), k


# ---------------------------------------------------------------------------
# BoxPC refinement at inference
# ---------------------------------------------------------------------------

def test_boxpc_refine_step_equal_jax():
    from transferable3d_tpu.train import test as jtest

    batch = strong_batch(n=8, npoints=128, seed=7)
    jm, params, stats, model = bridged_boxpc(batch, seed=2)
    rng = np.random.RandomState(0)
    gt = [np.asarray(x) for x in jsemi.gt_boxes_from_batch(batch, CFG)]
    box = [np.float32(gt[0] + rng.normal(0, 0.3, (8, 3))),
           np.float32(gt[1] * np.exp(rng.uniform(-0.4, 0.4, (8, 3)))),
           np.float32(gt[2] + rng.normal(0, 0.4, 8))]
    want = jtest.make_boxpc_refine_step(jm, iterations=2)(
        {"params": params, "batch_stats": stats}, batch["points"], *box)
    got = ttest.make_boxpc_refine_step(model, iterations=2)(
        torch.from_numpy(batch["points"]), *map(torch.from_numpy, box))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)
    assert not np.allclose(got[0].numpy(), box[0])


def _tiny_eval_cfg(log_dir):
    from transferable3d_torch.train import config as tconfig

    return tconfig.TrainConfig(
        model="box_estimation_v1", num_point=128, num_channels=4,
        batch_size=8, synthetic_train=8, synthetic_val=12,
        log_dir=str(log_dir))


def test_evaluate_with_boxpc_equal_jax(tmp_path):
    """JAX's `evaluate(boxpc_dir=...)` and the port's on the same weights
    (detector and BoxPC, BN statistics perturbed) through bridged
    checkpoints: the same detection file within its printed precision,
    the same APs; the refined detections differ from the unrefined."""
    from transferable3d_tpu.models import registry as jreg
    from transferable3d_tpu.train import config as jconfig
    from transferable3d_tpu.train import test as jtest
    from transferable3d_tpu.train import train_sup as jtrain_sup
    from transferable3d_tpu.utils.checkpoint import (
        CheckpointManager as JCkpt)
    from transferable3d_torch.train import train_sup

    tcfg = _tiny_eval_cfg(tmp_path / "port")
    jcfg = jconfig.TrainConfig(**dataclasses.asdict(tcfg))
    jcfg = dataclasses.replace(jcfg, log_dir=str(tmp_path / "jax"))
    _, val_ds = jtrain_sup.build_datasets(jcfg)
    sample = val_ds.get_batch(list(range(8)))
    lr = jsched.exponential_staircase_lr(batch_size=8)
    tx = jloop.make_optimizer(lr)
    jdet = jreg.get_model("box_estimation_v1", CFG)
    dstate = jloop.create_train_state(jdet, CFG, tx, sample, seed=4)
    dstats = perturb_stats(to_numpy_tree(dstate.batch_stats),
                           np.random.RandomState(1))
    dstate = dstate.replace(batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                                               dstats))
    jbp = jboxpc.BoxPCFitNet(cfg=CFG)
    bstate = jsemi.create_boxpc_state(jbp, CFG, tx, sample, seed=5)
    bstats = perturb_stats(to_numpy_tree(bstate.batch_stats),
                           np.random.RandomState(2))
    bstate = bstate.replace(batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                                               bstats))
    for d, st in ((f"{jcfg.log_dir}/ckpt", dstate),
                  (str(tmp_path / "jax_bp"), bstate)):
        mgr = JCkpt(d)
        mgr.save(0, st)
        mgr.wait()
        mgr.close()

    ttx = tloop.make_optimizer(tsched.exponential_staircase_lr(batch_size=8))
    tdet = train_sup.build_model(tcfg, 4, CPU)
    bridge.load_flax_variables(tdet, to_numpy_tree(dstate.params), dstats)
    tbp = tboxpc.BoxPCFitNet(TCFG, device="cpu")
    bridge.load_flax_variables(tbp, to_numpy_tree(bstate.params), bstats)
    CheckpointManager(f"{tcfg.log_dir}/ckpt").save(
        0, tloop.create_train_state(tdet, ttx))
    CheckpointManager(str(tmp_path / "port_bp")).save(
        0, tsemi.create_boxpc_state(tbp, ttx))

    japs = jtest.evaluate(jcfg, str(tmp_path / "jres"),
                          boxpc_dir=str(tmp_path / "jax_bp"), boxpc_steps=2)
    taps = ttest.evaluate(tcfg, str(tmp_path / "tres"),
                          boxpc_dir=str(tmp_path / "port_bp"),
                          boxpc_steps=2, device=CPU)
    plain = ttest.evaluate(tcfg, str(tmp_path / "tplain"), device=CPU)
    jd = jtest.read_sunrgbd_results(str(tmp_path / "jres/detections.txt"))
    td = ttest.read_sunrgbd_results(str(tmp_path / "tres/detections.txt"))
    pd = ttest.read_sunrgbd_results(str(tmp_path / "tplain/detections.txt"))
    assert len(td) == len(jd) == len(pd) == 12
    for a, b in zip(td, jd):
        assert (a.frame_id, a.classname) == (b.frame_id, b.classname)
        np.testing.assert_allclose(a.center, b.center, rtol=0, atol=2e-4)
        np.testing.assert_allclose(a.size, b.size, rtol=0, atol=2e-4)
        np.testing.assert_allclose(a.heading, b.heading, rtol=0, atol=2e-4)
        np.testing.assert_allclose(a.score, b.score, rtol=1e-5, atol=2e-6)
    assert max(np.abs(a.center - b.center).max() for a, b in zip(td, pd)) > 0
    assert sorted(taps) == sorted(japs)
    for k in japs:
        np.testing.assert_allclose(taps[k], japs[k], rtol=0, atol=1e-6,
                                   err_msg=k)
    assert "boxpc refinement on (step 0, 2 iteration(s))" in (
        tmp_path / "tres" / "log_test.txt").read_text()
    assert sorted(plain) == sorted(taps)


# ---------------------------------------------------------------------------
# The driver
# ---------------------------------------------------------------------------

def _semisup_cfg(tmp_path, **kw):
    base = dict(model="frustum_pointnets_v1", num_point=64, num_channels=4,
                batch_size=8, max_epoch=1, max_steps=2, boxpc_epochs=1,
                synthetic_train=32, synthetic_val=16,
                log_dir=str(tmp_path / "log"), eval_every_epochs=1,
                ckpt_every_epochs=1,
                strong_classes=("bed", "table", "sofa", "chair"),
                weak_classes=("toilet", "desk"))
    base.update(kw)
    return train_semisup.SemisupConfig(**base)


def test_semisup_driver_smoke_and_phase_a_resume(tmp_path, monkeypatch):
    """tests/test_boxpc_semisup.py's driver smoke in the port: the files,
    the indexed diagnostic columns, the checkpoints of both phases, the
    JAX log lines; then phase A resumes from its checkpoint. The weak
    split (4 frustums) is smaller than a batch, so each weak batch is
    drawn with replacement from RandomState(seed + epoch), exactly."""
    cfg = _semisup_cfg(tmp_path, per_class_diag=True)
    weak_seen = []
    make = tsemi.make_semisup_train_step

    def recording(*a, **kw):
        step = make(*a, **kw)

        def wrapped(state, strong, weak):
            weak_seen.append(np.asarray(weak["points"]))
            return step(state, strong, weak)
        return wrapped

    monkeypatch.setattr(train_semisup.semisup, "make_semisup_train_step",
                        recording)
    out = train_semisup.train(cfg, device=CPU)
    assert out == {} or all(np.isfinite(v) for v in out.values())
    log = (tmp_path / "log" / "log_train.txt").read_text()
    assert "strong=16 weak=4 weak_val=2" in log
    assert "boxpc epoch 0: step=2 loss=" in log
    assert "epoch 0: step=2 sup=" in log and "frustums/s)" in log
    header = (tmp_path / "log" / "metrics_train.csv").read_text(
        ).splitlines()[0].split(",")
    assert "diag_trust_frac_0" in header
    assert f"diag_count_{NC - 1}" in header and "combined_loss" in header
    assert CheckpointManager(cfg.log_dir + "/ckpt").latest_step() == 2
    assert CheckpointManager(cfg.log_dir + "/boxpc_ckpt").latest_step() == 2

    _, weak_ds, _ = train_semisup.build_semisup_datasets(cfg)
    idxs = np.random.RandomState(cfg.seed).randint(0, len(weak_ds), 8)
    np.testing.assert_array_equal(weak_seen[0],
                                  weak_ds.get_batch(list(idxs))["points"])

    train_semisup.train(dataclasses.replace(cfg, boxpc_epochs=2),
                        device=CPU)
    log = (tmp_path / "log" / "log_train.txt").read_text()
    assert "boxpc: resumed from step 2" in log
    assert CheckpointManager(cfg.log_dir + "/boxpc_ckpt").latest_step() == 4


def test_semisup_driver_device_data_and_refusals(tmp_path):
    cfg = _semisup_cfg(tmp_path, synthetic_train=48, synthetic_val=64,
                       device_data=True,
                       max_points_device=256,
                       weak_classes=("toilet", "desk", "dresser"))
    out = train_semisup.train(cfg, device=CPU)
    assert np.isfinite(out.get("total_loss", 0.0))
    log = (tmp_path / "log" / "log_train.txt").read_text()
    assert "device-resident strong/weak datasets" in log
    assert "weak-val: iou3d_ge_025=" in log
    rows = (tmp_path / "log" / "metrics_weak_val.csv").read_text()
    assert rows.splitlines()[1].startswith("2,")
    for bad, why in ((dict(num_devices=3), "not divisible by 3 ranks"),
                     (dict(multihost=True), "launcher")):
        with pytest.raises(ValueError, match=why):
            train_semisup.train(dataclasses.replace(cfg, **bad), device=CPU)
    with pytest.raises(ValueError, match="fewer than a batch"):
        train_semisup.train(dataclasses.replace(
            cfg, strong_classes=("bed",), log_dir=str(tmp_path / "x")),
            device=CPU)


def test_semisup_and_refine_through_argv(tmp_path, monkeypatch):
    """`python -m ...train_semisup` with JAX's command line, then
    `...test --boxpc_refine <log_dir>/boxpc_ckpt`; the device resolves to
    the CPU here."""
    monkeypatch.setattr(train_semisup, "resolve_device", lambda d=None: CPU)
    monkeypatch.setattr(ttest, "resolve_device", lambda d=None: CPU)
    log_dir = tmp_path / "log"
    common = ["--num_point", "64", "--batch_size", "8", "--synthetic_train",
              "32", "--synthetic_val", "16", "--log_dir", str(log_dir)]
    monkeypatch.setattr(sys, "argv", ["train_semisup"] + common + [
        "--max_steps", "1", "--boxpc_epochs", "1", "--weak_classes",
        "toilet,desk", "--weak_weight", "0.5"])
    train_semisup.main()
    assert "'weak_weight': 0.5" in (log_dir / "log_train.txt").read_text()
    monkeypatch.setattr(sys, "argv", ["test"] + common + [
        "--result_dir", str(tmp_path / "r"), "--boxpc_refine",
        str(log_dir / "boxpc_ckpt"), "--boxpc_refine_steps", "2"])
    ttest.main()
    assert "boxpc refinement on (step 2, 2 iteration(s))" in (
        tmp_path / "r" / "log_test.txt").read_text()
    assert len(ttest.read_sunrgbd_results(
        str(tmp_path / "r" / "detections.txt"))) == 16
