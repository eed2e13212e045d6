"""The multi-task loss and the in-step metrics against the JAX package,
on random float32 end-points (derived from a raw box-head vector as the
model derives them), with and without `example_weights`.

Each loss term and metric to rtol 1e-5; the autograd gradients of
`total_loss` with respect to the box-head vector, the seg logits and
the stage-1 center against `jax.grad` to rtol 1e-4 (atol 1e-7 for the
entries whose gradient is zero).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import n
from transferable3d_tpu.core import bins as jbins
from transferable3d_tpu.models import model_util as jmu
from transferable3d_torch.core import bins as tbins
from transferable3d_torch.models import model_util as tmu

B, NPTS = 6, 32


def _inputs(seed):
    cfg = jbins.SUNRGBD
    nh, ns = cfg.num_heading_bin, cfg.num_size_cluster
    rng = np.random.RandomState(seed)
    center = rng.normal(0, 1, (B, 3)).astype(np.float32) + [0, 0, 5]
    labels = dict(
        seg=rng.randint(0, 2, (B, NPTS)),
        center=center.astype(np.float32),
        heading_class=rng.randint(0, nh, B),
        heading_residual=rng.uniform(-np.pi / nh, np.pi / nh,
                                     B).astype(np.float32),
        size_class=rng.randint(0, ns, B),
        size_residual=rng.normal(0, 0.1, (B, 3)).astype(np.float32))
    box = rng.normal(0, 0.5, (B, cfg.box_output_dim)).astype(np.float32)
    box[:, :3] = rng.normal(0, 0.2, (B, 3))
    inputs = dict(
        box=box,
        seg_logits=rng.normal(0, 1, (B, NPTS, 2)).astype(np.float32),
        stage1=(center + rng.normal(0, 0.3, (B, 3))).astype(np.float32))
    weights = rng.uniform(0, 1, B).astype(np.float32)
    weights[0] = 0.0
    return labels, inputs, weights, labels["size_class"]


def _jax_end_points(box, seg_logits, stage1):
    ep = jmu.parse_box_output(box, jbins.SUNRGBD)
    ep["seg_logits"], ep["stage1_center"] = seg_logits, stage1
    ep["center"] = ep["center_delta"] + stage1
    return ep


def _torch_end_points(box, seg_logits, stage1):
    ep = tmu.parse_box_output(box, tbins.SUNRGBD)
    ep["seg_logits"], ep["stage1_center"] = seg_logits, stage1
    ep["center"] = ep["center_delta"] + stage1
    return ep


@pytest.mark.parametrize("weighted", [False, True])
def test_get_loss_and_gradients(weighted):
    labels, inputs, weights, _ = _inputs(0)
    jl = jmu.Labels(**{k: jnp.asarray(v) for k, v in labels.items()})
    tl = tmu.Labels(**{k: torch.from_numpy(np.asarray(v))
                       for k, v in labels.items()})
    jw = jnp.asarray(weights) if weighted else None
    tw = torch.from_numpy(weights) if weighted else None

    def jloss(box, seg, st1):
        return jmu.get_loss(_jax_end_points(box, seg, st1), jl,
                            jbins.SUNRGBD, example_weights=jw)

    ref = jloss(*(jnp.asarray(inputs[k]) for k in ("box", "seg_logits",
                                                   "stage1")))
    targs = [torch.from_numpy(inputs[k]).requires_grad_(True)
             for k in ("box", "seg_logits", "stage1")]
    got = tmu.get_loss(_torch_end_points(*targs), tl, tbins.SUNRGBD,
                       example_weights=tw)
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(n(got[k]), np.asarray(ref[k]), rtol=1e-5,
                                   err_msg=k)
    grads_ref = jax.grad(lambda *a: jloss(*a)["total_loss"],
                         argnums=(0, 1, 2))(
        *(jnp.asarray(inputs[k]) for k in ("box", "seg_logits", "stage1")))
    got["total_loss"].backward()
    for a, g in zip(targs, grads_ref):
        np.testing.assert_allclose(n(a.grad), np.asarray(g), rtol=1e-4,
                                   atol=1e-7)


@pytest.mark.parametrize("known_class", [False, True])
def test_compute_metrics(known_class):
    labels, inputs, _, class_idx = _inputs(1)
    jl = jmu.Labels(**{k: jnp.asarray(v) for k, v in labels.items()})
    tl = tmu.Labels(**{k: torch.from_numpy(np.asarray(v))
                       for k, v in labels.items()})
    # Near-correct boxes so that the IoUs are not all zero.
    box = inputs["box"]
    box[:, :3] = labels["center"] - inputs["stage1"]
    ref = jmu.compute_metrics(
        _jax_end_points(*(jnp.asarray(v) for v in (box, inputs["seg_logits"],
                                                   inputs["stage1"]))),
        jl, jbins.SUNRGBD,
        class_idx=jnp.asarray(class_idx) if known_class else None)
    got = tmu.compute_metrics(
        _torch_end_points(*(torch.from_numpy(v)
                            for v in (box, inputs["seg_logits"],
                                      inputs["stage1"]))),
        tl, tbins.SUNRGBD,
        class_idx=torch.from_numpy(class_idx) if known_class else None)
    assert sorted(got) == sorted(ref)
    assert float(ref["iou3d_mean"]) > 0
    for k in ref:
        np.testing.assert_allclose(n(got[k]), np.asarray(ref[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)


def test_huber_and_cross_entropy():
    rng = np.random.RandomState(4)
    err = rng.normal(0, 2, (5, 7)).astype(np.float32)
    np.testing.assert_allclose(
        n(tmu.huber_loss(torch.from_numpy(err), 1.0)),
        np.asarray(jmu.huber_loss(jnp.asarray(err), 1.0)), rtol=1e-6)
    logits = rng.normal(0, 2, (5, 7, 3)).astype(np.float32)
    lab = rng.randint(0, 3, (5, 7))
    np.testing.assert_allclose(
        n(tmu.int_cross_entropy(torch.from_numpy(logits),
                                torch.from_numpy(lab))),
        np.asarray(jmu.int_cross_entropy(jnp.asarray(logits),
                                         jnp.asarray(lab))), rtol=1e-6)


def test_box3d_corners_grid():
    _, inputs, _, _ = _inputs(5)
    center = inputs["stage1"]
    ref = jmu.get_box3d_corners_grid(
        jnp.asarray(center),
        jmu.parse_box_output(jnp.asarray(inputs["box"]), jbins.SUNRGBD),
        jbins.SUNRGBD)
    got = tmu.get_box3d_corners_grid(
        torch.from_numpy(center),
        tmu.parse_box_output(torch.from_numpy(inputs["box"]), tbins.SUNRGBD),
        tbins.SUNRGBD)
    np.testing.assert_allclose(n(got), np.asarray(ref), rtol=1e-5, atol=1e-5)
