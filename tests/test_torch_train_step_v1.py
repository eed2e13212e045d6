"""Train steps of F-PointNet v1 on an end-to-end batch: the port's
`make_train_step` against the JAX one, from bridged weights, with the
JAX steps' dropout masks injected (`torch_parity.run_train_steps`,
family "v1").

The batch is what the depth pipeline emits: 2 frames x (2 boxes + 1
zero-area padding box) of a synthetic 120x160 depth scene, 256 points per
frustum, 3 channels, from the JAX `scene_to_train_batch`; both sides get
the same numpy arrays. The step is the end-to-end one:
`StepConfig(compute_iou_metrics=False, use_valid_weights=True)`, so the
two padded frustums (all-zero points, `valid` False) weigh nothing in
the loss. 64 object points.

float32, two steps, each held on its own: the first from the initial
weights, the second from the state JAX's first step leaves (bridged
again). Run back to back instead, the port's second step is 4.7e-3 away
in total loss and 0.44 in gradient (seg loss 2e-6): Adam's first update
moves every entry by lr * sign(g), the T-Net's and box net's small
gradient entries are sums that cancel, so their signs differ between
two float32 programs, and BatchNorm over 4 frustums spreads that.
Tolerances:
* every loss term to rtol 3e-4 (measured 2.1e-4 on the heading
  residual at step 1: the JAX masking rebuilds the object points from
  bf16 hi + lo parts, and the heads' BatchNorm runs over 4 valid
  frustums), the predicted masks equal;
* gradients: concatenated relative L2 <= 1e-2, cosine >= 0.9999, every
  leaf <= 3e-2 (the limits of tests/test_torch_train_step.py); the
  leaves that are zero in exact arithmetic (the Dense biases in front
  of a train-mode BN, `mlp3_point`'s among them:
  `torch_parity.zero_gradient_leaves`) are noise on both sides. The BN
  biases before the global pools are not among them here: the padded
  frustums' pooled features do not pass the ReLU as the others' do;
* after step 1, the new parameters: each entry within 1.01 LR of the
  old one, and entries off by more than rtol 1e-4 / atol 1e-3 LR (Adam
  sign flips of noise-sized gradients) at most 1% of the rest;
* BN running statistics to 1e-4 of each leaf's largest value, 1e-3
  after the masking (tests/test_torch_v1.py says why).

bfloat16, one step, foreground bias raised by 5: per-net cosine limits
set from readings, and a witness against JAX's float32 gradient, as
tests/test_torch_train_step_bf16.py does.
"""

import jax
import numpy as np
import pytest

from test_torch_depth_pipeline import _scenes
from test_torch_train_step_bf16 import _net_cos
from torch_parity import STEP_LOSS_KEYS, run_train_steps, split_noise_grads
from transferable3d_tpu.core import bins as jbins
from transferable3d_tpu.data import depth_pipeline as jdp

NPOINTS = 256
E2E = dict(compute_iou_metrics=False, use_valid_weights=True)
# Cosine limits against JAX in bf16 (measured 0.898, 0.995, 0.894, 0.926).
COS_LIMITS = {"all": 0.85, "seg_net": 0.98, "tnet": 0.8, "box_net": 0.88}


def e2e_batch():
    (_, _, scene), _ = _scenes(0)
    batch = jdp.scene_to_train_batch(scene, jax.random.PRNGKey(0), NPOINTS,
                                     jbins.SUNRGBD)
    batch = {k: np.array(v) for k, v in batch.items()}
    assert batch["points"].shape == (6, NPOINTS, 3)
    assert batch["valid"].tolist() == [True, True, False] * 2
    return batch


@pytest.mark.parametrize("warmup", [0, 1], ids=["step1", "step2"])
def test_v1_train_step_f32_on_an_e2e_batch(monkeypatch, warmup):
    """Measured on the CPU: step 1 gradient relative L2 6.9e-3, cosine
    0.999986, worst leaf 9.7e-3 (tnet/mlp/bn_2/bias), 1,221 of 1,647,368
    new-parameter entries off by an Adam sign flip; step 2 3.7e-3,
    0.999994, 1.1e-2 (box_net/mlp/bn_2/bias)."""
    res = run_train_steps("float32", monkeypatch, family="v1",
                          batch=e2e_batch(), step_cfg=E2E,
                          warmup_steps=warmup)
    jm, tm = res["jax_metrics"], res["port_metrics"]
    assert "iou3d_mean" not in tm and "iou3d_mean" not in jm
    for k in STEP_LOSS_KEYS:
        np.testing.assert_allclose(tm[k], jm[k], rtol=3e-4, err_msg=k)
    for k in ("lr", "bn_momentum"):
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-6, err_msg=k)
    pairs, noise = split_noise_grads(res, pooled=False, n_noise=20)
    assert "seg_net/mlp3_point/bias" in noise
    jg = np.concatenate([a.ravel() for a, _ in pairs.values()])
    tg = np.concatenate([b.ravel() for _, b in pairs.values()])
    rel = np.linalg.norm(tg - jg) / np.linalg.norm(jg)
    cos = jg @ tg / (np.linalg.norm(jg) * np.linalg.norm(tg))
    worst = max((np.linalg.norm(b - a) / max(np.linalg.norm(a), 1e-30), p)
                for p, (a, b) in pairs.items())
    print(f"gradient: rel L2 {rel:.3g}, cosine {cos:.6f}, worst leaf "
          f"{worst[1]} {worst[0]:.3g}")
    assert rel <= 1e-2 and cos >= 0.9999
    assert worst[0] <= 3e-2, worst
    js, ts = res["jax_stats"], res["port_stats"]
    assert sorted(js) == sorted(ts)
    for p in js:
        tol = 1e-4 if p.startswith("seg_net") else 1e-3
        np.testing.assert_allclose(ts[p], js[p], rtol=tol,
                                   atol=tol * np.abs(js[p]).max(),
                                   err_msg=p)
    if warmup:
        return  # the port's Adam moments started at zero
    jp, tp, lr = res["jax_params"], res["port_params"], res["lr"]
    p0 = res["old_params"]
    flipped = total = 0
    for p in jp:
        for side in (jp, tp):
            assert np.abs(side[p] - p0[p]).max() <= 1.01 * lr, p
        if p in noise:
            continue
        off = ~np.isclose(tp[p], jp[p], rtol=1e-4, atol=1e-3 * lr)
        flipped += int(off.sum())
        total += off.size
    print(f"new-parameter entries off by an Adam sign flip: {flipped} of "
          f"{total}")
    assert flipped <= 1e-2 * total, (flipped, total)


def test_v1_padded_frustums_weigh_nothing(monkeypatch):
    """With `use_valid_weights` the loss ignores the padded frustums'
    labels: changing them changes no loss term. Without it, it does."""
    from torch_parity import port_train_step

    res = run_train_steps("float32", monkeypatch, family="v1",
                          batch=e2e_batch(), step_cfg=E2E, jax_update=False)
    params0, stats0, batch, keep, nobj = res["inputs"]
    other = dict(batch)
    other["center"] = batch["center"] + np.where(
        batch["valid"][:, None], 0.0, 3.0).astype(np.float32)
    other["seg"] = np.where(batch["valid"][:, None], batch["seg"], 0)
    for cfg, same in ((E2E, True), (dict(compute_iou_metrics=False), False)):
        a, b = (port_train_step("float32", params0, stats0, bt, keep, nobj,
                                monkeypatch, family="v1",
                                step_cfg=cfg)["port_metrics"]
                for bt in (batch, other))
        assert (a["total_loss"] == b["total_loss"]) == same, cfg
    np.testing.assert_allclose(res["port_metrics"]["total_loss"],
                               res["jax_metrics"]["total_loss"], rtol=1e-4)


def test_v1_train_step_bf16_on_an_e2e_batch(monkeypatch):
    """Measured on the CPU: cosines against JAX bf16 0.898 (seg 0.995,
    T-Net 0.894, box 0.926); against JAX's float32 gradient the port's
    bf16 gradient has 0.892 (0.970, 0.915, 0.756) where JAX's own bf16
    gradient has 0.813 (0.967, 0.824, 0.750)."""
    res = run_train_steps("bfloat16", monkeypatch, family="v1",
                          batch=e2e_batch(), step_cfg=E2E, mask_margin=5.0,
                          f32_witness=True)
    jm, tm = res["jax_metrics"], res["port_metrics"]
    for k in ("total_loss", "seg_loss"):
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-2, err_msg=k)
    assert all(np.isfinite(v) for v in tm.values())
    pairs, _ = split_noise_grads(res, bound=None, pooled=False,
                                 n_noise=20)
    for p, (a, b) in pairs.items():
        assert np.isfinite(b).all(), p
        assert (np.abs(b).max() > 0) == (np.abs(a).max() > 0), p
    jg, tg, j32 = res["jax_grads"], res["port_grads"], res["jax_f32_grads"]
    for net, limit in COS_LIMITS.items():
        cos = _net_cos(tg, jg, pairs, net)
        port_f32, jax_f32 = (_net_cos(g, j32, pairs, net) for g in (tg, jg))
        print(f"{net}: port vs JAX bf16 {cos:.3f}; vs JAX f32: port "
              f"{port_f32:.3f}, JAX bf16 {jax_f32:.3f}")
        assert cos >= limit, (net, cos)
        assert port_f32 >= jax_f32 - 0.1, (net, port_f32, jax_f32)
