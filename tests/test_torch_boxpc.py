"""The port's BoxPC (models/boxpc.py) and phase A of the transfer loop
(train/semisup.py: the shape aug and `make_boxpc_train_step`) against
the JAX package, from the same numpy inputs and bridged weights, on the
CPU. Mirrors tests/test_boxpc_semisup.py.

JAX's random streams cannot be reproduced in torch: the tests feed the
port's pure functions (`perturbed_from_draws`, `shape_aug_from_draws`)
JAX's own draws, and the phase-A step JAX's draws and dropout masks (the
masks read from the head's `dp_i` / `bn_i` intermediates).

Tolerances:
* canonicalized points within 2e-6 (rotation products of |x| <= 4 m),
  the inside indicator equal;
* the forward in eval mode within rtol 1e-4, atol 1e-5 (four f32 layers
  and a max-pool over 128 points);
* the perturbation and the aug from JAX's draws: centers and headings
  equal bit for bit, sizes within 2 ulp (XLA's and torch's exp differ
  in the last bit on some inputs, and a product follows), the aug's points within 2e-6, and
  `apply_deltas`, `boxpc_targets` (IoU labels equal) and `boxpc_loss`
  within 1e-5;
* one phase-A step: every loss term within rtol 1e-5 (the fit accuracy
  and positive fraction equal), the gradient (without the biases that
  are zero in exact arithmetic) within relative L2 1e-4 and cosine
  0.99999, every such leaf within 1e-3 (measured 2.2e-6 and 2.8e-6), the BN running statistics within
  1e-5 of each leaf's largest value, and the new parameters as the v1
  step tests hold them (Adam's first update is lr * sign(g): entries off
  by more than rtol 1e-4 / atol 1e-3 LR at most 1%).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (init_flax, one_torch_thread,  # noqa: F401
                          to_numpy_tree, tree_leaves, zero_gradient_leaves)
from transferable3d_tpu.core import bins as jbins
from transferable3d_tpu.data import synthetic as jsyn
from transferable3d_tpu.data.provider import FrustumDataset as JDataset
from transferable3d_tpu.models import boxpc as jboxpc
from transferable3d_tpu.train import schedules as jsched
from transferable3d_tpu.train import semisup as jsemi
from transferable3d_tpu.train import train_loop as jloop
from transferable3d_torch.core import bins as tbins
from transferable3d_torch.models import boxpc as tboxpc
from transferable3d_torch.models import layers as tlayers
from transferable3d_torch.models import registry
from transferable3d_torch.train import schedules as tsched
from transferable3d_torch.train import semisup as tsemi
from transferable3d_torch.train import train_loop as tloop
from transferable3d_torch.utils import bridge

pytestmark = pytest.mark.usefixtures("one_torch_thread")
CFG = jbins.SUNRGBD


def strong_batch(n=8, npoints=128, seed=0):
    recs = jsyn.make_dataset(n, CFG, seed=seed, n_object=150, n_clutter=60)
    return JDataset(recs, CFG, npoints=npoints, rotate_to_center=True,
                    seed=seed).get_batch(list(range(n)))


def random_boxes(rng, n):
    return (rng.uniform(-2, 2, (n, 3)).astype(np.float32),
            rng.uniform(0.5, 3, (n, 3)).astype(np.float32),
            rng.uniform(-np.pi, np.pi, n).astype(np.float32))


def jbox(c, s, h):
    return jboxpc.BoxParams(jnp.asarray(c), jnp.asarray(s), jnp.asarray(h))


def tbox(c, s, h):
    return tboxpc.BoxParams(*(torch.from_numpy(np.asarray(x))
                              for x in (c, s, h)))


def np_box(box):
    return [np.asarray(x.detach().numpy() if torch.is_tensor(x) else x)
            for x in box]


def assert_box_equal(got, want):
    """Centers and headings bit for bit, sizes (through exp) within 2
    ulp."""
    (gc, gs, gh), (wc, ws, wh) = np_box(got), np_box(want)
    np.testing.assert_array_equal(gc, wc)
    np.testing.assert_array_equal(gh, wh)
    np.testing.assert_array_max_ulp(gs, ws, maxulp=2)


def bridged_boxpc(batch, seed=0):
    """(flax params, perturbed stats, port BoxPC on the CPU with them)."""
    jm = jboxpc.BoxPCFitNet(cfg=CFG)
    gt = jsemi.gt_boxes_from_batch(batch, CFG)
    params, stats = init_flax(jm, seed, batch["points"], gt, train=False)
    model = tboxpc.BoxPCFitNet(tbins.SUNRGBD, device="cpu")
    bridge.load_flax_variables(model, params, stats)
    return jm, params, stats, model.eval()


def test_canonicalize_points_equal_jax():
    rng = np.random.RandomState(0)
    c, s, h = random_boxes(rng, 6)
    pts = rng.uniform(-4, 4, (6, 200, 3)).astype(np.float32)
    want = np.asarray(jboxpc.canonicalize_points(jnp.asarray(pts),
                                                 jbox(c, s, h)))
    got = tboxpc.canonicalize_points(torch.from_numpy(pts),
                                     tbox(c, s, h)).numpy()
    assert got.shape == want.shape == (6, 200, 7)
    np.testing.assert_array_equal(got[..., 6], want[..., 6])
    assert 0 < want[..., 6].mean() < 1
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


def test_boxpc_registry_and_flax_tree():
    """`boxpc_fit` in the registry; `register` adds a name; the flax tree
    maps onto the module one leaf to one entry, and back."""
    assert "boxpc_fit" in registry.available()
    model = registry.get_model("boxpc_fit", tbins.SUNRGBD, device="cpu")
    assert isinstance(model, tboxpc.BoxPCFitNet)
    assert model.head.dropout_rate == 0.3
    assert all(p.dtype == torch.float32 for p in model.parameters())

    @registry.register("boxpc_fit_test_alias")
    def alias(cfg, **kw):
        return tboxpc.BoxPCFitNet(cfg, **kw)

    try:
        assert registry.get_model("boxpc_fit_test_alias", tbins.SUNRGBD,
                                  device="cpu").head.out.weight.shape == (
                                      8, 128)
    finally:
        registry._REGISTRY.pop("boxpc_fit_test_alias")
    batch = strong_batch(4, 64)
    _, params, stats, model = bridged_boxpc(batch)
    back_p, back_s = bridge.state_dict_to_flax(model)
    assert tree_leaves(back_p).keys() == tree_leaves(params).keys()
    for k, v in tree_leaves(back_s).items():
        np.testing.assert_array_equal(v, tree_leaves(stats)[k])


def test_boxpc_forward_eval_equal_jax():
    batch = strong_batch()
    jm, params, stats, model = bridged_boxpc(batch)
    rng = np.random.RandomState(1)
    gt = [np.asarray(x) for x in jsemi.gt_boxes_from_batch(batch, CFG)]
    box = (gt[0] + rng.normal(0, 0.2, gt[0].shape).astype(np.float32),
           gt[1] * np.exp(rng.uniform(-0.3, 0.3, gt[1].shape)).astype(
               np.float32), gt[2] + rng.normal(0, 0.3, 8).astype(np.float32))
    want = jax.jit(lambda p, s, x, b: jm.apply(
        {"params": p, "batch_stats": s}, x, b, train=False))(
            params, stats, batch["points"], jbox(*box))
    with torch.no_grad():
        got = model(torch.from_numpy(batch["points"]), tbox(*box))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


def _jax_perturbation_draws(key, b):
    r0, r1, r2, r3 = jax.random.split(key, 4)
    return (jax.random.uniform(r0, (b,)), jax.random.normal(r1, (b, 3)),
            jax.random.uniform(r2, (b, 3), minval=-1.0, maxval=1.0),
            jax.random.normal(r3, (b,)))


def _jax_aug_draws(key, b, log_range):
    r1, r2 = jax.random.split(key)
    return (jax.random.uniform(r1, (b, 3), minval=-log_range,
                               maxval=log_range),
            jax.random.uniform(r2, (b,)))


def _t(draws):
    return [torch.from_numpy(np.array(d)) for d in draws]


@pytest.mark.parametrize("fracs", [(0.5, 0.25), (0.2, 0.6)])
def test_perturbation_from_jax_draws_is_exact(fracs):
    """`perturbed_from_draws` on JAX's draws is JAX's
    `sample_perturbed_boxes` (sizes within 2 ulp: exp); then `boxpc_targets` and
    `apply_deltas` (which restores the GT box) as in JAX."""
    rng = np.random.RandomState(1)
    n = 64
    gt = random_boxes(rng, n)
    key = jax.random.PRNGKey(3)
    want = jboxpc.sample_perturbed_boxes(key, jbox(*gt), *fracs)
    got = tboxpc.perturbed_from_draws(
        tbox(*gt), *_t(_jax_perturbation_draws(key, n)), *fracs)
    assert_box_equal(got, want)
    # the three arms all occur
    u = np.asarray(_jax_perturbation_draws(key, n)[0])
    assert (u < fracs[0]).any() and (u >= 1 - fracs[1]).any()
    assert ((u >= fracs[0]) & (u < 1 - fracs[1])).any()

    jt = jboxpc.boxpc_targets(want, jbox(*gt))
    tt = tboxpc.boxpc_targets(got, tbox(*gt))
    np.testing.assert_array_equal(tt["fit_label"].numpy(),
                                  np.asarray(jt["fit_label"]))
    assert 0 < float(jt["fit_label"].mean()) < 1
    for k in jt:
        np.testing.assert_allclose(tt[k].numpy(), np.asarray(jt[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    restored = tboxpc.apply_deltas(got, tt)
    for a, b in zip(np_box(restored), gt):
        np.testing.assert_allclose(a, b, atol=1e-4)
    deltas = {k: rng.normal(0, 1.5, np.shape(jt[k])).astype(np.float32)
              for k in ("delta_center", "delta_heading", "delta_size")}
    jr = jboxpc.apply_deltas(want, {k: jnp.asarray(v)
                                    for k, v in deltas.items()})
    tr = tboxpc.apply_deltas(got, {k: torch.from_numpy(v)
                                   for k, v in deltas.items()})
    for a, b in zip(np_box(tr), np_box(jr)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    assert float(np.abs(deltas["delta_size"]).max()) > 2.0  # the clamp


def test_boxpc_loss_equal_jax():
    rng = np.random.RandomState(2)
    b = 16
    out = {"fit_logit": rng.normal(0, 3, b), "delta_center":
           rng.normal(0, 1, (b, 3)), "delta_heading": rng.normal(0, 1, b),
           "delta_size": rng.normal(0, 1, (b, 3))}
    tgt = {"fit_label": (rng.rand(b) < 0.5), "delta_center":
           rng.normal(0, 1, (b, 3)), "delta_heading": rng.normal(0, 2, b),
           "delta_size": rng.normal(0, 1, (b, 3))}
    out = {k: np.float32(v) for k, v in out.items()}
    tgt = {k: np.float32(v) for k, v in tgt.items()}
    want = jboxpc.boxpc_loss({k: jnp.asarray(v) for k, v in out.items()},
                             {k: jnp.asarray(v) for k, v in tgt.items()})
    got = tboxpc.boxpc_loss({k: torch.from_numpy(v) for k, v in out.items()},
                            {k: torch.from_numpy(v) for k, v in tgt.items()})
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)


def test_shape_aug_from_jax_draws_is_exact():
    rng = np.random.RandomState(5)
    n, npts = 8, 64
    gt = random_boxes(rng, n)
    pts = rng.uniform(-4, 4, (n, npts, 4)).astype(np.float32)
    key = jax.random.PRNGKey(0)
    jp, jg = jsemi.anisotropic_shape_aug(key, jnp.asarray(pts), jbox(*gt),
                                         log_range=0.8, frac=0.5)
    s_log, u_on = _t(_jax_aug_draws(key, n, 0.8))
    assert 0 < float((u_on < 0.5).float().mean()) < 1
    tp, tg = tsemi.shape_aug_from_draws(torch.from_numpy(pts), tbox(*gt),
                                        s_log, u_on, frac=0.5)
    np.testing.assert_array_equal(tp[..., 3].numpy(), pts[..., 3])
    assert_box_equal(tg, jg)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0,
                               atol=2e-6)
    # the canonical coordinates and the inside mask are invariant
    f0 = tboxpc.canonicalize_points(torch.from_numpy(pts[..., :3]),
                                    tbox(*gt))
    f1 = tboxpc.canonicalize_points(tp[..., :3], tg)
    np.testing.assert_allclose(f1[..., :3].numpy(), f0[..., :3].numpy(),
                               atol=1e-4)
    np.testing.assert_array_equal(f1[..., 6].numpy(), f0[..., 6].numpy())


def test_draws_are_on_the_generator_and_reproducible():
    gen = torch.Generator().manual_seed(4)
    a = tboxpc.perturbation_draws(gen, 5) + tsemi.shape_aug_draws(gen, 5)
    gen.manual_seed(4)
    b = tboxpc.perturbation_draws(gen, 5) + tsemi.shape_aug_draws(gen, 5)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    u, n_c, u_s, n_h = a[:4]
    assert u.shape == (5,) and n_c.shape == (5, 3) and n_h.shape == (5,)
    assert float(u_s.min()) >= -1 and float(u_s.max()) < 1
    assert float(a[4].abs().max()) <= 0.8
    gt = tbox(*random_boxes(np.random.RandomState(0), 5))
    gen.manual_seed(4)
    box = tboxpc.sample_perturbed_boxes(gen, gt)
    for x, y in zip(box, tboxpc.perturbed_from_draws(gt, *a[:4])):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# One phase-A step
# ---------------------------------------------------------------------------

_HEAD = ("dp_0", "dp_1", "bn_0", "bn_1")


def _jax_boxpc_step(batch, aniso):
    """JAX's phase-A step from `create_boxpc_state` (BN statistics
    perturbed), its gradient and the head's dropout keep masks, and the
    step's draws. Returns a dict of numpy trees."""
    jm = jboxpc.BoxPCFitNet(cfg=CFG)
    b = len(batch["points"])
    lr = jsched.exponential_staircase_lr(base_lr=1e-3, batch_size=b)
    bn = jsched.bn_momentum_schedule(batch_size=b)
    tx = jloop.make_optimizer(lr)
    state = jsemi.create_boxpc_state(jm, CFG, tx, batch, seed=0)
    _, stats = init_flax(jm, 0, batch["points"],
                         jsemi.gt_boxes_from_batch(batch, CFG), train=False)
    state = state.replace(batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                                             stats))
    params0 = to_numpy_tree(state.params)
    rng = jax.random.fold_in(state.rng, state.step)
    sample_rng, dropout_rng, aug_rng = jax.random.split(rng, 3)

    def loss_fn(params):
        gt = jsemi.gt_boxes_from_batch(batch, CFG)
        points = jnp.asarray(batch["points"])
        if aniso > 0:
            points, gt = jsemi.anisotropic_shape_aug(aug_rng, points, gt,
                                                     log_range=aniso)
        perturbed = jboxpc.sample_perturbed_boxes(sample_rng, gt)
        targets = jboxpc.boxpc_targets(perturbed, gt)
        out, upd = jm.apply(
            {"params": params, "batch_stats": state.batch_stats}, points,
            perturbed, train=True, bn_momentum=bn(state.step),
            rngs={"dropout": dropout_rng},
            mutable=["batch_stats", "intermediates"],
            capture_intermediates=lambda mdl, _: mdl.name in _HEAD)
        losses = jboxpc.boxpc_loss(out, targets)
        head = upd["intermediates"]["head"]
        return losses["total_loss"], {k: head[k]["__call__"][0]
                                      for k in _HEAD}

    grads, inter = jax.jit(jax.grad(loss_fn, has_aux=True))(state.params)
    keep = [torch.from_numpy((np.asarray(inter[f"dp_{i}"]) != 0)
                             | (np.maximum(np.asarray(inter[f"bn_{i}"]), 0)
                                == 0)) for i in range(2)]
    jstep = jsemi.make_boxpc_train_step(jm, CFG, tx, bn, aniso_aug=aniso)
    new_state, metrics = jstep(state, batch)
    return {
        "params0": params0, "stats0": stats,
        "grads": tree_leaves(to_numpy_tree(grads)),
        "params": tree_leaves(to_numpy_tree(new_state.params)),
        "stats": tree_leaves(to_numpy_tree(new_state.batch_stats)),
        "metrics": {k: float(v) for k, v in metrics.items()},
        "keep": keep, "lr": float(lr(0)),
        "sample": _t(_jax_perturbation_draws(sample_rng, b)),
        "aug": _t(_jax_aug_draws(aug_rng, b, aniso)),
    }


def boxpc_noise_leaves(paths):
    """The leaves whose phase-A gradient is zero in exact arithmetic: the
    Dense biases in front of a train-mode BN, and the last point-MLP BN
    bias (it shifts every pooled feature alike where the ReLU passes,
    and the head's first train-mode BN removes such a shift)."""
    return zero_gradient_leaves(paths, pooled=False) + ["mlp/bn_3/bias"]


@pytest.mark.parametrize("aniso", [0.8, 0.0])
def test_boxpc_train_step_equal_jax(monkeypatch, aniso):
    """Measured on the CPU: gradient relative L2 2.2e-6, cosine
    0.99999994, worst leaf 2.8e-6; 3 (aniso 0.8) and 0 (aniso 0) of
    147,144 new-parameter entries off by an Adam sign flip."""
    batch = strong_batch(n=16, npoints=128, seed=0)
    j = _jax_boxpc_step(batch, aniso)
    model = tboxpc.BoxPCFitNet(tbins.SUNRGBD, device="cpu")
    bridge.load_flax_variables(model, j["params0"], j["stats0"])
    b = len(batch["points"])
    tstate = tsemi.create_boxpc_state(
        model, tloop.make_optimizer(tsched.exponential_staircase_lr(
            base_lr=1e-3, batch_size=b)), generator=torch.Generator())
    masks = list(j["keep"])
    monkeypatch.setattr(tboxpc, "perturbation_draws",
                        lambda gen, n: j["sample"])
    monkeypatch.setattr(tsemi, "shape_aug_draws",
                        lambda gen, n, lr: j["aug"])
    monkeypatch.setattr(tlayers, "dropout_keep_mask",
                        lambda shape, rate, gen: masks.pop(0))
    step = tsemi.make_boxpc_train_step(
        tbins.SUNRGBD, tsched.bn_momentum_schedule(batch_size=b),
        aniso_aug=aniso)
    tstate, tmet = step(tstate, batch)
    assert masks == [] and tstate.step == 1
    jm = j["metrics"]
    assert sorted(tmet) == sorted(jm)
    for k in ("fit_accuracy", "pos_fraction"):
        assert float(tmet[k]) == jm[k], k
    assert 0 < jm["pos_fraction"] < 1
    for k in jm:
        np.testing.assert_allclose(float(tmet[k]), jm[k], rtol=1e-5,
                                   err_msg=k)

    tg = tree_leaves(bridge.grads_to_flax(model))
    jg = j["grads"]
    assert sorted(tg) == sorted(jg)
    noise = boxpc_noise_leaves(jg)
    assert len(noise) == 7
    scale = max(np.abs(g).max() for g in jg.values())
    for p in noise:
        assert np.abs(jg[p]).max() <= 1e-4 * scale, p
        assert np.abs(tg[p]).max() <= 1e-4 * scale, p
    keys = [p for p in jg if p not in noise]
    a = np.concatenate([jg[p].ravel() for p in keys])
    t = np.concatenate([tg[p].ravel() for p in keys])
    rel = np.linalg.norm(t - a) / np.linalg.norm(a)
    cos = a @ t / (np.linalg.norm(a) * np.linalg.norm(t))
    worst = max((np.linalg.norm(tg[p] - jg[p]) / np.linalg.norm(jg[p]), p)
                for p in keys)
    print(f"phase-A gradient: rel L2 {rel:.3g}, cosine {cos:.8f}, worst "
          f"leaf {worst}")
    assert rel <= 1e-4 and cos >= 0.99999 and worst[0] <= 1e-3, worst

    tparams, tstats = (tree_leaves(x) for x in
                       bridge.state_dict_to_flax(model))
    for p, v in j["stats"].items():
        np.testing.assert_allclose(tstats[p], v, rtol=0,
                                   atol=1e-5 * np.abs(v).max(), err_msg=p)
    p0, lr = tree_leaves(j["params0"]), j["lr"]
    off = total = 0
    for p in keys:
        assert np.abs(tparams[p] - p0[p]).max() <= 1.01 * lr, p
        bad = ~np.isclose(tparams[p], j["params"][p], rtol=1e-4,
                          atol=1e-3 * lr)
        off += int(bad.sum())
        total += bad.size
    print(f"new-parameter entries off by an Adam sign flip: {off} of {total}")
    assert off <= 1e-2 * total


def test_boxpc_step_draws_sample_dropout_aug_in_order(monkeypatch):
    """The port's step takes its numbers from the state's generator in
    JAX's key order: the perturbation, the dropout generator's seed, the
    aug; with `aniso_aug` 0 the aug draws nothing. Two states from one
    seed take identical steps."""
    batch = strong_batch(n=8, npoints=64, seed=1)
    calls = []
    for mod, name, tag in ((tboxpc, "perturbation_draws", "sample"),
                           (tsemi, "fork_generator", "dropout"),
                           (tsemi, "shape_aug_draws", "aug")):
        def spy(*a, _fn=getattr(mod, name), _tag=tag, **kw):
            calls.append(_tag)
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, name, spy)
    results = []
    for aniso in (0.8, 0.8, 0.0):
        model = tboxpc.BoxPCFitNet(tbins.SUNRGBD, device="cpu")
        state = tsemi.create_boxpc_state(
            model, tloop.make_optimizer(
                tsched.exponential_staircase_lr(batch_size=8)), seed=3)
        step = tsemi.make_boxpc_train_step(
            tbins.SUNRGBD, tsched.bn_momentum_schedule(batch_size=8),
            aniso_aug=aniso)
        results.append(step(state, batch)[1])
    assert calls == ["sample", "dropout", "aug"] * 2 + ["sample", "dropout"]
    assert {k: float(v) for k, v in results[0].items()} == {
        k: float(v) for k, v in results[1].items()}
    assert all(np.isfinite(float(v)) for v in results[2].values())


def test_boxpc_train_mode_requires_a_generator():
    model = tboxpc.BoxPCFitNet(tbins.SUNRGBD, device="cpu").train()
    box = tbox(*random_boxes(np.random.RandomState(0), 4))
    with pytest.raises(ValueError, match="torch.Generator"):
        model(torch.zeros(4, 32, 3), box)
    out = model(torch.randn(4, 32, 3), box,
                generator=torch.Generator().manual_seed(0))
    assert out["delta_center"].shape == (4, 3)
