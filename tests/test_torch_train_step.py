"""One float32 train step of F-PointNet v2: the port's `make_train_step`
against the JAX `make_train_step`, from bridged weights, with the JAX
step's dropout mask injected, on 4 synthetic frustums of 256 points (64
object points); see `torch_parity.run_train_steps`.

Tolerances:
* every loss term to rtol 1e-4 and the predicted masks identical;
* gradients: the concatenated gradient to relative L2 error <= 1e-2 and
  cosine >= 0.9999; each leaf to relative L2 error <= 3e-2. A per-leaf
  1e-3 does not hold: small leaves such as a BN scale in the first SA
  scale (|g| ~0.07 next to leaves of ~100) are sums of large terms that
  cancel. A float64 run of both packages on the same step (JAX with x64
  and every float32 of the package taken as float64, the port in
  double; the two agree to 3.1e-8 on every leaf) shows which side is
  off. Against it the port's float32 gradient is off by 7.3e-4 overall
  and JAX's by 4.3e-3. The leaves that set the gap between the two
  (seg_net/sa1/mlp_0/bn_0/scale, 1.4e-2) are JAX's rounding: there the
  port is off by 1.1e-5 and JAX by 1.4e-2. On the T-Net head the port is
  the one further off (tnet/head/out/bias: 1.5e-2 against JAX's
  6.7e-4): that gradient is a sum over the box net's input gradients
  that cancels to about 2e-4 of their magnitudes, and the port's
  per-point input gradient is off by 4.8e-5. The worst leaf against
  float64 is the same on both sides (seg_net/sa1/mlp_1/bn_0/bias: port
  3.26e-2, JAX 3.27e-2), so the port is no further off than JAX there,
  and the bound between the two stays 3e-2;
* the gradients that are zero in exact arithmetic
  (`torch_parity.zero_gradient_leaves`) must be rounding noise on both
  sides (at most 1e-4 of the largest gradient entry);
* new parameters to rtol 1e-4 (atol 1e-3 of the LR). Adam's first
  step is about lr * sign(g), so an entry whose gradient is rounding
  noise (all of a zero-gradient leaf, and a few entries elsewhere) can
  move by the LR in opposite directions on the two sides; the test
  bounds every move by the LR and such entries in the other leaves to
  5e-3 of them;
* new BN running statistics to 1e-4 of each leaf's largest value (a
  batch mean near zero is a sum of cancelling terms).
"""

import numpy as np

from torch_parity import STEP_LOSS_KEYS, run_train_steps, split_noise_grads


def test_train_step_f32(monkeypatch):
    """Measured on the CPU: worst loss-term relative error 5e-5; the
    concatenated gradient within relative L2 4.3e-3 (cosine 0.99999);
    worst leaf relative L2 error 1.4e-2 (seg_net/sa1/mlp_0/bn_0/scale),
    the next ones 1.1e-2 and 1.0e-2, all other leaves below 1e-2;
    new-parameter entries off by an Adam sign flip about 3,600 of
    1,901,192 (1.9e-3)."""
    res = run_train_steps("float32", monkeypatch)
    jm, tm = res["jax_metrics"], res["port_metrics"]
    for k in STEP_LOSS_KEYS:
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-4, err_msg=k)
    for k in ("lr", "bn_momentum", "seg_accuracy"):
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-6, err_msg=k)
    pairs, noise = split_noise_grads(res)
    jg = np.concatenate([a.ravel() for a, _ in pairs.values()])
    tg = np.concatenate([b.ravel() for _, b in pairs.values()])
    assert np.linalg.norm(tg - jg) <= 1e-2 * np.linalg.norm(jg)
    assert jg @ tg >= 0.9999 * np.linalg.norm(jg) * np.linalg.norm(tg)
    for p, (a, b) in pairs.items():
        rel = np.linalg.norm(b - a) / max(np.linalg.norm(a), 1e-30)
        assert rel <= 3e-2, (p, rel)
    jp, tp, p0, lr = (res["jax_params"], res["port_params"],
                      res["old_params"], res["lr"])
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
    assert flipped <= 5e-3 * total, (flipped, total)
    js, ts = res["jax_stats"], res["port_stats"]
    assert sorted(js) == sorted(ts)
    for p in js:
        np.testing.assert_allclose(ts[p], js[p], rtol=1e-4,
                                   atol=1e-4 * np.abs(js[p]).max(),
                                   err_msg=p)


def _box_net_f32_and_f64(monkeypatch):
    """The port's v2 box net in train mode on 4 frustums of 64 object
    points, in float32 and, from the same weights, in float64 (every
    `.float()` of the port taken as `.double()`, FPS picks taken from the
    float32 coordinates): the input gradient of sum(out * g) and every
    layer's output."""
    import copy

    import torch

    from transferable3d_torch.core import bins
    from transferable3d_torch.models import frustum_pointnet_v2 as fv2
    from transferable3d_torch.models import pointnet2
    from transferable3d_torch.ops import grouping

    monkeypatch.setenv("T3D_FUSED_SA", "0")
    cfg = bins.SUNRGBD
    net = fv2.BoxEstimationNetV2(cfg, device="cpu",
                                 generator=torch.Generator().manual_seed(1))
    rng = np.random.RandomState(0)
    obj = torch.from_numpy(rng.normal(0, 0.3, (4, 64, 3)).astype(np.float32))
    one_hot = torch.eye(cfg.num_classes)[torch.tensor([1, 3, 5, 7])]
    gout = torch.from_numpy(rng.normal(size=(4, cfg.box_output_dim))
                            .astype(np.float32))
    fps = pointnet2.farthest_point_sample
    monkeypatch.setattr(pointnet2, "farthest_point_sample", lambda xyz, k: fps(
        xyz.detach().to(torch.float32).contiguous(), k))

    def run(dt):
        m = net if dt == torch.float32 else copy.deepcopy(net).double()
        for mod in m.modules():
            if getattr(mod, "dtype", None) is not None:
                mod.dtype = dt
        acts = {}
        hooks = [m.get_submodule(name).register_forward_hook(
            lambda mod, a, o, name=name: acts.__setitem__(
                name, o.detach().double()))
                 for name in ("head.fc_0", "head.bn_1")]
        x = obj.clone().to(dt).requires_grad_()
        (m(x, one_hot.to(dt)) * gout.to(dt)).sum().backward()
        for h in hooks:
            h.remove()
        return x.grad.double(), acts

    g32, a32 = run(torch.float32)
    monkeypatch.setattr(torch.Tensor, "float", lambda self: self.double())
    monkeypatch.setattr(grouping, "scatter_rows",
                        lambda idx, dg, n, dtype: torch.zeros(
                            dg.shape[0] * n, dg.shape[-1],
                            dtype=dg.dtype).index_add_(
                                0, (idx + torch.arange(dg.shape[0])[:, None,
                                                                    None]
                                    * n).reshape(-1),
                                dg.reshape(-1, dg.shape[-1])).reshape(
                                    dg.shape[0], n, dg.shape[-1]))
    g64, a64 = run(torch.float64)
    monkeypatch.undo()
    return g32, g64, a32, a64


def test_tnet_head_gradient_is_set_by_the_box_nets_f32_conditioning(
        monkeypatch):
    """Why the port's f32 `tnet/head/out/bias` gradient is further from a
    float64 run than JAX's (1.5e-2 against 6.7e-4, module docstring): that
    gradient is minus the sum over the box net's input gradients, which
    cancels to 4e-4 of their magnitudes, and the box net's f32 forward
    loses digits in its head, whose batch norms see 4 rows: the forward's
    relative error goes from 1.3e-6 at head.fc_0 to 1.0e-5 at head.bn_1
    (a BN over 4 rows divides each value's distance from their mean by
    their spread). Against float64 the per-point input gradient is then
    off by 3.0e-5 and its sum over points by 2.8e-3 (measured here, the
    port alone). No op of the port departs from JAX's order there: the
    head's BN backward replayed on the same inputs and cotangent is as
    close to float64 in the port's autograd as in JAX's jitted gradient
    (9.3e-7 and 9.1e-7 on the box net's own head.bn_1 tensors; 2.0e-6
    each on the random 4-row tensors here, held within a factor 2). So
    the gap is where the two programs' f32 roundings land, amplified by a
    4-frustum BN, and it is pinned here at the size measured."""
    import jax
    import jax.numpy as jnp
    import torch

    from transferable3d_torch.models import layers

    g32, g64, a32, a64 = _box_net_f32_and_f64(monkeypatch)

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    point = rel(g32, g64)
    summed = rel(g32.sum(1), g64.sum(1))
    cancel = float(g64.sum(1).norm() / g64.abs().sum(1).norm())
    fc0, bn1 = (rel(a32[k], a64[k]) for k in ("head.fc_0", "head.bn_1"))
    print(f"per point {point:.3e}, summed {summed:.3e}, cancellation "
          f"{cancel:.3e}, forward head.fc_0 {fc0:.3e} head.bn_1 {bn1:.3e}")
    assert 1e-5 <= point <= 1e-4 and 1e-3 <= summed <= 1e-2
    assert cancel <= 1e-3 and 0 < fc0 <= 3e-6 and bn1 >= 3 * fc0

    # the BN backward alone, on the same f32 inputs: port and JAX each
    # against the float64 value of the same expression
    rng = np.random.RandomState(2)
    x = rng.normal(0.3, 1.0, (4, 256)).astype(np.float32)
    g = rng.normal(0, 1e-3, (4, 256)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 256).astype(np.float32)

    def bn_grad_np(xd, gd, sd):
        mean = xd.mean(0)
        var = (xd * xd).mean(0) - mean * mean
        inv = 1.0 / np.sqrt(var + 1e-3)
        xhat = (xd - mean) * inv
        gy = gd * sd
        return inv * (gy - gy.mean(0) - xhat * (gy * xhat).mean(0))

    want = bn_grad_np(x.astype(np.float64), g.astype(np.float64),
                      scale.astype(np.float64))

    def jbn(xv):
        mean = jnp.mean(xv, axis=0)
        var = jnp.mean(jnp.square(xv), axis=0) - jnp.square(mean)
        return jnp.sum((xv - mean) * (jnp.reciprocal(jnp.sqrt(var + 1e-3))
                                      * scale) * g)

    jerr = np.linalg.norm(np.asarray(jax.jit(jax.grad(jbn))(jnp.asarray(x)),
                                     np.float64) - want)
    bn = layers.ScheduledBatchNorm(256, device="cpu")
    with torch.no_grad():
        bn.scale.copy_(torch.from_numpy(scale))
    xt = torch.from_numpy(x).requires_grad_()
    (bn(xt) * torch.from_numpy(g)).sum().backward()
    terr = np.linalg.norm(xt.grad.double().numpy() - want)
    print(f"BN backward vs float64: port {terr / np.linalg.norm(want):.3e}, "
          f"JAX {jerr / np.linalg.norm(want):.3e}")
    assert terr <= 2.0 * jerr + 1e-7 * np.linalg.norm(want)
