"""Port parity: `fused_grouped_chain` in train mode, its gradients, and
`GroupedPointMLP` in train mode on the fused branch.

The JAX side runs `transferable3d_tpu.ops.fused_sa.fused_grouped_chain`
with its Pallas passes in interpret mode, in the `rows` and the `planar`
layout (the port has one schedule for both: the layouts compute the same
values). On the CPU the port's schedule runs the plain twins of kernels
K5-K9. Tolerances are those of tests/test_fused_sa.py, which holds the JAX
op against its own unfused reference: pooled within 2% of max, batch
means `atol` 2e-3, variances 5e-3; gradients within 2% relative L2, taken
on integer-valued data, where the batch statistics are exact in f32 and
no reduction order can flip a max-pool tie. Dense biases under train-mode
BN have an analytically zero gradient (the batch mean removes the bias),
so both sides hold rounding noise there: they are held to 1% of the
weight gradients' scale, never relatively.

`torch.autograd.gradcheck` is not usable here: the chain is bf16, its
roundings are part of the function, and a finite difference of a bf16
function is noise; the JAX op's own VJP is the reference instead.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import bridged, init_flax, n, t
from transferable3d_tpu.models import pointnet2 as jpn2
from transferable3d_tpu.ops import fused_sa as jfs
from transferable3d_torch.models import pointnet2 as tpn2
from transferable3d_torch.ops import fused_sa as tfs

B, S, N, F0, K, R = 2, 8, 64, 16, 16, 0.9
EPS = 1e-3
LAYOUTS = ["rows", "planar"]
GROUPS = ("pf", "qc", "gammas", "betas", "ws", "bs")


def _setup(seed, feats=(F0, 24, 40), integer=False):
    rng = np.random.RandomState(seed)
    xyz = rng.uniform(-1.5, 1.5, (B, N, 3)).astype(np.float32)
    xyz[:, :24] = rng.normal(0, 0.2, (B, 24, 3))
    cent = rng.uniform(-1.5, 1.5, (B, S, 3)).astype(np.float32)
    cent[:, 0] = 0.0    # overfull ball
    cent[:, 1] = 10.0   # empty ball
    if integer:
        pf = rng.randint(-4, 5, (B, N, F0)).astype(np.float32)
        qc = rng.randint(-2, 3, (B, S, F0)).astype(np.float32)
    else:
        pf = rng.uniform(-1, 1, (B, N, F0)).astype(np.float32)
        qc = rng.uniform(-1, 1, (B, S, F0)).astype(np.float32)
    depth = len(feats)
    gammas = [rng.uniform(0.5, 1.5, f).astype(np.float32) for f in feats]
    betas = [rng.uniform(-0.3, 0.3, f).astype(np.float32) for f in feats]
    ws = [(rng.normal(size=(feats[i], feats[i + 1])) * 0.3).astype(
        np.float32) for i in range(depth - 1)]
    bs = [rng.uniform(-0.1, 0.1, feats[i + 1]).astype(np.float32)
          for i in range(depth - 1)]
    running = [(rng.normal(0, 0.2, f).astype(np.float32),
                rng.uniform(0.5, 2.0, f).astype(np.float32)) for f in feats]
    weight = rng.uniform(-1, 1, (B, S, feats[-1])).astype(np.float32)
    return cent, xyz, (pf, qc, gammas, betas, ws, bs), running, weight


def _jax_args(args):
    pf, qc, gammas, betas, ws, bs = args
    bf = jnp.bfloat16
    return (jnp.asarray(pf).astype(bf), jnp.asarray(qc).astype(bf),
            *(tuple(map(jnp.asarray, g)) for g in (gammas, betas, ws, bs)))


def _jax_running(running):
    return tuple((jnp.asarray(m), jnp.asarray(v)) for m, v in running)


def _jax_chain(cent, xyz, args, train, running, layout):
    return jfs.fused_grouped_chain(
        jnp.asarray(cent), jnp.asarray(xyz), *args, R, K, EPS, train,
        _jax_running(running), True, layout)


def _port_args(args, grad=False):
    pf, qc, gammas, betas, ws, bs = args
    out = [t(pf).bfloat16(), t(qc).bfloat16(), [t(g) for g in gammas],
           [t(b) for b in betas], [t(w) for w in ws], [t(b) for b in bs]]
    if grad:
        for x in out[:2] + [y for grp in out[2:] for y in grp]:
            x.requires_grad_()
    return out


def _port_chain(cent, xyz, args, train, running):
    return tfs.fused_grouped_chain(
        cent if torch.is_tensor(cent) else t(cent),
        xyz if torch.is_tensor(xyz) else t(xyz), *args, R, K, EPS, train,
        [(t(m), t(v)) for m, v in running])


def _both_grads(seed, feats, train, layout, integer=True):
    """Gradients of sum(pooled * weight) on both sides, as lists of numpy
    arrays per argument group."""
    cent, xyz, args, running, weight = _setup(seed, feats, integer)
    jgrads = jax.grad(lambda a: jnp.sum(
        _jax_chain(cent, xyz, a, train, running, layout)[0].astype(
            jnp.float32) * weight))(_jax_args(args))
    pargs = _port_args(args, grad=True)
    pooled, _, _ = _port_chain(cent, xyz, pargs, train, running)
    (pooled.float() * t(weight)).sum().backward()
    jl = [[n(x) for x in jax.tree_util.tree_leaves(g)] for g in jgrads]
    tl = [[n(x.grad) for x in (g if isinstance(g, list) else [g])]
          for g in pargs]
    return jl, tl


def _assert_grads_close(jl, tl, train, rel_tol=0.02):
    scale = max(np.linalg.norm(x) for x in jl[4])  # the ws gradients
    for name, a, b in zip(GROUPS, jl, tl):
        assert len(a) == len(b), name
        for x, y in zip(a, b):
            assert x.shape == y.shape, name
            if name == "bs" and train:
                assert np.linalg.norm(y) < 0.01 * scale, (name, scale)
                continue
            rel = np.linalg.norm(x - y) / max(1e-6, np.linalg.norm(x))
            assert rel < rel_tol, (name, rel)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_forward_train_matches_jax_op(layout):
    cent, xyz, args, running, _ = _setup(0)
    ref, jm, jv = _jax_chain(cent, xyz, _jax_args(args), True, running,
                             layout)
    got, means, variances = _port_chain(cent, xyz, _port_args(args), True,
                                        running)
    assert got.dtype == torch.bfloat16 and len(means) == len(variances) == 3
    assert not any(x.requires_grad for x in (*means, *variances))
    assert np.abs(n(got) - n(ref)).max() / np.abs(n(ref)).max() < 0.02
    assert (n(ref) != 0).mean() >= 0.10
    for i in range(3):
        np.testing.assert_allclose(n(means[i]), n(jm[i]), atol=2e-3)
        np.testing.assert_allclose(n(variances[i]), n(jv[i]), atol=5e-3)
        # not the running statistics it was given
        assert np.abs(n(means[i]) - running[i][0]).max() > 1e-2


@pytest.mark.parametrize("layout", LAYOUTS)
def test_train_grads_match_jax_op(layout):
    jl, tl = _both_grads(3, (F0, 24, 40), True, layout)
    _assert_grads_close(jl, tl, True)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_depth2_grads_match_jax_op(layout):
    """Depth 2: the j = 0 step is the top step (K9 redoes the pool
    gradient itself)."""
    jl, tl = _both_grads(7, (F0, 24), True, layout)
    _assert_grads_close(jl, tl, True)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("feats", [(F0, 24, 40), (F0, 24)])
def test_eval_mode_grads_match_jax_op(layout, feats):
    """Eval mode under autograd: the multi-pass schedule with packs from
    the running statistics and the eval forms of K8 and K9."""
    jl, tl = _both_grads(5, feats, False, layout)
    _assert_grads_close(jl, tl, False)


def test_real_valued_train_grads_match_jax_op():
    """Real-valued data: reduction order can flip a bf16 rounding or a
    pool tie, so the limit is looser (10% relative L2)."""
    jl, tl = _both_grads(1, (F0, 24, 40), True, "rows", integer=False)
    _assert_grads_close(jl, tl, True, rel_tol=0.10)


def test_eval_forward_under_autograd_equals_the_inference_twin():
    cent, xyz, args, running, _ = _setup(2)
    with torch.no_grad():
        infer, m0, _ = _port_chain(cent, xyz, _port_args(args), False,
                                   running)
    sched, m1, v1 = _port_chain(cent, xyz, _port_args(args, grad=True),
                                False, running)
    assert infer.grad_fn is None and sched.grad_fn is not None
    np.testing.assert_array_equal(n(infer), n(sched))
    np.testing.assert_array_equal(n(m1[0]), running[0][0])
    np.testing.assert_array_equal(n(v1[-1]), running[-1][1])


def test_geometry_grads_are_zero():
    cent, xyz, args, running, _ = _setup(4)
    c, x = t(cent).requires_grad_(), t(xyz).requires_grad_()
    pooled, _, _ = _port_chain(c, x, _port_args(args, grad=True), True,
                               running)
    pooled.float().sum().backward()
    assert c.grad is not None and float(c.grad.abs().max()) == 0.0
    assert x.grad is not None and float(x.grad.abs().max()) == 0.0


def test_chain_refuses_depth_1_and_f32():
    cent, xyz, args, running, _ = _setup(0, (F0, 24))
    pf, qc, gammas, betas, ws, bs = _port_args(args)
    with pytest.raises(ValueError, match="depth"):
        tfs.fused_grouped_chain(t(cent), t(xyz), pf, qc, gammas[:1],
                                betas[:1], [], [], R, K, EPS, True, None)
    with pytest.raises(ValueError, match="bfloat16"):
        tfs.fused_grouped_chain(t(cent), t(xyz), pf.float(), qc, gammas,
                                betas, ws, bs, R, K, EPS, True, None)


# --- GroupedPointMLP in train mode -----------------------------------------

FEATS = (16, 24, 32)
MOMENTUM = 0.8


def _module_inputs(seed):
    rng = np.random.RandomState(seed)
    xyz = rng.uniform(-1.5, 1.5, (B, N, 3)).astype(np.float32)
    feats = rng.uniform(-1, 1, (B, N, 5)).astype(np.float32)
    return xyz, jnp.asarray(feats).astype(jnp.bfloat16), xyz[:, :S].copy()


def _flax_module(seed):
    xyz, feats, new_xyz = _module_inputs(seed)
    mod = jpn2.GroupedPointMLP(FEATS, R, K, dtype=jnp.bfloat16)
    params, stats = init_flax(mod, 0, jnp.asarray(new_xyz), jnp.asarray(xyz),
                              feats, train=False, bn_momentum=0.9)
    return mod, params, stats, (new_xyz, xyz, feats)


def _port_module(params, stats):
    return bridged(tpn2.GroupedPointMLP(5, FEATS, R, K,
                                        dtype=torch.bfloat16, device="cpu"),
                   params, stats).train()


def test_module_train_matches_jax_fused_module(monkeypatch):
    """Output and BN running statistics after one train-mode call, against
    the JAX module on its fused branch (interpret mode)."""
    mod, params, stats, (new_xyz, xyz, feats) = _flax_module(2)
    monkeypatch.setattr(jfs, "INTERPRET", True)
    monkeypatch.setattr(jpn2, "on_tpu", lambda: True)
    monkeypatch.delenv("T3D_FUSED_SA", raising=False)
    ref, upd = mod.apply({"params": params, "batch_stats": stats},
                         jnp.asarray(new_xyz), jnp.asarray(xyz), feats,
                         train=True, bn_momentum=MOMENTUM,
                         mutable=["batch_stats"])
    port = _port_module(params, stats)
    with torch.no_grad():
        got = port(t(new_xyz), t(xyz), t(feats), MOMENTUM)
    assert got.dtype == torch.bfloat16
    assert np.abs(n(got) - n(ref)).max() / np.abs(n(ref)).max() < 0.02
    for i in range(len(FEATS)):
        bn = getattr(port, f"bn_{i}")
        jbn = upd["batch_stats"][f"bn_{i}"]
        np.testing.assert_allclose(n(bn.mean), np.asarray(jbn["mean"]),
                                   atol=2e-3)
        np.testing.assert_allclose(n(bn.var), np.asarray(jbn["var"]),
                                   atol=5e-3)
        # moved from where they started, by (1 - momentum) of the gap
        assert np.abs(n(bn.mean) - stats[f"bn_{i}"]["mean"]).max() > 1e-3


def test_module_train_fused_matches_unfused_branch(monkeypatch):
    """The port's two branches from the same weights: output within 2% of
    max, BN running statistics within the chain's tolerances, the same
    `state_dict` keys, and gradients of every parameter close."""
    _, params, stats, (new_xyz, xyz, feats) = _flax_module(3)
    outs = {}
    for flag in ("1", "0"):
        monkeypatch.setenv("T3D_FUSED_SA", flag)
        port = _port_module(params, stats)
        got = port(t(new_xyz), t(xyz), t(feats), MOMENTUM)
        got.float().square().sum().backward()
        outs[flag] = (n(got), port.state_dict(),
                      {k: n(p.grad) for k, p in port.named_parameters()})
    (a, sd_a, g_a), (b, sd_b, g_b) = outs["1"], outs["0"]
    assert list(sd_a) == list(sd_b)
    assert np.abs(a - b).max() / np.abs(b).max() < 0.02
    for key in sd_a:
        if key.endswith(".mean"):
            np.testing.assert_allclose(n(sd_a[key]), n(sd_b[key]), atol=2e-3)
        elif key.endswith(".var"):
            np.testing.assert_allclose(n(sd_a[key]), n(sd_b[key]), atol=5e-3)
        else:
            np.testing.assert_array_equal(n(sd_a[key]), n(sd_b[key]))
    scale = max(np.linalg.norm(g) for k, g in g_b.items()
                if k.endswith("weight"))
    for key, g in g_a.items():
        if key.startswith("dense") and key.endswith("bias"):
            # zero in exact arithmetic (a train-mode BN follows)
            assert np.linalg.norm(g) < 0.01 * scale, key
            continue
        rel = np.linalg.norm(g - g_b[key]) / np.linalg.norm(g_b[key])
        assert rel < 0.10, (key, rel)


def test_module_fused_train_takes_the_training_kernels_path(monkeypatch):
    """Train mode goes through the multi-pass schedule, never through the
    inference twin, and leaves the module's buffers differentiable-free."""
    _, params, stats, (new_xyz, xyz, feats) = _flax_module(4)
    monkeypatch.delenv("T3D_FUSED_SA", raising=False)
    seen = []
    orig = tfs.sa_extract
    monkeypatch.setattr(tfs, "sa_extract",
                        lambda *a: seen.append(1) or orig(*a))

    def refuse(*_a):
        raise AssertionError("train mode must not take the inference twin")

    monkeypatch.setattr(tfs, "sa_infer", refuse)
    port = _port_module(params, stats)
    out = port(t(new_xyz), t(xyz), t(feats), MOMENTUM)
    assert seen == [1] and out.requires_grad
    assert not port.bn_0.mean.requires_grad


# --- the route of a scale on the fused branch, and the card's padding ------

V2_TRAIN_SHAPES = [(32, (32, 32, 64)), (64, (64, 64, 128)),
                   (128, (64, 96, 128)), (64, (128, 128, 256)),
                   (128, (128, 128, 256))]


@pytest.mark.parametrize("k,widths,passes,fused", [
    *((k, w, True, True) for k, w in V2_TRAIN_SHAPES),
    (64, (64, 40, 128), True, True),      # a width of 40: padded to 48
    (16, (16, 24, 40), True, True),
    (24, (40, 40, 64), True, False),      # K = 24: not a 16-row multiple
    (24, (32, 32, 64), True, False),
    (256, (32, 32, 64), True, False),     # K > 128
    (64, (64, 264, 64), True, False),     # a width > 256
    (64, (256, 256), True, False),        # dW of 65,536 entries
    (24, (40, 40, 64), False, True),      # eval without a gradient: K2
    (1, (40, 64, 40), False, True)])
def test_fused_route_of_preset_and_ragged_shapes(k, widths, passes, fused):
    """`fused_route` decides from the shapes alone: the v2 presets and
    any width (padded on the card) train on K5-K9; K not a multiple of 16
    or above 128, widths above 256 and dW above 32,768 entries train on
    the unfused branch (K3/K4); inference without a gradient is K2 for
    every chain."""
    assert tfs.fused_route(k, widths, passes) is fused


def test_padded_chain_is_the_chain(monkeypatch):
    """`_padded_chain`, which the card runs for widths that are not
    multiples of 16, on the CPU's plain twins: pooled bit-identical to
    the unpadded chain; the batch statistics and every gradient within
    f32 reordering (the twins' sums over a wider tensor take another
    order)."""
    cent, xyz, args, _, weight = _setup(5)
    outs = []
    for padded in (False, True):
        pargs = _port_args(args, grad=True)
        call = (t(cent), t(xyz), *pargs, R, K, EPS, True, None)
        out = (tfs._padded_chain(*call, [16, 24, 40]) if padded
               else tfs.fused_grouped_chain(*call))
        (out[0].float() * t(weight)).sum().backward()
        outs.append((out, [x.grad for x in pargs[:2]]
                     + [y.grad for grp in pargs[2:] for y in grp]))
    (ref, gref), (got, ggot) = outs
    assert got[0].shape == ref[0].shape and torch.equal(got[0], ref[0])
    for a, b_ in zip(got[1] + got[2], ref[1] + ref[2]):
        torch.testing.assert_close(a, b_, rtol=1e-5, atol=1e-6)
    for a, b_ in zip(ggot, gref):
        assert a.shape == b_.shape
        assert float((a.float() - b_.float()).norm()) <= (
            1e-3 * float(b_.float().norm()) + 1e-6)


def test_module_reroutes_shapes_the_training_kernels_do_not_take(
        monkeypatch):
    """A bf16 GroupedPointMLP with K = 24 in train mode: the fused branch
    sends it to the unfused one (the same output as T3D_FUSED_SA=0),
    counts it in `_build.LAUNCHES["fused_sa_rerouted"]` and warns once;
    in eval without a gradient it stays on the fused branch (K2)."""
    from transferable3d_torch.ops import _build

    _, params, stats, (new_xyz, xyz, feats) = _flax_module(6)
    args = (t(new_xyz), t(xyz), t(feats), MOMENTUM)

    def module():
        return bridged(tpn2.GroupedPointMLP(5, FEATS, R, 24,
                                            dtype=torch.bfloat16,
                                            device="cpu"),
                       params, stats).train()

    monkeypatch.setenv("T3D_FUSED_SA", "0")
    want = module()(*args)
    monkeypatch.delenv("T3D_FUSED_SA")
    monkeypatch.setattr(tfs, "_REROUTED_SHAPES", set())
    before = _build.LAUNCHES["fused_sa_rerouted"]
    with pytest.warns(UserWarning, match="K=24"):
        got = module()(*args)
    assert torch.equal(got, want)
    assert _build.LAUNCHES["fused_sa_rerouted"] == before + 1
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        module()(*args)  # the same shape again: counted, not warned
        with torch.no_grad():
            seen = []
            orig = tfs.sa_infer
            monkeypatch.setattr(tfs, "sa_infer",
                                lambda *a: seen.append(1) or orig(*a))
            module().eval()(*args)
    assert seen == [1]
    assert _build.LAUNCHES["fused_sa_rerouted"] == before + 2


def test_fused_and_unfused_steps_part_where_they_round():
    """The box net's gradient from one bf16 step on 4 frustums (chip_smoke's
    pinned `SmallStep`, plain twins on the CPU) on the fused branch, on the
    unfused one, and on the unfused one rounded where the fused kernels
    round (`chip_smoke._fused_rounding`: each inner Dense adds its bias in
    f32 before its one rounding, each batch norm applies bf16(z a + c)).
    The last is the same function in exact arithmetic; it lies as far from
    the unfused step as the fused step does, and next to the fused step,
    within twice either path's distance from itself on the batch reversed
    (a hundredth of the paths' gap): the two branches part only where their
    forwards round."""
    import chip_smoke
    from transferable3d_torch.core import bins
    from transferable3d_torch.models import registry
    from transferable3d_torch.train import schedules

    cfg, bf = bins.SUNRGBD, torch.bfloat16
    initial = registry.get_model(
        "frustum_pointnets_v2", cfg, dtype=bf, device="cpu",
        generator=torch.Generator().manual_seed(1))
    step = chip_smoke.SmallStep(
        cfg, initial, chip_smoke.train_batch(cfg),
        schedules.exponential_staircase_lr(batch_size=chip_smoke.B),
        schedules.bn_momentum_schedule(batch_size=chip_smoke.B), 0, "cpu",
        count=4)

    def unfused(**kw):
        with chip_smoke.fused_sa_env("0"):
            return step(bf, "cpu", True, **kw)

    def gap(a, b):
        return 1.0 - chip_smoke.compare(a, b)[1]["box_net"]

    with chip_smoke.fused_sa_env(None):
        fused = step(bf, "cpu", True)
        fused_rev = step(bf, "cpu", True, order=step.perm)
    plain = unfused()
    step.adapt = chip_smoke._fused_rounding
    like_fused = unfused()
    step.adapt = None
    witness = max(gap(fused, fused_rev), gap(plain, unfused(order=step.perm)))
    assert gap(fused, plain) > 20 * witness
    assert gap(plain, like_fused) > 0.5 * gap(fused, plain)
    assert gap(fused, like_fused) < 2 * witness
