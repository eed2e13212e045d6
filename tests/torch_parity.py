"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_*.py).

Both packages get the same numpy inputs; JAX stays on the CPU (see
conftest.py) and the port runs its plain twins on CPU tensors. Flax
variables cross over as nested dicts of numpy arrays through
`transferable3d_torch.utils.bridge`.
"""

from __future__ import annotations

import re
from functools import partial

import jax
import numpy as np
import torch

from transferable3d_torch.utils.bridge import load_flax_variables


def to_numpy_tree(tree):
    """jax pytree of mappings -> nested dicts of numpy arrays."""
    if hasattr(tree, "items"):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    return np.array(jax.device_get(tree))


def perturb_stats(batch_stats, rng: np.random.RandomState):
    """BN running statistics moved away from 0/1 so no layer is an
    identity: mean ~ N(0, 0.2), var ~ U(0.5, 2)."""
    out = {}
    for k, v in batch_stats.items():
        if hasattr(v, "items"):
            out[k] = perturb_stats(v, rng)
        elif k == "mean":
            out[k] = rng.normal(0, 0.2, np.shape(v)).astype(np.float32)
        elif k == "var":
            out[k] = rng.uniform(0.5, 2.0, np.shape(v)).astype(np.float32)
        else:
            raise KeyError(k)
    return out


def init_flax(module, rng_seed: int, *args, **kwargs):
    """Jitted flax init -> (params, batch_stats) as numpy trees, with the
    batch statistics perturbed (numpy RandomState(rng_seed))."""
    variables = jax.jit(lambda *a: module.init(
        jax.random.PRNGKey(rng_seed), *a, **kwargs))(*args)
    variables = to_numpy_tree(variables)
    stats = variables.get("batch_stats", {})
    return (variables["params"],
            perturb_stats(stats, np.random.RandomState(rng_seed + 1000)))


def bridged(torch_module, params, batch_stats):
    load_flax_variables(torch_module, params, batch_stats)
    return torch_module.eval()


def t(x):
    """numpy / jax array -> CPU torch tensor (bf16 via float32)."""
    arr = np.asarray(jax.device_get(x))
    if arr.dtype == jax.numpy.bfloat16:
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def n(x):
    """torch tensor or jax array -> float32/int numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.is_floating_point() else x).numpy()
    arr = np.asarray(jax.device_get(x))
    return arr.astype(np.float32) if arr.dtype == jax.numpy.bfloat16 else arr



# ---------------------------------------------------------------------------
# One v2 train step on both sides (tests/test_torch_train_step*.py)
# ---------------------------------------------------------------------------

STEP_LOSS_KEYS = ("total_loss", "seg_loss", "center_loss",
                  "stage1_center_loss", "heading_class_loss",
                  "heading_residual_loss", "size_class_loss",
                  "size_residual_loss", "corner_loss")
_PRE_BN_BIAS = re.compile(r"(.*)/(dense|fc)_(\d+)/bias$")


def tree_leaves(tree, prefix=""):
    """Nested dict -> {flax path 'a/b/kernel': float32 array}."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if hasattr(v, "items"):
            out.update(tree_leaves(v, path))
        else:
            out[path] = np.asarray(v, np.float32)
    return out


# The last BN bias before a global max-pool whose output feeds a Dense and
# a train-mode BN over the batch: it shifts every frustum's pooled feature
# alike (where the ReLU passes), and that BN removes such a shift.
GLOBAL_POOL_BN_BIASES = ("seg_net/sa3/mlp/bn_2/bias",
                         "box_net/sa3/mlp/bn_2/bias", "tnet/mlp/bn_2/bias")


def zero_gradient_leaves(paths):
    """Leaves whose train-step gradient is zero (or nearly, for the
    pooled ones) in exact arithmetic, so that both sides hold rounding
    noise: Dense biases that feed a train-mode BatchNorm (the batch mean
    removes the bias) and `GLOBAL_POOL_BN_BIASES`."""
    out = [p for p in GLOBAL_POOL_BN_BIASES if p in paths]
    for p in paths:
        m = _PRE_BN_BIAS.match(p)
        if m and f"{m.group(1)}/bn_{m.group(3)}/scale" in paths:
            out.append(p)
    return out


def run_train_steps(dtype: str, monkeypatch, batch_size=4, npoints=256,
                    nobj=64, mask_margin=0.0, f32_witness=False):
    """One `make_train_step` of F-PointNet v2 in JAX and in the port from
    the same weights, batch and dropout mask, with T3D_FUSED_SA=0.

    Each frustum is moved to its own mean (|x| of a few meters): XLA
    fuses the expanded-form squared distances (with FMA contraction)
    where the port rounds every op, and far from the origin the two can
    differ by ~1e-5, enough to move a point across a 0.2 m ball's
    boundary. Near the origin they differ by ~1e-7. `mask_margin` adds
    that much to the foreground logit's bias, so every point is masked
    with a margin that bf16 rounding cannot flip (a flipped point would
    change the box net's input on one side only). The JAX keep mask is
    read from the step's own forward (rng `fold_in(state.rng,
    state.step)`): keep where `seg_net/dp`'s output is nonzero or its
    input is zero.

    Returns a dict: jax/port metrics, gradient leaves, new parameter and
    statistics leaves, the old parameter leaves, the LR, and the inputs
    (`port_train_step`'s) for another port step; with `f32_witness`, also
    the JAX float32 model's gradient on the same step (same weights,
    batch and keep mask) as `jax_f32_grads`."""
    import jax.numpy as jnp

    from transferable3d_tpu.core import bins as jbins
    from transferable3d_tpu.data import synthetic
    from transferable3d_tpu.data.provider import FrustumDataset
    from transferable3d_tpu.models.frustum_pointnet_v2 import (
        FrustumPointNetV2 as JV2)
    from transferable3d_tpu.train import schedules as jsched
    from transferable3d_tpu.train import train_loop as jloop

    monkeypatch.setenv("T3D_FUSED_SA", "0")
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    cfg = jbins.SUNRGBD
    recs = synthetic.make_dataset(batch_size, cfg, seed=0, n_object=150,
                                  n_clutter=80)
    batch = FrustumDataset(recs, cfg, npoints=npoints, rotate_to_center=True,
                           seed=0).get_batch(list(range(batch_size)))
    mean = batch["points"][..., :3].mean(axis=1)
    batch["points"][..., :3] = np.round(
        (batch["points"][..., :3] - mean[:, None]) * 256) / 256
    batch["center"] -= mean
    jm = JV2(cfg=cfg, num_object_point=nobj, dtype=jdt)
    jlr = jsched.exponential_staircase_lr(batch_size=batch_size)
    jbn = jsched.bn_momentum_schedule(batch_size=batch_size)
    tx = jloop.make_optimizer(jlr)
    state = jloop.create_train_state(jm, cfg, tx, batch, seed=0)
    if mask_margin:
        params = to_numpy_tree(state.params)
        params["seg_net"]["seg_out"]["bias"][1] += mask_margin
        state = state.replace(params=jax.tree_util.tree_map(jnp.asarray,
                                                            params))
    params0 = to_numpy_tree(state.params)
    stats0 = to_numpy_tree(state.batch_stats)
    rng = jax.random.fold_in(state.rng, state.step)
    labels = jloop.labels_from_batch(
        {k: jnp.asarray(v) for k, v in batch.items()})

    def grads_and_dropout(module):
        return jax.jit(partial(_grads_and_dropout, module, batch, labels,
                               cfg, rng))(state.params, state.batch_stats,
                                          jbn(state.step))

    jgrads, (dp_out, dp_in, jmask) = grads_and_dropout(jm)
    keep = torch.from_numpy((np.asarray(dp_out, np.float32) != 0)
                            | (np.asarray(dp_in, np.float32) == 0))
    witness = {}
    if f32_witness:
        # The same rng draws the same keep mask at either dtype.
        g32, (_, _, mask32) = grads_and_dropout(
            JV2(cfg=cfg, num_object_point=nobj, dtype=jnp.float32))
        np.testing.assert_array_equal(np.asarray(mask32), np.asarray(jmask))
        witness["jax_f32_grads"] = tree_leaves(to_numpy_tree(g32))
    # The step donates `state`'s buffers: nothing reads them after it.
    jstate, jmet = jloop.make_train_step(jm, cfg, tx, jlr, jbn)(state, batch)
    assert int(jstate.step) == 1

    port = port_train_step(dtype, params0, stats0, batch, keep, nobj,
                           monkeypatch)
    np.testing.assert_array_equal(port["mask"], np.asarray(jmask))
    return {
        "jax_metrics": {k: float(v) for k, v in jmet.items()},
        "jax_grads": tree_leaves(to_numpy_tree(jgrads)),
        "jax_params": tree_leaves(to_numpy_tree(jstate.params)),
        "jax_stats": tree_leaves(to_numpy_tree(jstate.batch_stats)),
        "old_params": tree_leaves(params0),
        "inputs": (params0, stats0, batch, keep, nobj),
        **port,
        **witness,
    }


def _grads_and_dropout(module, batch, labels, cfg, rng, params,
                       batch_stats, bn_momentum):
    """JAX gradient of the v2 total loss, and the seg head's dropout
    output and input and the predicted mask of the same forward."""
    from transferable3d_tpu.models import model_util as jmu

    def loss_fn(p):
        ep, upd = module.apply(
            {"params": p, "batch_stats": batch_stats}, batch["points"],
            batch["one_hot"], train=True, bn_momentum=bn_momentum,
            rngs={"dropout": rng}, mutable=["batch_stats", "intermediates"],
            capture_intermediates=lambda mdl, _: mdl.name in (
                "dp", "head_mlp"))
        seg = upd["intermediates"]["seg_net"]
        return (jmu.get_loss(ep, labels, cfg)["total_loss"],
                (seg["dp"]["__call__"][0], seg["head_mlp"]["__call__"][0],
                 ep["mask"]))
    return jax.grad(loss_fn, has_aux=True)(params)


def port_train_step(dtype: str, params0, stats0, batch, keep, nobj,
                    monkeypatch):
    """One port `make_train_step` of v2 from flax-tree weights, with the
    dropout keep mask `keep` [B, N, 128] injected. Returns the port's
    metrics, gradient, new parameter and statistics leaves, the
    predicted mask and the LR."""
    from transferable3d_torch.core import bins as tbins
    from transferable3d_torch.models import layers as tlayers
    from transferable3d_torch.models.frustum_pointnet_v2 import (
        FrustumPointNetV2 as TV2)
    from transferable3d_torch.train import schedules as tsched
    from transferable3d_torch.train import train_loop as tloop
    from transferable3d_torch.utils import bridge

    monkeypatch.setenv("T3D_FUSED_SA", "0")
    b = len(batch["points"])
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    model = TV2(tbins.SUNRGBD, num_object_point=nobj, dtype=tdt)
    bridge.load_flax_variables(model, params0, stats0)
    tlr = tsched.exponential_staircase_lr(batch_size=b)
    tbn = tsched.bn_momentum_schedule(batch_size=b)
    tstate = tloop.create_train_state(model, tloop.make_optimizer(tlr),
                                      generator=torch.Generator())
    monkeypatch.setattr(tlayers, "dropout_keep_mask",
                        lambda shape, rate, gen: keep)
    seen = {}
    hook = model.register_forward_hook(
        lambda mod, args, out: seen.update(mask=out["mask"]))
    tstate, tmet = tloop.make_train_step(tbins.SUNRGBD, tlr, tbn)(tstate,
                                                                 batch)
    hook.remove()
    assert tstate.step == 1
    tparams, tstats = bridge.state_dict_to_flax(model)
    return {
        "port_metrics": {k: float(v) for k, v in tmet.items()},
        "port_grads": tree_leaves(bridge.grads_to_flax(model)),
        "port_params": tree_leaves(tparams),
        "port_stats": tree_leaves(tstats),
        "mask": seen["mask"].numpy(),
        "lr": tmet["lr"],
    }


def split_noise_grads(res, bound=1e-4):
    """Check the `zero_gradient_leaves` are rounding noise on both sides
    (<= `bound` times the largest gradient entry; None skips the check)
    and return the other leaves as {path: (jax, port)} plus the noise
    paths."""
    jl, tl = res["jax_grads"], res["port_grads"]
    assert sorted(jl) == sorted(tl)
    noise = zero_gradient_leaves(jl)
    assert len(noise) > 20
    scale = max(np.abs(g).max() for g in jl.values())
    for p in noise if bound is not None else ():
        assert np.abs(jl[p]).max() <= bound * scale, p
        assert np.abs(tl[p]).max() <= bound * scale, p
    return {p: (jl[p], tl[p]) for p in jl if p not in noise}, noise
