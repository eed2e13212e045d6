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
import pytest
import torch

from transferable3d_torch.utils.bridge import load_flax_variables


@pytest.fixture(scope="module")
def one_torch_thread():
    """torch's CPU ops on one thread for a module's tests. The suite runs
    several pytest workers at once, and torch's default of a thread a
    core oversubscribes the cores: small training loops ran 20-40 times
    slower there than alone, and no faster alone on more threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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
# Train steps on both sides (tests/test_torch_train_step*.py)
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
# v1's factored concat-Dense: `mlp3_point`'s bias feeds `mlp3_bn`.
_OTHER_PRE_BN_BIASES = ("seg_net/mlp3_point/bias",)


def zero_gradient_leaves(paths, pooled=True):
    """Leaves whose train-step gradient is zero (or nearly, for the
    pooled ones) in exact arithmetic, so that both sides hold rounding
    noise: Dense biases that feed a train-mode BatchNorm (the batch mean
    removes the bias) and, with `pooled`, `GLOBAL_POOL_BN_BIASES`. (The
    pooled ones are near zero only while every frustum's pooled feature
    passes its ReLU: not on a batch with all-zero padded frustums.)"""
    out = [p for p in (GLOBAL_POOL_BN_BIASES if pooled else ())
           + _OTHER_PRE_BN_BIASES if p in paths]
    for p in paths:
        m = _PRE_BN_BIAS.match(p)
        if m and f"{m.group(1)}/bn_{m.group(3)}/scale" in paths:
            out.append(p)
    return out


def _set_sa_path(monkeypatch, fused: bool) -> None:
    """T3D_FUSED_SA for both packages: "0", or unset (the default, the
    fused set abstraction). The JAX package takes its fused branch only on
    a TPU, so for `fused` its Pallas passes run in interpret mode and its
    module is told it is on one, as tests/test_fused_sa.py does."""
    if not fused:
        monkeypatch.setenv("T3D_FUSED_SA", "0")
        return
    from transferable3d_tpu.models import pointnet2 as jpn2
    from transferable3d_tpu.ops import fused_sa as jfs

    monkeypatch.delenv("T3D_FUSED_SA", raising=False)
    monkeypatch.setattr(jfs, "INTERPRET", True)
    monkeypatch.setattr(jpn2, "on_tpu", lambda: True)


def _family(family: str):
    """(JAX model class, port model class, name of the seg-net module
    whose output the dropout takes) of a model family, "v1" or "v2"."""
    if family == "v2":
        from transferable3d_tpu.models.frustum_pointnet_v2 import (
            FrustumPointNetV2 as JModel)
        from transferable3d_torch.models.frustum_pointnet_v2 import (
            FrustumPointNetV2 as TModel)
        return JModel, TModel, "head_mlp"
    from transferable3d_tpu.models.frustum_pointnet_v1 import (
        FrustumPointNetV1 as JModel)
    from transferable3d_torch.models.frustum_pointnet_v1 import (
        FrustumPointNetV1 as TModel)
    return JModel, TModel, "mlp3"


def synthetic_step_batch(batch_size=4, npoints=256):
    """Synthetic frustums for a step test, each moved to its own mean and
    onto a 1/256 grid (see `run_train_steps`)."""
    from transferable3d_tpu.core import bins as jbins
    from transferable3d_tpu.data import synthetic
    from transferable3d_tpu.data.provider import FrustumDataset

    cfg = jbins.SUNRGBD
    recs = synthetic.make_dataset(batch_size, cfg, seed=0, n_object=150,
                                  n_clutter=80)
    batch = FrustumDataset(recs, cfg, npoints=npoints, rotate_to_center=True,
                           seed=0).get_batch(list(range(batch_size)))
    mean = batch["points"][..., :3].mean(axis=1)
    batch["points"][..., :3] = np.round(
        (batch["points"][..., :3] - mean[:, None]) * 256) / 256
    batch["center"] -= mean
    return batch


def run_train_steps(dtype: str, monkeypatch, batch_size=4, npoints=256,
                    nobj=64, mask_margin=0.0, f32_witness=False,
                    fused=False, jax_update=True, family="v2", batch=None,
                    step_cfg=None, warmup_steps=0):
    """One `make_train_step` of F-PointNet `family` ("v2" or "v1") in JAX
    and in the port from the same weights, batch and dropout mask, with
    T3D_FUSED_SA=0 or, with `fused`, unset (`_set_sa_path`). With
    `warmup_steps`, the JAX side first takes that many steps alone and
    the compared step starts from the state they leave (parameters and
    BN statistics; the port's Adam moments start at zero, so the new
    parameters are then not comparable).

    Without `batch`, the batch is `synthetic_step_batch`: each frustum
    moved to its own mean (|x| of a few meters), because XLA fuses the
    expanded-form squared distances (with FMA contraction) where the
    port rounds every op, and far from the origin the two can differ by
    ~1e-5, enough to move a point across a 0.2 m ball's boundary. Near
    the origin they differ by ~1e-7. `batch` is a dict of numpy arrays
    for both sides (v1 has no balls and takes any); `step_cfg` holds
    `StepConfig` fields for both sides. `mask_margin` adds that much to
    the foreground logit's bias, so every point is masked with a margin
    that bf16 rounding cannot flip (a flipped point would change the box
    net's input on one side only). The JAX keep mask is read from the
    step's own forward (rng `fold_in(state.rng, state.step)`): keep
    where `seg_net/dp`'s output is nonzero or its input is zero.

    Returns a dict: jax/port metrics, gradient leaves, new parameter and
    statistics leaves, the old parameter leaves, the LR, and the inputs
    (`port_train_step`'s) for another port step; with `f32_witness`, also
    the JAX float32 model's gradient on the same step (same weights,
    batch and keep mask) as `jax_f32_grads`. Without `jax_update`
    the JAX side stops after the step's forward and backward (one
    compilation instead of two, which is what the interpret-mode Pallas
    passes of the fused path cost): `jax_metrics` then holds the total
    loss only, `jax_stats` the forward's updated statistics,
    `jax_params` nothing."""
    import jax.numpy as jnp

    from transferable3d_tpu.core import bins as jbins
    from transferable3d_tpu.train import schedules as jsched
    from transferable3d_tpu.train import train_loop as jloop

    _set_sa_path(monkeypatch, fused)
    jmodel, _, dp_input = _family(family)
    step_cfg = dict(step_cfg or {})
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    cfg = jbins.SUNRGBD
    if batch is None:
        batch = synthetic_step_batch(batch_size, npoints)
    batch_size = len(batch["points"])
    jm = jmodel(cfg=cfg, num_object_point=nobj, dtype=jdt)
    jlr = jsched.exponential_staircase_lr(batch_size=batch_size)
    jbn = jsched.bn_momentum_schedule(batch_size=batch_size)
    tx = jloop.make_optimizer(jlr)
    state = jloop.create_train_state(jm, cfg, tx, batch, seed=0)
    if mask_margin:
        params = to_numpy_tree(state.params)
        params["seg_net"]["seg_out"]["bias"][1] += mask_margin
        state = state.replace(params=jax.tree_util.tree_map(jnp.asarray,
                                                            params))
    jstep = jloop.make_train_step(jm, cfg, tx, jlr, jbn,
                                  step_cfg=jloop.StepConfig(**step_cfg))
    for _ in range(warmup_steps):
        state, _ = jstep(state, batch)
    params0 = to_numpy_tree(state.params)
    stats0 = to_numpy_tree(state.batch_stats)
    rng = jax.random.fold_in(state.rng, state.step)
    labels = jloop.labels_from_batch(
        {k: jnp.asarray(v) for k, v in batch.items()})
    weights = (jnp.asarray(batch["valid"], jnp.float32)
               if step_cfg.get("use_valid_weights") else None)

    def grads_and_dropout(module):
        return jax.jit(partial(_grads_and_dropout, module, batch, labels,
                               weights, cfg, rng, dp_input))(
                                   state.params, state.batch_stats,
                                   jbn(state.step))

    jgrads, (dp_out, dp_in, jmask, jloss, jstats) = grads_and_dropout(jm)
    keep = torch.from_numpy((np.asarray(dp_out, np.float32) != 0)
                            | (np.asarray(dp_in, np.float32) == 0))
    witness = {}
    if f32_witness:
        # The same rng draws the same keep mask at either dtype.
        g32, (_, _, mask32, _, _) = grads_and_dropout(
            jmodel(cfg=cfg, num_object_point=nobj, dtype=jnp.float32))
        np.testing.assert_array_equal(np.asarray(mask32), np.asarray(jmask))
        witness["jax_f32_grads"] = tree_leaves(to_numpy_tree(g32))
    if jax_update:
        # The step donates `state`'s buffers: nothing reads them after it.
        jstate, jmet = jstep(state, batch)
        assert int(jstate.step) == warmup_steps + 1
        jmet = {k: float(v) for k, v in jmet.items()}
        jparams = tree_leaves(to_numpy_tree(jstate.params))
        jstats = jstate.batch_stats
    else:
        jmet, jparams = {"total_loss": float(jloss)}, {}

    port = port_train_step(dtype, params0, stats0, batch, keep, nobj,
                           monkeypatch, fused=fused, family=family,
                           step_cfg=step_cfg, start_step=warmup_steps)
    np.testing.assert_array_equal(port["mask"], np.asarray(jmask))
    return {
        "jax_metrics": jmet,
        "jax_grads": tree_leaves(to_numpy_tree(jgrads)),
        "jax_params": jparams,
        "jax_stats": tree_leaves(to_numpy_tree(jstats)),
        "old_params": tree_leaves(params0),
        "inputs": (params0, stats0, batch, keep, nobj),
        "fused": fused,
        **port,
        **witness,
    }


def _grads_and_dropout(module, batch, labels, weights, cfg, rng, dp_input,
                       params, batch_stats, bn_momentum):
    """JAX gradient of the total loss, and of the same forward: the seg
    net's dropout output and input (the output of its module `dp_input`),
    the predicted mask, the total loss and the updated batch
    statistics."""
    from transferable3d_tpu.models import model_util as jmu

    def loss_fn(p):
        ep, upd = module.apply(
            {"params": p, "batch_stats": batch_stats}, batch["points"],
            batch["one_hot"], train=True, bn_momentum=bn_momentum,
            rngs={"dropout": rng}, mutable=["batch_stats", "intermediates"],
            capture_intermediates=lambda mdl, _: mdl.name in (
                "dp", dp_input))
        seg = upd["intermediates"]["seg_net"]
        loss = jmu.get_loss(ep, labels, cfg,
                            example_weights=weights)["total_loss"]
        return (loss,
                (seg["dp"]["__call__"][0], seg[dp_input]["__call__"][0],
                 ep["mask"], loss, upd["batch_stats"]))
    return jax.grad(loss_fn, has_aux=True)(params)


def port_train_step(dtype: str, params0, stats0, batch, keep, nobj,
                    monkeypatch, fused=False, family="v2", step_cfg=None,
                    start_step=0):
    """One port `make_train_step` of the `family` model from flax-tree
    weights on the CPU, as step number `start_step`, with the dropout
    keep mask `keep` [B, N, 128] injected, on the unfused SA path or,
    with `fused`, the default fused one. Returns the port's metrics,
    gradient, new parameter and statistics leaves, the predicted mask
    and the LR."""
    from transferable3d_torch.core import bins as tbins
    from transferable3d_torch.models import layers as tlayers
    from transferable3d_torch.train import schedules as tsched
    from transferable3d_torch.train import train_loop as tloop
    from transferable3d_torch.utils import bridge

    _set_sa_path(monkeypatch, fused)
    _, tmodel, _ = _family(family)
    b = len(batch["points"])
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    model = tmodel(tbins.SUNRGBD, num_object_point=nobj, dtype=tdt,
                   in_channels=batch["points"].shape[-1], device="cpu")
    bridge.load_flax_variables(model, params0, stats0)
    tlr = tsched.exponential_staircase_lr(batch_size=b)
    tbn = tsched.bn_momentum_schedule(batch_size=b)
    tstate = tloop.create_train_state(model, tloop.make_optimizer(tlr),
                                      generator=torch.Generator())
    tstate.step = start_step
    monkeypatch.setattr(tlayers, "dropout_keep_mask",
                        lambda shape, rate, gen: keep)
    seen = {}
    hook = model.register_forward_hook(
        lambda mod, args, out: seen.update(mask=out["mask"]))
    tstate, tmet = tloop.make_train_step(
        tbins.SUNRGBD, tlr, tbn, tloop.StepConfig(**(step_cfg or {})))(
            tstate, batch)
    hook.remove()
    assert tstate.step == start_step + 1
    tparams, tstats = bridge.state_dict_to_flax(model)
    return {
        "port_metrics": {k: float(v) for k, v in tmet.items()},
        "port_grads": tree_leaves(bridge.grads_to_flax(model)),
        "port_params": tree_leaves(tparams),
        "port_stats": tree_leaves(tstats),
        "mask": seen["mask"].numpy(),
        "lr": tmet["lr"],
    }


def split_noise_grads(res, bound=1e-4, pooled=True, n_noise=None):
    """Check the `zero_gradient_leaves` are rounding noise on both sides
    (<= `bound` times the largest gradient entry; None skips the check)
    and return the other leaves as {path: (jax, port)} plus the noise
    paths. There are more than 20 such leaves in v2; another family
    states its exact number as `n_noise`."""
    jl, tl = res["jax_grads"], res["port_grads"]
    assert sorted(jl) == sorted(tl)
    noise = zero_gradient_leaves(jl, pooled)
    assert len(noise) > 20 if n_noise is None else len(noise) == n_noise
    scale = max(np.abs(g).max() for g in jl.values())
    for p in noise if bound is not None else ():
        assert np.abs(jl[p]).max() <= bound * scale, p
        assert np.abs(tl[p]).max() <= bound * scale, p
    return {p: (jl[p], tl[p]) for p in jl if p not in noise}, noise
