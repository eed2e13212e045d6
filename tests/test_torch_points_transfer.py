"""The transfer loop's steps and `BoxEstimationOnly` on a (data, points)
mesh, against the JAX package's jitted steps on `data_points_mesh(2, 2)`
and against the port's own one rank.

JAX's side runs one jitted function a step kind on the 8-device virtual
CPU mesh (tests/conftest.py), its batch placed by `shard_batch` on both
axes and its state replicated, as `tests/test_points_sharding.py` runs
its v1 step: GSPMD computes the 1-device function. The function is the
JAX step's own loss, gradient and optax update, and also returns the
dropout keep masks (and the step's draws), which the port's ranks take
in place of their generator's. The port's ranks are spawned processes
on the CPU (gloo, `file://` rendezvous, one torch thread a rank;
`torch_dp_ranks`), on 8 frustums of 128 points.

Tolerances:
* f32 losses within rtol 1e-4 of JAX's mesh step, and the parameters
  after one step within atol 5e-3 (`tests/test_points_sharding.py`);
* the gradient's per-net cosines against JAX's, and the loss, the
  gradient's relative L2, the BN statistics (`points_readings`) and the
  gradient norm against the port's one rank, at limits set from the
  readings, each beside a witness (the 1-rank step on each frustum's
  point halves swapped: every step here is a function of each frustum's
  point set) and controls that must each fail one: a per-shard pool
  (`local_pool`), per-shard BN (`local_bn`) and, in phase B, BoxPC's
  cotangent of the predicted box left unsummed over the points group
  (`box_cotangent_unsummed`). The readings are in each test's
  docstring.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import torch_dp_ranks as ranks
from test_torch_boxpc import (_HEAD, _jax_aug_draws, _jax_perturbation_draws,
                              _t, boxpc_noise_leaves, strong_batch)
from test_torch_parallel import _concat, _cos
from test_torch_parallel import fails as _fails
from test_torch_points_parallel import points_readings
from test_torch_semisup import OPEN_GATE, weak_batch
from torch_parity import (init_flax, one_torch_thread,  # noqa: F401
                          perturb_stats, synthetic_step_batch, to_numpy_tree,
                          tree_leaves, zero_gradient_leaves)
from transferable3d_tpu.core import bins as jbins
from transferable3d_tpu.models import boxpc as jboxpc
from transferable3d_tpu.models import model_util as jmu
from transferable3d_tpu.models.frustum_pointnet_v1 import (BoxEstimationOnly,
                                                           FrustumPointNetV1)
from transferable3d_tpu.parallel import mesh as jmesh
from transferable3d_tpu.train import schedules as jsched
from transferable3d_tpu.train import semisup as jsemi
from transferable3d_tpu.train import train_loop as jloop
from transferable3d_torch.core import bins as tbins
from transferable3d_torch.models import layers as tlayers
from transferable3d_torch.models import registry
from transferable3d_torch.utils import bridge

pytestmark = pytest.mark.usefixtures("one_torch_thread")
CFG = jbins.SUNRGBD
B, N = 8, 128
POINT_HALVES = np.r_[N // 2:N, 0:N // 2]
BATCH_HALVES = np.r_[B // 2:B, 0:B // 2]
STEP_WEIGHTS = dict(OPEN_GATE, size_cls=0.0)


def _mesh():
    return jmesh.data_points_mesh(2, 2, jax.devices()[:4])


def _jax_run(fn, mesh, state, *batches):
    """`fn` jitted on the mesh: the state replicated, the batches sharded
    on both axes."""
    return jax.jit(fn)(jmesh.replicate(state, mesh),
                       *(jmesh.shard_batch(b, mesh) for b in batches))


def _keep(out, inp):
    """A keep mask from a dropout's output and input: kept where the
    output is nonzero or the input was zero."""
    return torch.from_numpy((np.asarray(out) != 0) | (np.asarray(inp) == 0))


def _outcome(loss, grads, params, stats):
    return {"metrics": {"total_loss": float(loss)},
            "grads": to_numpy_tree(grads), "params": to_numpy_tree(params),
            "stats": to_numpy_tree(stats)}


def readings(ref, got, nets, noise=(), loss="total_loss"):
    """Gaps of `got` from `ref`: the loss (relative), the gradient without
    the `noise` leaves (relative L2, cosine, and the cosine of each of
    `nets`, path prefixes), the BN statistics and the whole gradient's
    norm ratio (`points_readings`)."""
    gr, gg = tree_leaves(ref["grads"]), tree_leaves(got["grads"])
    keys = sorted(k for k in gr if k not in set(noise))
    a, b = _concat(gr, keys), _concat(gg, keys)
    out = {"loss": abs(float(got["metrics"][loss])
                       - float(ref["metrics"][loss]))
           / abs(float(ref["metrics"][loss])),
           "grad": float(np.linalg.norm(b - a) / np.linalg.norm(a)),
           "cos": _cos(a, b)}
    for net in nets:
        ks = [k for k in keys if k.startswith(net + "/")]
        out[net] = _cos(_concat(gr, ks), _concat(gg, ks))
    pr = points_readings(ref, got)
    out.update(stats=pr["stats"], norm=pr["norm"])
    return out


def with_box_cotangent(read, ref, got, rows=slice(None), order=None):
    """`read` and "box_cot": the relative L2 gap of the predicted box's
    cotangent from the weak losses (`torch_dp_ranks.box_cotangent`) on
    `got`'s rows of the batch (`rows` of `ref`'s; `order`: `got` ran on
    the frustums in that order)."""
    want, have = ref["box_cotangent"][rows], got["box_cotangent"]
    if order is not None:
        have = have[np.argsort(order)]
    return {**read, "box_cot": float(np.linalg.norm(have - want)
                                     / np.linalg.norm(want))}


def fails(r, limits):
    """`test_torch_parallel.fails`, with "box_cot" a gap (an upper
    bound)."""
    bad = _fails({k: v for k, v in r.items() if k != "box_cot"},
                 {k: v for k, v in limits.items() if k != "box_cot"})
    if "box_cot" in limits and r["box_cot"] > limits["box_cot"]:
        bad.append("box_cot")
    return bad


def judge(what, limits, runs, controls):
    """`test_torch_parallel.judge` with the readings at 7 digits (the
    cosines' gaps from 1 show)."""
    print(f"{what}; limits {limits}")
    for tag, r in {**runs, **controls}.items():
        print(f"  {tag}: " + ", ".join(f"{k} {v:.7g}" for k, v in r.items())
              + f"; fails {fails(r, limits) or 'no limit'}")
    for tag, r in runs.items():
        assert not fails(r, limits), (tag, fails(r, limits))
    for tag, r in controls.items():
        assert fails(r, limits), f"control {tag} passes every limit"


def assert_params_close(jax_params, port, atol=5e-3):
    """The parameters after one step within `atol` of JAX's
    (`tests/test_points_sharding.py`)."""
    want, got = tree_leaves(jax_params), tree_leaves(port["params"])
    assert sorted(want) == sorted(got)
    worst = max(float(np.abs(got[k] - v).max()) for k, v in want.items())
    print(f"parameters after one step: largest gap {worst:.3g}")
    assert worst <= atol


def _check_ranks_agree(res):
    """Every rank holds the same loss and gradient as the last."""
    last = res[-1][0]
    for r in res[:-1]:
        assert float(r[0]["metrics"]["total_loss"]) == float(
            last["metrics"]["total_loss"])
        for k, v in tree_leaves(r[0]["grads"]).items():
            np.testing.assert_array_equal(
                v, tree_leaves(last["grads"])[k], err_msg=k)


# ---------------------------------------------------------------------------
# Phase A: the BoxPC step
# ---------------------------------------------------------------------------

def _jax_boxpc_step(batch, aniso, mesh):
    """JAX's phase-A step on the mesh from `create_boxpc_state` (BN
    statistics perturbed): its loss, gradient, new parameters and
    statistics, and its draws and head keep masks (the port's inputs)."""
    jm = jboxpc.BoxPCFitNet(cfg=CFG)
    lr = jsched.exponential_staircase_lr(base_lr=1e-3, batch_size=B)
    bn = jsched.bn_momentum_schedule(batch_size=B)
    tx = jloop.make_optimizer(lr)
    state = jsemi.create_boxpc_state(jm, CFG, tx, batch, seed=0)
    _, stats = init_flax(jm, 0, batch["points"],
                         jsemi.gt_boxes_from_batch(batch, CFG), train=False)
    params0 = to_numpy_tree(state.params)
    rng = jax.random.fold_in(state.rng, state.step)
    sample_rng, dropout_rng, aug_rng = jax.random.split(rng, 3)

    def fn(st, batch):
        params, stats, opt_state = st

        def loss_fn(params):
            gt = jsemi.gt_boxes_from_batch(batch, CFG)
            points, gt = jsemi.anisotropic_shape_aug(
                aug_rng, batch["points"], gt, log_range=aniso)
            perturbed = jboxpc.sample_perturbed_boxes(sample_rng, gt)
            targets = jboxpc.boxpc_targets(perturbed, gt)
            out, upd = jm.apply(
                {"params": params, "batch_stats": stats}, points,
                perturbed, train=True, bn_momentum=bn(0),
                rngs={"dropout": dropout_rng},
                mutable=["batch_stats", "intermediates"],
                capture_intermediates=lambda mdl, _: mdl.name in _HEAD)
            losses = jboxpc.boxpc_loss(out, targets)
            head = upd["intermediates"]["head"]
            return losses["total_loss"], (
                losses, upd["batch_stats"],
                {k: head[k]["__call__"][0] for k in _HEAD})

        grads, (losses, new_stats, inter) = jax.grad(
            loss_fn, has_aux=True)(params)
        upd, _ = tx.update(grads, opt_state, params)
        return (losses, grads, optax.apply_updates(params, upd), new_stats,
                inter)

    losses, grads, params, new_stats, inter = _jax_run(
        fn, mesh, (state.params, stats, state.opt_state), batch)
    draws = {"sample": _t(_jax_perturbation_draws(sample_rng, B)),
             "aug": _t(_jax_aug_draws(aug_rng, B, aniso)),
             "keep": [_keep(inter[f"dp_{i}"],
                            np.maximum(np.asarray(inter[f"bn_{i}"]), 0))
                      for i in range(2)]}
    return (params0, stats, draws,
            _outcome(losses["total_loss"], grads, params, new_stats))


def test_boxpc_step_on_a_points_mesh_equals_jax_mesh_and_one_rank():
    """Phase A on (2, 2), JAX's draws and head masks injected: the point
    MLP on each rank's points with BN over every rank, the pool across
    the points group, the head and the loss over the data group.
    Limits against JAX: loss 1e-4, every cosine 0.99999; against one
    rank: loss 1e-5, gradient 1e-4, statistics 1e-4, norm within 1e-4.
    Measured on the CPU against JAX: (2, 2) loss 7.6e-8, gradient
    2.0e-6, every cosine 1 to 7 digits; 1 rank 2.3e-7, 2.1e-6; the
    witness 0, 1.9e-6. Against one rank: (2, 2) 1.5e-7, 1.5e-6,
    statistics 5.6e-7, the witness 2.3e-7, 1.4e-6, 8.1e-7; the controls:
    a per-shard pool 9.6e-2, 1.0 (cosine 0.47), per-shard BN 9.1e-2, 1.5
    (0.17)."""
    batch = strong_batch(n=B, npoints=N, seed=2)
    params0, stats0, draws, jax_out = _jax_boxpc_step(batch, 0.8, _mesh())
    model = registry.get_model("boxpc_fit", tbins.SUNRGBD, device="cpu")
    bridge.load_flax_variables(model, params0, stats0)
    spec = dict(state_dict=model.state_dict(), batch=batch, seed=0,
                aniso=0.8, draws=draws)
    controls = [("local_pool",), ("local_bn",)]
    job = ranks.Ranks(ranks.steps, 4, ranks.boxpc_step, spec,
                      [()] + controls, points=2)
    one = ranks.boxpc_step(spec)
    witness = ranks.boxpc_step(spec, points_order=POINT_HALVES)
    res = job.results()
    _check_ranks_agree(res)
    mesh = res[-1][0]
    assert_params_close(jax_out["params"], mesh)
    np.testing.assert_allclose(float(mesh["metrics"]["total_loss"]),
                               jax_out["metrics"]["total_loss"], rtol=1e-4)
    assert sorted(mesh["metrics"]) == sorted(one["metrics"])
    nets = ("mlp", "head")
    judge("BoxPC step f32, port vs JAX's (2, 2) points mesh",
          {"loss": 1e-4, "cos": 0.99999, "mlp": 0.99999, "head": 0.99999},
          {"port (2, 2)": readings(jax_out, mesh, nets),
           "port 1 rank": readings(jax_out, one, nets),
           "witness: port 1 rank on the point halves swapped":
               readings(jax_out, witness, nets)}, {})
    noise = boxpc_noise_leaves(tree_leaves(one["grads"]))
    judge("BoxPC step f32, port (2, 2) vs port 1 rank",
          {"loss": 1e-5, "grad": 1e-4, "stats": 1e-4,
           "norm": (1 - 1e-4, 1 + 1e-4)},
          {"(2, 2)": readings(one, mesh, nets, noise),
           "witness: 1 rank on the point halves swapped":
               readings(one, witness, nets, noise)},
          {f"control {f[0]}": readings(one, res[-1][i], nets, noise)
           for i, f in enumerate(controls, 1)})


def test_boxpc_draws_on_a_points_mesh_are_the_one_rank_draws_rows():
    """On (2, 2) the BoxPC step draws the whole batch (B rows, not B x
    P) from its generator and each rank keeps its data index's rows: the
    perturbation and aug draws are the 1-rank step's rows, and the aug's
    points (a per-point scaling by each frustum's draws) are the 1-rank
    step's block, rows and point slice."""
    batch = strong_batch(n=B, npoints=N, seed=2)
    model = registry.get_model("boxpc_fit", tbins.SUNRGBD, device="cpu")
    spec = dict(state_dict=model.state_dict(), batch=batch, seed=7,
                aniso=0.8)
    job = ranks.Ranks(ranks.boxpc_draws, 4, spec, points=2)
    one = ranks.boxpc_draws(None, spec)
    for r, got in enumerate(job.results()):
        d, p = divmod(r, 2)
        rows = slice(d * B // 2, (d + 1) * B // 2)
        for a, b in zip(got["sample"] + got["aug"],
                        one["sample"] + one["aug"]):
            assert torch.equal(a, b[rows]), r
        want = one["points"][rows, p * N // 2:(p + 1) * N // 2]
        assert torch.equal(got["points"], want), r


# ---------------------------------------------------------------------------
# Phase B: the semi-supervised step on the v1 backbone
# ---------------------------------------------------------------------------

def _semisup_margin(spec):
    """1 + twice the largest foreground-logit gap of train-mode forwards
    on both batches (`test_torch_points_parallel._margin`)."""
    probe = ranks._model(spec).train()
    gaps = []
    for batch, keep in ((spec["batch"], spec["keep"][0]),
                        (spec["weak"], spec["keep"][1])):
        with ranks.keep_masks([keep]), torch.no_grad():
            logits = probe(torch.from_numpy(batch["points"]),
                           torch.from_numpy(batch["one_hot"]), 0.5,
                           torch.Generator())["seg_logits"].float()
        gaps.append(float((logits[..., 1] - logits[..., 0]).abs().max()))
    return 1.0 + 2.0 * max(gaps)


def _jax_semisup_step(strong, weak, det_params, det_stats, bp_params,
                      bp_stats, mesh):
    """JAX's phase-B step (v1 f32, the detector's weights given) on the
    mesh: the combined loss, gradient, new parameters and statistics
    (strong then weak pass), both passes' seg-net keep masks and
    predicted masks."""
    det = FrustumPointNetV1(cfg=CFG, num_object_point=N)
    bp = jboxpc.BoxPCFitNet(cfg=CFG)
    lr = jsched.exponential_staircase_lr(base_lr=1e-3, batch_size=B)
    bn = jsched.bn_momentum_schedule(batch_size=B)
    tx = jloop.make_optimizer(lr)
    state = jloop.create_train_state(det, CFG, tx, strong, seed=0)
    r_s, r_w = jax.random.split(jax.random.fold_in(state.rng, state.step))
    weights = jsemi.WeakLossWeights(**STEP_WEIGHTS)

    def fn(st, strong, weak):
        params, stats, opt_state, bvars = st

        def run(params, stats, batch, r):
            ep, upd = det.apply(
                {"params": params, "batch_stats": stats}, batch["points"],
                batch["one_hot"], train=True, bn_momentum=bn(0),
                rngs={"dropout": r},
                mutable=["batch_stats", "intermediates"],
                capture_intermediates=lambda m, _: m.name in ("dp", "mlp3"))
            seg = upd["intermediates"]["seg_net"]
            return ep, upd["batch_stats"], (seg["dp"]["__call__"][0],
                                            seg["mlp3"]["__call__"][0])

        def loss_fn(params):
            ep_s, stats_s, dps = run(params, stats, strong, r_s)
            sup = jmu.get_loss(ep_s, jloop.labels_from_batch(strong), CFG)
            ep_w, stats_w, dpw = run(params, stats_s, weak, r_w)
            wk = jsemi.weak_losses(ep_w, weak, bp, bvars, CFG, weights)
            total = sup["total_loss"] + wk["weak_total_loss"]
            return total, (total, stats_w, dps, dpw, ep_s["mask"],
                           ep_w["mask"])

        grads, aux = jax.grad(loss_fn, has_aux=True)(params)
        upd, _ = tx.update(grads, opt_state, params)
        return grads, optax.apply_updates(params, upd), aux

    bvars = {"params": bp_params, "batch_stats": bp_stats}
    grads, params, (total, new_stats, dps, dpw, mask_s, mask_w) = _jax_run(
        fn, mesh, (det_params, det_stats, state.opt_state, bvars), strong,
        weak)
    out = _outcome(total, grads, params, new_stats)
    out["metrics"]["combined_loss"] = out["metrics"]["total_loss"]
    return ([_keep(*dps), _keep(*dpw)],
            {**out, "masks": [np.asarray(mask_s), np.asarray(mask_w)]})


def test_phase_b_step_on_a_points_mesh_equals_jax_mesh_and_one_rank():
    """Phase B (v1 f32) on (2, 2): both passes on each rank's points, the
    box stages and the weak losses per frustum over the data group,
    BoxPC frozen on the rank's points with the whole predicted box, its
    cotangent of the box summed over the points group. Every point
    masked past a margin (both packages' foreground bias raised),
    JAX's seg-net masks injected. Limits against JAX: loss 1e-4, every
    cosine 0.9999 (`tests/test_torch_semisup.py`'s 1-device limit);
    against one rank: loss 1e-5, gradient 1e-3, statistics 1e-4, norm
    within 1e-4, and the cotangent of the predicted box from the weak
    losses (`box_cot`) 1e-3. Measured on the CPU against JAX: (2, 2)
    loss 3.5e-6, gradient 7.2e-3, cosine 0.999975 (seg net 1, T-Net
    0.999968, box net 0.9999988), as the port's 1 rank and the witness.
    Against one rank: (2, 2) 9.8e-8, 1.3e-5, statistics 2.8e-6,
    `box_cot` 1.4e-5; the witness 1.3e-6, 1.1e-5, 3.1e-6, 5.3e-6; the
    controls: a per-shard pool 5.2e-3, 1.2e-2 (seg net 0.51), per-shard
    BN 0.13, 2.2, the box's cotangent unsummed a gradient gap of 1.5e-2,
    norm 1.00012, `box_cot` 0.46."""
    strong = strong_batch(n=B, npoints=N, seed=3)
    weak = weak_batch(seed=4)
    det = FrustumPointNetV1(cfg=CFG, num_object_point=N)
    tx = jloop.make_optimizer(jsched.exponential_staircase_lr())
    state = jloop.create_train_state(det, CFG, tx, strong, seed=0)
    params, stats = (to_numpy_tree(state.params),
                     to_numpy_tree(state.batch_stats))
    bp = jboxpc.BoxPCFitNet(cfg=CFG)
    bp_state = jsemi.create_boxpc_state(bp, CFG, tx, strong, seed=1)
    bp_params = to_numpy_tree(bp_state.params)
    bp_stats = perturb_stats(to_numpy_tree(bp_state.batch_stats),
                             np.random.RandomState(8))
    tdet = registry.get_model("frustum_pointnets_v1", tbins.SUNRGBD,
                              device="cpu", in_channels=4,
                              num_object_point=N)
    tbp = registry.get_model("boxpc_fit", tbins.SUNRGBD, device="cpu")
    bridge.load_flax_variables(tbp, bp_params, bp_stats)
    gen = torch.Generator().manual_seed(5)
    spec = dict(name="frustum_pointnets_v1", dtype=torch.float32,
                boxpc=tbp.state_dict(), batch=strong, weak=weak, nobj=N,
                keep=[tlayers.dropout_keep_mask((B, N, 128), 0.5, gen)
                      for _ in range(2)], weights=STEP_WEIGHTS)
    bridge.load_flax_variables(tdet, params, stats)
    spec["state_dict"] = tdet.state_dict()
    params["seg_net"]["seg_out"]["bias"][1] += _semisup_margin(spec)
    bridge.load_flax_variables(tdet, params, stats)
    spec["state_dict"] = tdet.state_dict()
    spec["keep"], jax_out = _jax_semisup_step(
        strong, weak, params, stats, bp_params, bp_stats, _mesh())
    controls = [("local_pool",), ("local_bn",), ("box_cotangent_unsummed",)]
    job = ranks.Ranks(ranks.steps, 4, ranks.semisup_step, spec,
                      [()] + controls, points=2)
    one = ranks.semisup_step(spec)
    witness = ranks.semisup_step(spec, points_order=POINT_HALVES)
    res = job.results()
    assert all(m.all() for m in jax_out["masks"] + one["masks"])
    _check_ranks_agree(res)
    mesh = res[-1][0]
    assert_params_close(jax_out["params"], mesh)
    np.testing.assert_allclose(float(mesh["metrics"]["combined_loss"]),
                               jax_out["metrics"]["combined_loss"],
                               rtol=1e-4)
    assert sorted(mesh["metrics"]) == sorted(one["metrics"])
    assert 0 < float(one["metrics"]["weak_trust_frac"]) <= 1
    nets = ("seg_net", "tnet", "box_net")
    rows = slice(B // 2, B)  # the last rank's: data index 1
    noise = zero_gradient_leaves(tree_leaves(one["grads"]), pooled=False)
    judge("phase-B step v1 f32, port vs JAX's (2, 2) points mesh",
          {"loss": 1e-4, "cos": 0.9999, "seg_net": 0.9999, "tnet": 0.9999,
           "box_net": 0.9999},
          {f"port {tag}": readings(jax_out, r, nets, noise, "combined_loss")
           for tag, r in (("(2, 2)", mesh), ("1 rank", one),
                          ("witness: 1 rank, point halves swapped",
                           witness))}, {})
    judge("phase-B step v1 f32, port (2, 2) vs port 1 rank",
          {"loss": 1e-5, "grad": 1e-3, "stats": 1e-4,
           "norm": (1 - 1e-4, 1 + 1e-4), "box_cot": 1e-3},
          {"(2, 2)": with_box_cotangent(
              readings(one, mesh, nets, noise, "combined_loss"), one, mesh,
              rows),
           "witness: 1 rank on the point halves swapped": with_box_cotangent(
               readings(one, witness, nets, noise, "combined_loss"), one,
               witness)},
          {f"control {f[0]}": with_box_cotangent(
              readings(one, res[-1][i], nets, noise, "combined_loss"), one,
              res[-1][i], rows)
           for i, f in enumerate(controls, 1)})


# ---------------------------------------------------------------------------
# BoxEstimationOnly
# ---------------------------------------------------------------------------

def _jax_box_only_step(batch, mesh):
    """JAX's train step of `BoxEstimationOnly` (f32) on the mesh from
    `create_train_state`: its loss, gradient, new parameters and
    statistics, and the step-0 weights."""
    jm = BoxEstimationOnly(cfg=CFG)
    lr = jsched.exponential_staircase_lr(batch_size=B)
    bn = jsched.bn_momentum_schedule(batch_size=B)
    tx = jloop.make_optimizer(lr)
    state = jloop.create_train_state(jm, CFG, tx, batch, seed=0)
    stats0 = perturb_stats(to_numpy_tree(state.batch_stats),
                           np.random.RandomState(3))

    def fn(st, batch):
        params, stats, opt_state = st

        def loss_fn(params):
            ep, upd = jm.apply({"params": params, "batch_stats": stats},
                               batch["points"], batch["one_hot"],
                               train=True, bn_momentum=bn(0),
                               mutable=["batch_stats"])
            loss = jmu.get_loss(ep, jloop.labels_from_batch(batch),
                                CFG)["total_loss"]
            return loss, (loss, upd["batch_stats"])

        grads, (loss, new_stats) = jax.grad(loss_fn, has_aux=True)(params)
        upd, _ = tx.update(grads, opt_state, params)
        return loss, grads, optax.apply_updates(params, upd), new_stats

    out = _jax_run(fn, mesh, (state.params, stats0, state.opt_state), batch)
    return to_numpy_tree(state.params), stats0, _outcome(*out)


def test_box_estimation_only_step_on_a_points_mesh_equals_jax_mesh():
    """`BoxEstimationOnly`'s train step on (2, 2): the centroid the whole
    frustum's mean, the box net's point MLP on each rank's points with
    BN over every rank, its pool across the points group, its head over
    the data group. Limits against JAX: loss 1e-4, every cosine
    0.99999; against one rank: loss 1e-5, gradient 1e-4, statistics
    1e-4, norm within 1e-4. Measured on the CPU against JAX: (2, 2) loss
    2.1e-7, gradient 6.6e-6, every cosine 1 to 4 digits; 1 rank 5.6e-7,
    6.6e-6; the witness 8.4e-7, 2.2e-5. Against one rank: (2, 2) 3.5e-7,
    5.0e-6, statistics 4.4e-6; the witness 2.8e-7, 2.1e-5, 3.0e-6; the
    controls: a per-shard pool 0.12, 1.2 (cosine 0.21), per-shard BN
    6.1e-2, 1.7 (0.08)."""
    batch = synthetic_step_batch(B, N)
    params0, stats0, jax_out = _jax_box_only_step(batch, _mesh())
    model = registry.get_model("box_estimation_v1", tbins.SUNRGBD,
                               device="cpu")
    bridge.load_flax_variables(model, params0, stats0)
    spec = dict(name="box_estimation_v1", dtype=torch.float32,
                state_dict=model.state_dict(), batch=batch, keep=None,
                nobj=None)
    controls = [("local_pool",), ("local_bn",)]
    job = ranks.Ranks(ranks.steps, 4, ranks.train_step, spec,
                      [()] + controls, points=2)
    one = ranks.train_step(spec)
    witness = ranks.train_step(spec, points_order=POINT_HALVES)
    res = job.results()
    _check_ranks_agree(res)
    mesh = res[-1][0]
    assert_params_close(jax_out["params"], mesh)
    np.testing.assert_allclose(float(mesh["metrics"]["total_loss"]),
                               jax_out["metrics"]["total_loss"], rtol=1e-4)
    nets = ("box_net/mlp", "box_net/head")
    noise = zero_gradient_leaves(tree_leaves(one["grads"]), pooled=False)
    judge("BoxEstimationOnly f32, port vs JAX's (2, 2) points mesh",
          {"loss": 1e-4, "cos": 0.99999, "box_net/mlp": 0.99999,
           "box_net/head": 0.99999},
          {f"port {tag}": readings(jax_out, r, nets, noise)
           for tag, r in (("(2, 2)", mesh), ("1 rank", one),
                          ("witness: 1 rank, point halves swapped",
                           witness))}, {})
    judge("BoxEstimationOnly f32, port (2, 2) vs port 1 rank",
          {"loss": 1e-5, "grad": 1e-4, "stats": 1e-4,
           "norm": (1 - 1e-4, 1 + 1e-4)},
          {"(2, 2)": readings(one, mesh, nets, noise),
           "witness: 1 rank on the point halves swapped":
               readings(one, witness, nets, noise)},
          {f"control {f[0]}": readings(one, res[-1][i], nets, noise)
           for i, f in enumerate(controls, 1)})


# ---------------------------------------------------------------------------
# Phase B with the v2 detector, port only
# ---------------------------------------------------------------------------

def _v2_semisup_spec(dtype):
    """Phase B of a v2 detector in `dtype` (bf16: the fused chain) from
    seeded weights, with a frozen BoxPC, the trust gate open and every
    point masked past a margin (the box net's input snapped)."""
    strong = strong_batch(n=B, npoints=N, seed=5)
    weak = weak_batch(seed=6, calib=False)
    model = registry.get_model(
        "frustum_pointnets_v2", tbins.SUNRGBD, dtype=dtype, device="cpu",
        in_channels=4, num_object_point=64,
        generator=torch.Generator().manual_seed(0))
    bp = registry.get_model("boxpc_fit", tbins.SUNRGBD, device="cpu",
                            generator=torch.Generator().manual_seed(1))
    gen = torch.Generator().manual_seed(6)
    spec = dict(name="frustum_pointnets_v2", dtype=dtype,
                state_dict=model.state_dict(), boxpc=bp.state_dict(),
                batch=strong, weak=weak, nobj=64, fused=True,
                keep=[tlayers.dropout_keep_mask((B, N, 128), 0.5, gen)
                      for _ in range(2)], weights=STEP_WEIGHTS)
    spec["margin"] = _semisup_margin(spec)
    return spec


def _v2_readings(one, got, rows=slice(None), order=None):
    return with_box_cotangent(
        readings(one, got, ("seg_net", "tnet", "box_net"),
                 loss="combined_loss"), one, got, rows, order)


def test_phase_b_v2_bf16_fused_step_on_a_points_mesh_equals_one_rank(
        monkeypatch):
    """Phase B through the fused chain (the plain twins of K1, K5-K9) on
    (1, 2), port only (no interpret-mode JAX, as
    `test_torch_semisup.test_semisup_step_v2_bf16_fused_two_passes_port`):
    each rank runs the chain's forward 16 times (two passes of 8 scales) and its
    first backward step 10 times (the strong pass's 8 scales and the weak
    pass's box net), at its centroid slice. Limits:
    `test_torch_points_parallel`'s v2 limits and the cotangent of the
    predicted box from the weak losses (`box_cot`) within 0.15. Measured
    on the CPU: loss 9.2e-7, cosine 0.9999991 (seg net 0.965, T-Net and
    box net 1: they see the 1-rank step's object points), statistics
    5.3e-3, `box_cot` 5.7e-8; the witness (the batch's halves swapped:
    v2's FPS starts at point 0) 3.6e-4, 0.976 (0.964, 0.52, 0.999),
    4.4e-3, 5.8e-2; the box's cotangent unsummed over the points group
    `box_cot` 0.36 (its cosines 0.9997: the weak losses' share of the
    gradient is small)."""
    monkeypatch.delenv("T3D_FUSED_SA", raising=False)
    spec = _v2_semisup_spec(torch.bfloat16)
    controls = [("box_cotangent_unsummed",)]
    job = ranks.Ranks(ranks.steps, 2, ranks.semisup_step, spec,
                      [()] + controls, points=2)
    one = ranks.semisup_step(spec)
    witness = ranks.semisup_step(spec, order=BATCH_HALVES)
    res = job.results()
    assert all(m.all() for m in one["masks"])
    want = {"sa_extract": 16, "sa_bwd_step0": 10}
    assert one["calls"] == want
    for r in res:
        assert r[0]["calls"] == want
    _check_ranks_agree(res)
    judge("phase-B step v2 bf16 fused, port (1, 2) vs port 1 rank",
          {"loss": 1e-2, "cos": 0.9, "seg_net": 0.95, "tnet": 0.4,
           "box_net": 0.95, "stats": 5e-2, "norm": (0.9, 1.1),
           "box_cot": 0.15},
          {"(1, 2)": _v2_readings(one, res[-1][0]),
           "witness: 1 rank on the batch's halves swapped":
               _v2_readings(one, witness, order=BATCH_HALVES)},
          {f"control {f[0]}": _v2_readings(one, res[-1][i])
           for i, f in enumerate(controls, 1)})


def test_phase_b_v2_f32_step_on_a_points_mesh_equals_one_rank():
    """Phase B of v2 in float32 (the unfused path) on (2, 2), port only:
    without bf16's roundings the step is the 1-rank step's to summation
    order, the weak losses' box cotangent included (on the card the bf16
    step's weak losses amplify the roundings of the predicted box; chip
    smoke phase 32). Limits: loss 1e-5, gradient 1e-3, statistics 1e-4,
    norm within 1e-4, `box_cot` 1e-3. Measured on the CPU: loss 4.3e-7,
    gradient 1.3e-4 (seg net cosine 0.99995), statistics 2.2e-6,
    `box_cot` 1.8e-5; the witness (the batch's halves swapped) 8.5e-8,
    1.6e-4, 2.5e-6, 3.1e-5; the controls: per-shard BN 4.4e-2, 1.8, 0.81,
    1.05, the box's cotangent unsummed a gradient gap of 2.0e-2, norm
    1.0019, `box_cot` 0.19."""
    spec = _v2_semisup_spec(torch.float32)
    controls = [("local_bn",), ("box_cotangent_unsummed",)]
    job = ranks.Ranks(ranks.steps, 4, ranks.semisup_step, spec,
                      [()] + controls, points=2)
    one = ranks.semisup_step(spec)
    witness = ranks.semisup_step(spec, order=BATCH_HALVES)
    res = job.results()
    assert all(m.all() for m in one["masks"])
    _check_ranks_agree(res)
    rows = slice(B // 2, B)  # the last rank's: data index 1
    judge("phase-B step v2 f32, port (2, 2) vs port 1 rank",
          {"loss": 1e-5, "grad": 1e-3, "stats": 1e-4,
           "norm": (1 - 1e-4, 1 + 1e-4), "box_cot": 1e-3},
          {"(2, 2)": _v2_readings(one, res[-1][0], rows),
           "witness: 1 rank on the batch's halves swapped":
               _v2_readings(one, witness, order=BATCH_HALVES)},
          {f"control {f[0]}": _v2_readings(one, res[-1][i], rows)
           for i, f in enumerate(controls, 1)})
