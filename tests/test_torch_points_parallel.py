"""Points-axis sharding of the port (`parallel/mesh.data_points_mesh`)
against the JAX package's (data, points) mesh and against the port's own
one rank.

The ranks are spawned processes on the CPU (gloo, `file://` rendezvous,
one torch thread a rank; `torch_dp_ranks`), on 8 frustums of 128 points
as `tests/test_points_sharding.py`. JAX's side is
`transferable3d_tpu/parallel/mesh.py`'s `data_points_mesh` on the
8-device virtual CPU mesh (tests/conftest.py): one jitted function.

Every comparison states its limits beside a noise witness and controls
that must each fail one of them: a per-shard max-pool (`local_pool`),
per-shard BN statistics (`local_bn`), masking on the rank's points alone
(`local_masking`) and the box stages' gradients summed over every rank
(`box_grads_everywhere`). v1's witness is the 1-rank step on each
frustum's point halves swapped: every point masked and as many object
points as points make its step a permutation of the frustum's points.
v2's FPS starts at point 0, so swapping points changes its function; its
witness swaps the batch's halves, as `tests/test_torch_parallel.py`.
"""

import numpy as np
import pytest
import torch

import jax
import torch_dp_ranks as ranks
from test_torch_parallel import judge, readings
from torch_parity import (one_torch_thread,  # noqa: F401
                          synthetic_step_batch, to_numpy_tree, tree_leaves)
from transferable3d_tpu.core import bins as jbins
from transferable3d_tpu.models.frustum_pointnet_v1 import FrustumPointNetV1
from transferable3d_tpu.parallel import mesh as jmesh
from transferable3d_tpu.train import schedules as jsched
from transferable3d_tpu.train import train_loop as jloop
from transferable3d_torch.core import bins as tbins
from transferable3d_torch.models import layers as tlayers
from transferable3d_torch.models import registry
from transferable3d_torch.parallel import mesh as tmesh
from transferable3d_torch.utils import bridge

pytestmark = pytest.mark.usefixtures("one_torch_thread")
CFG = jbins.SUNRGBD
B, N = 8, 128
POINT_HALVES = np.r_[N // 2:N, 0:N // 2]
BATCH_HALVES = np.r_[B // 2:B, 0:B // 2]
CONTROLS = [("local_pool",), ("local_bn",), ("local_masking",),
            ("box_grads_everywhere",)]


def points_readings(ref, got):
    """`test_torch_parallel.readings`, with the BN running statistics read
    in the units they normalise: a mean's largest gap over its layer's
    largest running std, a variance's over its largest value (a mean that
    is zero in exact arithmetic, as the T-Net's first over points centred
    on their centroid, is rounding noise against its own size); and the
    whole gradient's norm over the reference's."""
    out = readings(ref, got)
    sr, sg = tree_leaves(ref["stats"]), tree_leaves(got["stats"])
    gaps = []
    for k, v in sr.items():
        scale = np.abs(v).max()
        if k.endswith("/mean"):
            scale = np.sqrt(sr[k[:-len("mean")] + "var"]).max()
        gaps.append(float(np.abs(sg[k] - v).max() / max(scale, 1e-30)))
    out["stats"] = max(gaps)
    gr, gg = tree_leaves(ref["grads"]), tree_leaves(got["grads"])
    out["norm"] = float(
        np.sqrt(sum(np.sum(gg[k].astype(np.float64) ** 2) for k in gr))
        / np.sqrt(sum(np.sum(gr[k].astype(np.float64) ** 2) for k in gr)))
    return out


def _margin(spec):
    """1 + twice the largest foreground-logit gap of a train-mode forward:
    raised by it, the foreground logit masks every point past any
    rounding."""
    probe = ranks._model(spec).train()
    batch = spec["batch"]
    with ranks.keep_masks([spec["keep"]]), torch.no_grad():
        logits = probe(torch.from_numpy(batch["points"]),
                       torch.from_numpy(batch["one_hot"]), 0.5,
                       torch.Generator())["seg_logits"].float()
    return 1.0 + 2.0 * float((logits[..., 1] - logits[..., 0]).abs().max())


# ---------------------------------------------------------------------------
# The collectives
# ---------------------------------------------------------------------------

def test_points_max_and_gather_match_one_rank_with_ties():
    """`points_max` equals `torch.amax` over the whole axis, and its
    gradient (the two ranks' halves of the loss) is `torch.amax`'s: the
    cotangent split evenly among the tied maxima of every shard (dyadic
    values: exact). `points_gather` returns the whole axis and its
    gradient is the summed cotangent's slice. Off a points mesh both are
    the identity."""
    outs = ranks.Ranks(ranks.collectives, 2, points=2).results()
    x = outs[0]["x"].clone().requires_grad_(True)
    y = x.amax(dim=1)
    torch.sum(outs[0]["w"] * y).backward()
    assert float(x.grad[0, 6, 0]) == float(x.grad[0, 7, 0]) == 0.125
    assert float(x.grad[0, 1, 1]) == float(x.grad[0, 5, 1]) != 0
    for r, out in enumerate(outs):
        assert torch.equal(out["max"], y.detach())
        assert torch.equal(out["gather"], out["v"])
    assert torch.equal(torch.cat([o["dmax"] for o in outs], dim=1), x.grad)
    assert torch.equal(torch.cat([o["dgather"] for o in outs], dim=1),
                       outs[0]["v"])
    z = torch.ones(2, 4, 3)
    assert tmesh.points_gather(z) is z and tmesh.points_slice(z) is z
    assert torch.equal(tmesh.points_max(z, dim=1), z.amax(dim=1))
    assert tmesh.points_size() == 1


# ---------------------------------------------------------------------------
# shard_batch against JAX's data_points_mesh
# ---------------------------------------------------------------------------

def test_shard_batch_equals_jax_data_points_mesh():
    """On a (2, 2) mesh rank r sits at (r // 2, r % 2), and its
    `shard_batch` block equals the addressable shard of JAX's
    `shard_batch` on `data_points_mesh(2, 2)`'s device r, key by key:
    the points and seg labels split on both axes, the label vectors
    (one-hot, center, ...) on the rows alone. `local_rows` is the same
    block."""
    batch = synthetic_step_batch(B, N)
    job = ranks.Ranks(ranks.points_sharding, 4, batch, points=2)
    mesh = jmesh.data_points_mesh(2, 2, jax.devices()[:4])
    sharded = jmesh.shard_batch(batch, mesh)
    spec = jax.sharding.PartitionSpec
    assert sharded["points"].sharding.spec == spec("data", "points")
    assert sharded["seg"].sharding.spec == spec("data", "points")
    assert sharded["center"].sharding.spec == spec("data")
    assert sharded["one_hot"].sharding.spec == spec("data")
    devices = list(mesh.devices.flat)
    outs = job.results()
    for r, out in enumerate(outs):
        assert out["coords"] == (r // 2, r % 2)
        assert sorted(out["rows"]) == sorted(batch)
        for k, arr in sharded.items():
            shard = next(s for s in arr.addressable_shards
                         if s.device == devices[r])
            np.testing.assert_array_equal(out["rows"][k],
                                          np.asarray(shard.data), err_msg=k)
            np.testing.assert_array_equal(out["local"][k], out["rows"][k])
    assert outs[3]["rows"]["points"].shape == (B // 2, N // 2, 4)


# ---------------------------------------------------------------------------
# One v1 float32 step: JAX's (2, 4) mesh, the port on (2, 2) and (1, 4)
# ---------------------------------------------------------------------------

def _jax_points_step(batch, params, stats):
    """JAX's v1 gradient on `data_points_mesh(2, 4)`, the batch sharded on
    both axes and the state replicated: the loss, gradient, seg-net
    dropout keep mask, predicted mask and updated BN statistics."""
    from torch_parity import _grads_and_dropout

    jm = FrustumPointNetV1(cfg=CFG, num_object_point=N)
    lr = jsched.exponential_staircase_lr(batch_size=B)
    bn = jsched.bn_momentum_schedule(batch_size=B)
    state = jloop.create_train_state(jm, CFG, jloop.make_optimizer(lr),
                                     batch, seed=0)
    mesh = jmesh.data_points_mesh(2, 4, jax.devices()[:8])
    params, stats = jmesh.replicate((params, stats), mesh)
    sbatch = jmesh.shard_batch(batch, mesh)
    rng = jax.random.fold_in(state.rng, state.step)

    def fn(params, stats, b):
        return _grads_and_dropout(jm, b, jloop.labels_from_batch(b), None,
                                  CFG, rng, "mlp3", params, stats, bn(0))

    grads, (dp_out, dp_in, mask, loss, new_stats) = jax.jit(fn)(
        params, stats, sbatch)
    keep = torch.from_numpy((np.asarray(dp_out) != 0)
                            | (np.asarray(dp_in) == 0))
    return keep, {"metrics": {"total_loss": float(loss)},
                  "grads": to_numpy_tree(grads),
                  "stats": to_numpy_tree(new_stats),
                  "masks": [np.asarray(mask)]}


def _v1_spec(batch):
    """v1 f32 from JAX's step-0 weights with the foreground bias raised
    past the margin, as the state_dict both packages start from."""
    jm = FrustumPointNetV1(cfg=CFG, num_object_point=N)
    state = jloop.create_train_state(
        jm, CFG, jloop.make_optimizer(jsched.exponential_staircase_lr()),
        batch, seed=0)
    params, stats = (to_numpy_tree(state.params),
                     to_numpy_tree(state.batch_stats))
    model = registry.get_model("frustum_pointnets_v1", tbins.SUNRGBD,
                               device="cpu", in_channels=4,
                               num_object_point=N)
    bridge.load_flax_variables(model, params, stats)
    keep = tlayers.dropout_keep_mask((B, N, 128), 0.5,
                                     torch.Generator().manual_seed(5))
    spec = dict(name="frustum_pointnets_v1", dtype=torch.float32,
                state_dict=model.state_dict(), batch=batch, keep=keep,
                nobj=N)
    margin = _margin(spec)
    params["seg_net"]["seg_out"]["bias"][1] += margin
    bridge.load_flax_variables(model, params, stats)
    spec["state_dict"] = model.state_dict()
    return spec, params, stats


def test_v1_f32_step_on_points_meshes_equals_jax_mesh_and_one_rank():
    """Against JAX's `data_points_mesh(2, 4)` step (JAX's mask as the
    port's seg-net dropout), the limits of tests/test_torch_train_step.py
    (loss 1e-4; gradient without its rounding-noise leaves relative L2
    1e-2 and cosine 0.9999; BN statistics 1e-3, here `points_readings`'
    own) on (2, 2) and (1, 4), the masks equal. Against the port's one
    rank: loss 1e-5, gradient 1e-3, statistics 1e-4, the whole
    gradient's norm within 1e-4; every rank holds the same gradient.
    Measured on the CPU against JAX: loss at most 9.9e-7, gradient
    2.6e-5, statistics 4.2e-6, the witness 3.5e-7, 1.1e-4, 4.2e-6.
    Against one rank: (2, 2) 2.8e-7, 2.7e-5, 3.3e-6; (1, 4) 0, 3.7e-8,
    2.1e-6; the witness 6.3e-7, 1.1e-4 (the T-Net's gradient, whose
    input is centred on a centroid summed in another order), 3.3e-6;
    the controls: a per-shard pool a gradient gap of 1.2e-2 (seg net
    cosine 0.39), per-shard BN 4.5, masking on the rank's points 1.6
    (seg net untouched), the box stages' gradients over every rank 1.0
    and a norm of 2 (counted twice)."""
    batch = synthetic_step_batch(B, N)
    spec, params, stats = _v1_spec(batch)
    keep, jax_out = _jax_points_step(batch, params, stats)
    spec["keep"] = keep
    meshes = {"(2, 2)": 2, "(1, 4)": 4}
    jobs = {tag: ranks.Ranks(ranks.steps, 4, ranks.train_step, spec,
                             [()] + (CONTROLS if p == 2 else []), points=p)
            for tag, p in meshes.items()}
    one = ranks.train_step(spec)
    witness = ranks.train_step(spec, points_order=POINT_HALVES)
    witness["masks"] = [witness["masks"][0][:, np.argsort(POINT_HALVES)]]
    outs = {tag: job.results() for tag, job in jobs.items()}

    assert one["masks"][0].all()
    np.testing.assert_array_equal(one["masks"][0], jax_out["masks"][0])
    port = {"1 rank": one}
    for tag, res in outs.items():
        port[tag] = res[-1][0]
        for r in range(len(res) - 1):
            for k, v in tree_leaves(res[r][0]["grads"]).items():
                np.testing.assert_array_equal(
                    v, tree_leaves(res[-1][0]["grads"])[k], err_msg=k)
        # The whole frustums' masks of each data index's rows.
        mask = np.concatenate([res[r][0]["masks"][0]
                               for r in range(0, 4, meshes[tag])])
        np.testing.assert_array_equal(mask, jax_out["masks"][0])
    judge("v1 f32 step, port vs JAX's (2, 4) points mesh",
          {"loss": 1e-4, "grad": 1e-2, "cos": 0.9999, "stats": 1e-3},
          {**{f"port {k}": points_readings(jax_out, v)
              for k, v in port.items()},
           "witness: port 1 rank on the point halves swapped":
               points_readings(jax_out, witness)}, {})
    judge("v1 f32 step, port on a points mesh vs port 1 rank",
          {"loss": 1e-5, "grad": 1e-3, "stats": 1e-4,
           "norm": (1 - 1e-4, 1 + 1e-4)},
          {"(2, 2)": points_readings(one, port["(2, 2)"]),
           "(1, 4)": points_readings(one, port["(1, 4)"]),
           "witness: 1 rank on the point halves swapped":
               points_readings(one, witness)},
          {f"control (2, 2) {f[0]}":
               points_readings(one, outs["(2, 2)"][-1][i])
           for i, f in enumerate(CONTROLS, 1)})


# ---------------------------------------------------------------------------
# v2 bf16 on the fused chain (plain twins of K1, K5-K9), port only
# ---------------------------------------------------------------------------

def _v2_spec():
    batch = synthetic_step_batch(B, N)
    model = registry.get_model(
        "frustum_pointnets_v2", tbins.SUNRGBD, dtype=torch.bfloat16,
        device="cpu", in_channels=4, num_object_point=64,
        generator=torch.Generator().manual_seed(0))
    keep = tlayers.dropout_keep_mask((B, N, 128), 0.5,
                                     torch.Generator().manual_seed(5))
    spec = dict(name="frustum_pointnets_v2", dtype=torch.bfloat16,
                state_dict=model.state_dict(), batch=batch, keep=keep,
                nobj=64, fused=True)
    spec["margin"] = _margin(spec)
    return spec


def test_v2_bf16_fused_step_on_points_meshes_equals_one_rank(monkeypatch):
    """The fused chain on each rank's centroids, its statistics and
    backward sums over every rank, the payload gathered and its gradient
    summed back. Pinned as `test_v2_bf16_fused_two_ranks_equal_one_rank`
    (every point masked past a margin, the box net's input on the 1/256
    grid), at its limits on the per-net cosines (all 0.9, seg net 0.95,
    T-Net 0.4, box net 0.95), statistics (5e-2) and the fused chains' BN
    gradient norm ratio ([0.9, 1.1]); the loss within 1e-2 and the whole
    gradient's norm within [0.9, 1.1]. Measured on the CPU: (1, 2) loss
    2.0e-5, seg net 0.961 (the box stages see the same points: 1.0); (2,
    2) 4.1e-3, 0.941 (0.965, 0.523, 0.978), statistics 1.2e-2, BN norm
    0.968, norm 0.996; the witness (the batch's halves swapped) 6.3e-3,
    0.956 (0.959, 0.619, 0.985), 1.6e-2, 0.989, 1.012 (a bf16 step's
    gradient is chaotic at a few frustums); the controls on (2, 2): a
    per-shard pool the seg net's cosine 0.49, per-shard BN every cosine
    below 0.3, masking on the rank's points the box net's 0.03, the box
    stages' gradients over every rank a norm of 1.99."""
    monkeypatch.delenv("T3D_FUSED_SA", raising=False)
    spec = _v2_spec()
    jobs = {"(2, 2)": ranks.Ranks(ranks.steps, 4, ranks.train_step, spec,
                                  [()] + CONTROLS, points=2),
            "(1, 2)": ranks.Ranks(ranks.steps, 2, ranks.train_step, spec,
                                  [()], points=2)}
    one = ranks.train_step(spec)
    witness = ranks.train_step(spec, order=BATCH_HALVES)
    outs = {tag: job.results() for tag, job in jobs.items()}
    assert all(m.all() for m in one["masks"])
    judge("v2 bf16 fused, points mesh vs 1 rank",
          {"loss": 1e-2, "cos": 0.9, "seg_net": 0.95, "tnet": 0.4,
           "box_net": 0.95, "stats": 5e-2, "fused_bn_norm": (0.9, 1.1),
           "norm": (0.9, 1.1)},
          {**{tag: points_readings(one, res[-1][0])
              for tag, res in outs.items()},
           "witness: 1 rank on the batch's halves swapped":
               points_readings(one, witness)},
          {f"control (2, 2) {f[0]}":
               points_readings(one, outs["(2, 2)"][-1][i])
           for i, f in enumerate(CONTROLS, 1)})


def test_v2_predict_step_on_a_points_mesh_equals_one_rank(monkeypatch):
    """`make_predict_step` (eval mode: K1 and K2's twins) on a (1, 2)
    mesh: both ranks return the 1-rank step's detections of the whole
    frustums, classes and mask counts equal, the rest within 1e-5 of
    their scale. Control: a per-shard pool moves them past it."""
    monkeypatch.delenv("T3D_FUSED_SA", raising=False)
    spec = _v2_spec()
    del spec["margin"]  # the seg net's own masks, which the control moves
    runs = [(), ("local_pool",)]
    job = ranks.Ranks(ranks.steps, 2, ranks.predict_step, spec, runs,
                      points=2)
    one = ranks.predict_step(spec)
    outs = job.results()

    def gap(got):
        return max(float(np.abs(got[k].astype(np.float64) - v).max()
                         / max(np.abs(v).max(), 1e-30))
                   for k, v in one.items())
    print({f"rank {r} {f[0] if f else 'sound'}": gap(out[i])
           for r, out in enumerate(outs) for i, f in enumerate(runs)})
    for out in outs:
        for k in ("heading_class", "size_class", "mask_count"):
            np.testing.assert_array_equal(out[0][k], one[k], err_msg=k)
        assert gap(out[0]) <= 1e-5
    for i, f in enumerate(runs[1:], 1):
        assert gap(outs[-1][i]) > 1e-5, f"control {f[0]} passes"
