"""Data parallelism of the port (`transferable3d_torch/parallel/mesh.py`)
against the JAX package's mesh and against the port's own one rank.

The ranks are spawned processes on the CPU (gloo, `file://` rendezvous,
one torch thread a rank; `torch_dp_ranks`), on 16 frustums of 256
points. JAX's side is `transferable3d_tpu/parallel/mesh.py` on the
8-device virtual CPU mesh (tests/conftest.py), as in
`tests/test_train.py:65`.

Every comparison states its limits beside a noise witness (the 1-rank
step on the batch with its halves swapped, whose frustums then meet
other summation orders) and controls that must each fail one of them:
BN statistics left per rank (`local_bn`), loss denominators left per
rank (`local_denominators`) and, for the fused chain, dgamma and dbeta
all-reduced twice (`dgamma_twice`).
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dp_ranks as ranks
from torch_parity import (one_torch_thread,  # noqa: F401
                          synthetic_step_batch, to_numpy_tree, tree_leaves,
                          zero_gradient_leaves)
from transferable3d_tpu.core import bins as jbins
from transferable3d_tpu.models.frustum_pointnet_v1 import FrustumPointNetV1
from transferable3d_tpu.parallel import mesh as jmesh
from transferable3d_tpu.train import schedules as jsched
from transferable3d_tpu.train import train_loop as jloop
from transferable3d_torch.core import bins as tbins
from transferable3d_torch.models import layers as tlayers
from transferable3d_torch.models import registry
from transferable3d_torch.parallel import mesh as tmesh
from transferable3d_torch.train import config as tconfig
from transferable3d_torch.train import train_semisup, train_sup
from transferable3d_torch.utils import bridge
from transferable3d_torch.utils.checkpoint import CheckpointManager

pytestmark = pytest.mark.usefixtures("one_torch_thread")
CFG = jbins.SUNRGBD
B, N, NOBJ = 16, 256, 64
HALVES = np.r_[B // 2:B, 0:B // 2]
FUSED_BN = re.compile(r"/sa\d/mlp(_\d)?/bn_\d+/(scale|bias)$")


def _concat(leaves, keys):
    return np.concatenate([leaves[k].ravel() for k in keys]).astype(
        np.float64)


def _cos(a, b):
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def readings(ref, got, noise=None):
    """Gaps of `got` from `ref`: the total loss (relative), the gradient
    without the leaves that are rounding noise (`noise` of the leaves'
    paths, default `zero_gradient_leaves`; relative L2, cosine, and per
    net of a detector), BN running statistics (largest gap over the
    leaf's largest value), and the norm ratio of the fused chains' BN
    gradients."""
    gr, gg = tree_leaves(ref["grads"]), tree_leaves(got["grads"])
    noise = set(zero_gradient_leaves(gr, pooled=False) if noise is None
                else noise(gr))
    keys = sorted(k for k in gr if k not in noise)
    a, b = _concat(gr, keys), _concat(gg, keys)
    out = {"loss": abs(float(got["metrics"]["total_loss"])
                       - float(ref["metrics"]["total_loss"]))
           / abs(float(ref["metrics"]["total_loss"])),
           "grad": float(np.linalg.norm(b - a) / np.linalg.norm(a)),
           "cos": _cos(a, b)}
    for net in ("seg_net", "tnet", "box_net"):
        ks = [k for k in keys if k.startswith(net + "/")]
        if ks:
            out[net] = _cos(_concat(gr, ks), _concat(gg, ks))
    sr, sg = tree_leaves(ref["stats"]), tree_leaves(got["stats"])
    out["stats"] = max(float(np.abs(sg[k] - sr[k]).max()
                             / max(np.abs(sr[k]).max(), 1e-30)) for k in sr)
    fused = sorted(k for k in gr if FUSED_BN.search(k))
    if fused:
        out["fused_bn_norm"] = float(np.linalg.norm(_concat(gg, fused))
                                     / np.linalg.norm(_concat(gr, fused)))
    return out


def fails(r, limits):
    """The limits a reading breaks: `(lo, hi)` bounds, an upper bound on
    the gaps (loss, grad, stats) and a lower bound on the cosines."""
    out = []
    for k, lim in limits.items():
        if isinstance(lim, tuple):
            bad = not lim[0] <= r[k] <= lim[1]
        elif k in ("loss", "grad", "stats"):
            bad = r[k] > lim
        else:
            bad = r[k] < lim
        if bad:
            out.append(k)
    return out


def judge(what, limits, runs, controls):
    """Print every reading; every run (the witness among them) within the
    limits, and every control outside at least one."""
    print(f"{what}; limits {limits}")
    for tag, r in {**runs, **controls}.items():
        print(f"  {tag}: " + ", ".join(f"{k} {v:.4g}" for k, v in r.items())
              + f"; fails {fails(r, limits) or 'no limit'}")
    for tag, r in runs.items():
        assert not fails(r, limits), (tag, fails(r, limits))
    for tag, r in controls.items():
        assert fails(r, limits), f"control {tag} passes every limit"


# ---------------------------------------------------------------------------
# The backend rule and the collectives without a group
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("device, ranks, cards, want", [
    ("cuda:0", 1, 1, "nccl"), ("cuda:3", 4, 4, "nccl"),
    ("cuda:0", 2, 1, "gloo"), ("cpu", 1, 0, "gloo"), ("cpu", 4, 0, "gloo")])
def test_backend_rule(device, ranks, cards, want):
    """NCCL when each of the host's ranks has a card of its own; gloo when
    ranks share a card or run on the CPU."""
    assert tmesh.choose_backend(torch.device(device), ranks, cards) == want


def test_one_rank_without_a_group_is_the_identity(monkeypatch):
    """One rank and no `init_method`: no process group, and every
    collective returns its input (so the 1-rank step is the code path
    without a mesh)."""
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    mesh = tmesh.data_parallel_mesh(["cpu"])
    assert (mesh.rank, mesh.world_size, mesh.backend, mesh.group) == (
        0, 1, None, None)
    x = torch.arange(6.0, requires_grad=True)
    metrics = {"loss": torch.tensor(2.0), "lr": 1e-3}
    for m in (None, mesh):
        with tmesh.use(m):
            assert tmesh.all_reduce_sum(x) is x
            assert tmesh.batch_stats_sum(x, x, 5) == (x, x, 5)
            assert tmesh.global_count(3) == 3
            assert tmesh.global_count(x) is x
            assert tmesh.reduce_metrics(metrics) is metrics
            assert tmesh.any_rank(True) and not tmesh.any_rank(False)
            assert tmesh.local_rows(metrics) is metrics
    assert tmesh.active() is None


# ---------------------------------------------------------------------------
# shard_batch and replicate against JAX's mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", [2, 4])
def test_shard_batch_and_replicate_equal_jax_mesh(world):
    """Rank r's `shard_batch` rows equal the addressable shard of JAX's
    `shard_batch` on mesh device r, for every key; after `replicate`
    every rank holds rank 0's parameters, buffers, step and generator
    state, as every device of JAX's `replicate` holds the array."""
    batch = synthetic_step_batch(B, N)
    model = registry.get_model("frustum_pointnets_v1", tbins.SUNRGBD,
                               device="cpu", in_channels=4)
    job = ranks.Ranks(ranks.sharding, world, batch, model.state_dict())
    mesh = jmesh.data_parallel_mesh(jax.devices()[:world])
    sharded = jmesh.shard_batch(batch, mesh)
    rep = jmesh.replicate({"w": jnp.arange(6.0)}, mesh)
    devices = list(mesh.devices.flat)
    outs = job.results()
    assert len({s.device for s in rep["w"].addressable_shards}) == world
    for s in rep["w"].addressable_shards:
        np.testing.assert_array_equal(np.asarray(s.data), np.arange(6.0))
    gen0 = torch.Generator().manual_seed(0).get_state()
    for r, out in enumerate(outs):
        assert sorted(out["rows"]) == sorted(batch)
        for k, arr in sharded.items():
            shard = next(s for s in arr.addressable_shards
                         if s.device == devices[r])
            np.testing.assert_array_equal(out["rows"][k],
                                          np.asarray(shard.data), err_msg=k)
        for k, v in model.state_dict().items():
            assert torch.equal(out["state_dict"][k], v), (r, k)
        assert out["step"] == 10 and torch.equal(out["generator"], gen0)
    with pytest.raises(ValueError, match="not divisible"):
        tmesh.shard_batch(batch, tmesh.Mesh(0, 3, torch.device("cpu"),
                                            None))


# ---------------------------------------------------------------------------
# One v1 float32 step: JAX's 8-device mesh, the port at W = 1, 2, 4
# ---------------------------------------------------------------------------

def _jax_mesh_step(batch):
    """JAX's v1 gradient on `data_parallel_mesh(jax.devices()[:8])`, the
    batch sharded and the state replicated: the loss, gradient, seg-net
    dropout keep mask, predicted mask and updated BN statistics, with the
    step-0 weights."""
    from torch_parity import _grads_and_dropout

    jm = FrustumPointNetV1(cfg=CFG, num_object_point=NOBJ)
    lr = jsched.exponential_staircase_lr(batch_size=B)
    bn = jsched.bn_momentum_schedule(batch_size=B)
    state = jloop.create_train_state(jm, CFG, jloop.make_optimizer(lr),
                                     batch, seed=0)
    params0, stats0 = (to_numpy_tree(state.params),
                       to_numpy_tree(state.batch_stats))
    mesh = jmesh.data_parallel_mesh(jax.devices()[:8])
    state = jmesh.replicate(state, mesh)
    sbatch = jmesh.shard_batch(batch, mesh)
    rng = jax.random.fold_in(state.rng, state.step)

    def fn(params, stats, b):
        return _grads_and_dropout(jm, b, jloop.labels_from_batch(b), None,
                                  CFG, rng, "mlp3", params, stats, bn(0))

    grads, (dp_out, dp_in, mask, loss, stats) = jax.jit(fn)(
        state.params, state.batch_stats, sbatch)
    keep = torch.from_numpy((np.asarray(dp_out) != 0)
                            | (np.asarray(dp_in) == 0))
    return params0, stats0, keep, {
        "metrics": {"total_loss": float(loss)},
        "grads": to_numpy_tree(grads), "stats": to_numpy_tree(stats),
        "masks": [np.asarray(mask)]}


def test_v1_f32_step_at_2_and_4_ranks_equal_jax_mesh_and_one_rank():
    """Against JAX's mesh step, the limits of
    tests/test_torch_train_step.py (loss 1e-4; gradient without its
    rounding-noise leaves relative L2 1e-2 and cosine 0.9999; BN
    statistics 1e-3 of each leaf's largest value) at W = 1, 2 and 4.
    Measured on the CPU against JAX: loss at most 2.6e-7, gradient
    1.5e-5, statistics 3.6e-6 at every W, the witness likewise. Against
    the port's W = 1, tighter limits (loss 1e-5, gradient 1e-4,
    statistics 1e-4): W = 2 read 0, 3.6e-6 and 2.7e-6, W = 4 3.8e-7,
    1.6e-5 and 2.7e-6, the witness 1.3e-7, 1.6e-5 and 4.5e-6; local BN
    statistics 1.3e-2, 1.28 and 1.05; local denominators a loss and a
    gradient W - 1 times too large (a gap of 1.0)."""
    batch = synthetic_step_batch(B, N)
    params0, stats0, keep, jax_out = _jax_mesh_step(batch)
    tmodel = registry.get_model("frustum_pointnets_v1", tbins.SUNRGBD,
                                device="cpu", in_channels=4,
                                num_object_point=NOBJ)
    bridge.load_flax_variables(tmodel, params0, stats0)
    spec = dict(name="frustum_pointnets_v1", dtype=torch.float32,
                state_dict=tmodel.state_dict(), batch=batch, keep=keep,
                nobj=NOBJ)
    faults = [(), ("local_bn",), ("local_denominators",)]
    jobs = {w: ranks.Ranks(ranks.steps, w, ranks.train_step, spec,
                           faults if w == 2 else [()]) for w in (2, 4)}
    one = ranks.train_step(spec)
    witness = ranks.train_step(spec, order=HALVES)
    witness["masks"] = [witness["masks"][0][np.argsort(HALVES)]]
    outs = {w: job.results() for w, job in jobs.items()}

    port = {"W=1": one}
    for w, res in outs.items():
        port[f"W={w}"] = res[0][0]
        for r in range(1, w):  # every rank holds the same gradient
            for k, v in tree_leaves(res[r][0]["grads"]).items():
                np.testing.assert_array_equal(
                    v, tree_leaves(res[0][0]["grads"])[k])
        mask = np.concatenate([res[r][0]["masks"][0] for r in range(w)])
        np.testing.assert_array_equal(mask, jax_out["masks"][0])
    np.testing.assert_array_equal(one["masks"][0], jax_out["masks"][0])
    judge("v1 f32 step, port vs JAX's 8-device mesh",
          {"loss": 1e-4, "grad": 1e-2, "cos": 0.9999, "stats": 1e-3},
          {**{f"port {k}": readings(jax_out, v) for k, v in port.items()},
           "witness: port W=1 on the halves swapped":
               readings(jax_out, witness)}, {})
    judge("v1 f32 step, port W ranks vs port W=1",
          {"loss": 1e-5, "grad": 1e-4, "stats": 1e-4},
          {"W=2": readings(one, port["W=2"]),
           "W=4": readings(one, port["W=4"]),
           "witness: W=1 on the halves swapped": readings(one, witness)},
          {f"control W=2 {f[0]}": readings(one, outs[2][0][i])
           for i, f in enumerate(faults) if f})


# ---------------------------------------------------------------------------
# v2 bf16 on the fused chain (plain twins of K5-K9), port only
# ---------------------------------------------------------------------------

def test_v2_bf16_fused_two_ranks_equal_one_rank(monkeypatch):
    """The fused chain's statistics and backward sums summed over two
    ranks. Pinned as chip_smoke pins its bf16 steps (every point masked
    past a margin, the box net's input on the 1/256 grid). Limits: loss
    5e-3, gradient cosine 0.9 (seg net 0.95, T-Net 0.4, box net 0.95),
    BN statistics 5e-2, the fused chains' BN gradient norm ratio within
    [0.9, 1.1]. Measured on the CPU: W = 2 read 6.9e-4, 0.968 (0.979,
    0.513, 0.986), 7.8e-3, 0.991; the witness 9.0e-4, 0.970 (0.984,
    0.530, 0.987), 6.2e-3, 1.006 (a bf16 step's gradient is chaotic at a
    few frustums, and the T-Net's cancels); local BN statistics 4.4e-2,
    0.145 (0.679, 0.257, 0.140), 0.58, 1.085; dgamma twice a norm ratio
    of 1.96, its cosines within the noise (0.962)."""
    monkeypatch.delenv("T3D_FUSED_SA", raising=False)
    batch = synthetic_step_batch(B, N)
    model = registry.get_model(
        "frustum_pointnets_v2", tbins.SUNRGBD, dtype=torch.bfloat16,
        device="cpu", in_channels=4, num_object_point=NOBJ,
        generator=torch.Generator().manual_seed(0))
    keep = tlayers.dropout_keep_mask((B, N, 128), 0.5,
                                     torch.Generator().manual_seed(5))
    spec = dict(name="frustum_pointnets_v2", dtype=torch.bfloat16,
                state_dict=model.state_dict(), batch=batch, keep=keep,
                nobj=NOBJ, fused=True)
    probe = ranks._model(spec).train()
    with ranks.keep_masks([keep]), torch.no_grad():
        logits = probe(torch.from_numpy(batch["points"]),
                       torch.from_numpy(batch["one_hot"]), 0.5,
                       torch.Generator())["seg_logits"].float()
    spec["margin"] = 1.0 + 2.0 * float(
        (logits[..., 1] - logits[..., 0]).abs().max())
    faults = [(), ("local_bn",), ("dgamma_twice",)]
    job = ranks.Ranks(ranks.steps, 2, ranks.train_step, spec, faults)
    one = ranks.train_step(spec)
    witness = ranks.train_step(spec, order=HALVES)
    res = job.results()
    assert all(m.all() for m in one["masks"])
    judge("v2 bf16 fused, W=2 vs W=1",
          {"loss": 5e-3, "cos": 0.9, "seg_net": 0.95, "tnet": 0.4,
           "box_net": 0.95, "stats": 5e-2, "fused_bn_norm": (0.9, 1.1)},
          {"W=2": readings(one, res[0][0]),
           "witness: W=1 on the halves swapped": readings(one, witness)},
          {f"control {f[0]}": readings(one, res[0][i])
           for i, f in enumerate(faults) if f})


# ---------------------------------------------------------------------------
# The phase-B step (v1 f32), port only
# ---------------------------------------------------------------------------

def test_phase_b_step_two_ranks_equal_one_rank():
    """`make_semisup_train_step` at W = 2 against W = 1 on the v1
    backbone: the strong and weak passes' BN statistics, the weak
    losses' means and the per-class diagnostics' counts over the whole
    batch. Limits: loss 1e-5, gradient 1e-4, statistics 1e-4, every
    metric within 1e-4 of its W = 1 value (relative, 1e-6 absolute);
    the witness is W = 1 on the halves of both batches swapped. Measured
    on the CPU: W = 2 read 3.3e-7, 2.2e-5 and 4.1e-6, the witness 0,
    2.1e-5 and 3.8e-6; local BN statistics 0.109, 1.61 and 1.11; local
    denominators a gap of 1.0."""
    from test_torch_boxpc import strong_batch
    from test_torch_semisup import OPEN_GATE

    strong = strong_batch(n=B, npoints=N, seed=3)
    weak = strong_batch(n=B, npoints=N, seed=4)
    for k in ("calib_p", "has_calib", "box2d", "frustum_angle"):
        weak.pop(k, None)
    det = registry.get_model("frustum_pointnets_v1", tbins.SUNRGBD,
                             device="cpu", in_channels=4,
                             num_object_point=NOBJ,
                             generator=torch.Generator().manual_seed(0))
    bp = registry.get_model("boxpc_fit", tbins.SUNRGBD, device="cpu",
                            generator=torch.Generator().manual_seed(1))
    gen = torch.Generator().manual_seed(6)
    keep = [tlayers.dropout_keep_mask((B, N, 128), 0.5, gen)
            for _ in range(2)]
    spec = dict(name="frustum_pointnets_v1", dtype=torch.float32,
                state_dict=det.state_dict(), boxpc=bp.state_dict(),
                batch=strong, weak=weak, keep=keep, nobj=NOBJ,
                weights=dict(OPEN_GATE, size_cls=0.0))
    faults = [(), ("local_bn",), ("local_denominators",)]
    job = ranks.Ranks(ranks.steps, 2, ranks.semisup_step, spec, faults)
    one = ranks.semisup_step(spec)
    witness = ranks.semisup_step(spec, order=HALVES)
    res = job.results()
    two = res[0][0]
    assert sorted(two["metrics"]) == sorted(one["metrics"])
    for k, v in one["metrics"].items():
        np.testing.assert_allclose(two["metrics"][k], v, rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    assert 0 < float(one["metrics"]["weak_trust_frac"]) <= 1
    counts = one["metrics"]["diag_count"]
    np.testing.assert_array_equal(
        counts, np.bincount(weak["class_idx"], minlength=len(counts)))
    judge("phase-B step v1 f32, W=2 vs W=1",
          {"loss": 1e-5, "grad": 1e-4, "stats": 1e-4},
          {"W=2": readings(one, two),
           "witness: W=1 on the halves swapped": readings(one, witness)},
          {f"control {f[0]}": readings(one, res[0][i])
           for i, f in enumerate(faults) if f})


# ---------------------------------------------------------------------------
# The phase-A (BoxPC) step, port only
# ---------------------------------------------------------------------------

def test_boxpc_step_two_ranks_equal_one_rank():
    """`make_boxpc_train_step` at W = 2 against W = 1, the shape aug on:
    each rank draws the whole batch's perturbation, aug and dropout masks
    from its equally seeded generator and keeps its rows, and BoxPC's BN
    statistics and loss means are the whole batch's. The witness is W = 1
    on the halves swapped with every draw permuted alike. Limits: loss
    1e-5, gradient 1e-4 (without the leaves that are rounding noise,
    `boxpc_noise_leaves`), statistics 1e-4, every loss metric within 1e-4
    of its W = 1 value, and the two counted metrics (`fit_accuracy`,
    `pos_fraction`) equal. Measured on the CPU: W = 2 read 4.2e-7, 1.6e-6
    and 8.2e-7, the witness 2.1e-7, 1.6e-6 and 1.1e-6; local BN statistics
    3.8e-2, 1.06 and 0.89; local denominators a loss and a gradient gap of
    1.0."""
    from test_torch_boxpc import boxpc_noise_leaves, strong_batch

    batch = strong_batch(n=B, npoints=N, seed=2)
    bp = registry.get_model("boxpc_fit", tbins.SUNRGBD, device="cpu",
                            generator=torch.Generator().manual_seed(1))
    spec = dict(state_dict=bp.state_dict(), batch=batch, seed=7, aniso=0.8)
    faults = [(), ("local_bn",), ("local_denominators",)]
    job = ranks.Ranks(ranks.steps, 2, ranks.boxpc_step, spec, faults)
    one = ranks.boxpc_step(spec)
    witness = ranks.boxpc_step(spec, order=HALVES)
    res = job.results()
    two = res[0][0]
    assert sorted(two["metrics"]) == sorted(one["metrics"])
    for k, v in one["metrics"].items():
        if k in ("fit_accuracy", "pos_fraction"):
            assert two["metrics"][k] == v, k
        np.testing.assert_allclose(two["metrics"][k], v, rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    assert 0 < float(one["metrics"]["pos_fraction"]) < 1
    judge("phase-A (BoxPC) step f32, W=2 vs W=1",
          {"loss": 1e-5, "grad": 1e-4, "stats": 1e-4},
          {"W=2": readings(one, two, boxpc_noise_leaves),
           "witness: W=1 on the halves swapped, draws permuted":
               readings(one, witness, boxpc_noise_leaves)},
          {f"control {f[0]}": readings(one, res[0][i], boxpc_noise_leaves)
           for i, f in enumerate(faults) if f})


# ---------------------------------------------------------------------------
# The drivers
# ---------------------------------------------------------------------------

def _tiny(tmp_path, tag, **kw):
    return tconfig.TrainConfig(
        model="frustum_pointnets_v1", dataset="sunrgbd", num_point=64,
        num_channels=4, batch_size=8, max_epoch=3, max_steps=3,
        synthetic_train=8, synthetic_val=16,
        log_dir=str(tmp_path / tag), eval_every_epochs=1,
        ckpt_every_epochs=10, **kw)


def _rows(path):
    import csv

    with open(path) as f:
        return [{k: float(v) for k, v in row.items()}
                for row in csv.DictReader(f)]


def test_driver_two_ranks_equal_one_rank(tmp_path):
    """`train_sup.train` with `num_devices=2` (two spawned CPU ranks)
    against one rank, 3 steps of 8 frustums (a step an epoch), every
    train and val metric within 1e-4 (relative, 1e-7 absolute). The LR
    is 1e-8 (and its floor): Adam moves each weight by about the LR
    times the sign of its gradient, and the sign of a gradient that is
    rounding noise differs between summation orders, so at the default
    LR the IoU metrics of
    step 3 part by some 10%, and at 1e-5 by 1.6e-4 at step 2 (readings
    on the CPU). Only rank 0 writes: one log line a message, one CSV row
    a step, and one checkpoint a saved step and nothing else under
    `ckpt/` (epoch 0 and the last step, `ckpt_every_epochs` 10)."""
    lr = dict(learning_rate=1e-8, min_lr=1e-8)
    one = train_sup.train(_tiny(tmp_path, "one", **lr), device="cpu")
    two = train_sup.train(_tiny(tmp_path, "two", num_devices=2, **lr),
                          device="cpu")
    assert sorted(two) == sorted(one)
    for split in ("train", "val"):
        r1 = _rows(tmp_path / "one" / f"metrics_{split}.csv")
        r2 = _rows(tmp_path / "two" / f"metrics_{split}.csv")
        assert [r["step"] for r in r2] == [r["step"] for r in r1] == [1, 2, 3]
        for i, (a, b) in enumerate(zip(r1, r2)):
            for k in a:
                np.testing.assert_allclose(b[k], a[k], rtol=1e-4, atol=1e-7,
                                           err_msg=f"{split} row {i} {k}")
    log = (tmp_path / "two" / "log_train.txt").read_text()
    assert log.count("config:") == 1 and "data parallel: 2 ranks" in log
    assert log.count("epoch 2:") == 1
    steps = CheckpointManager(str(tmp_path / "one" / "ckpt")).steps()
    assert steps == [1, 3]  # epoch 0, and the step the run stops at
    assert sorted(p.name for p in (tmp_path / "two" / "ckpt").iterdir()) \
        == ["1", "3"]


def test_drivers_refuse_what_cannot_run(tmp_path, monkeypatch):
    """A batch that the ranks do not divide, and `multihost` without a
    launcher's environment, raise before any rank starts, in both
    drivers."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    cfg = _tiny(tmp_path, "x")
    semi = train_semisup.SemisupConfig(**dataclasses.asdict(cfg))
    for fn, c in ((train_sup.train, cfg), (train_semisup.train, semi)):
        with pytest.raises(ValueError, match="not divisible by 3 ranks"):
            fn(dataclasses.replace(c, num_devices=3), device="cpu")
        with pytest.raises(ValueError, match="launcher"):
            fn(dataclasses.replace(c, multihost=True), device="cpu")
    assert not (tmp_path / "x").exists()
