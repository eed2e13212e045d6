"""Rank processes for tests/test_torch_parallel.py,
tests/test_torch_points_parallel.py and
tests/test_torch_points_transfer.py.

Imports torch and the port only: the ranks are spawned processes, and
they import no JAX. `Ranks(fn, world, *args, points=P)` spawns `world`
ranks on the CPU (gloo, a `file://` rendezvous in a temporary directory,
so concurrent test workers never share a port, and one torch thread a
rank) on a 1-D mesh, or with P > 1 a (world / P, P) points mesh, each
running `fn(mesh, *args)` under its mesh (`mesh.use`), and lets the
caller work while they run. The step functions read the mesh where the
drivers' steps read it (`mesh.active()`); called in the test's own
process, without a mesh, they are the 1-rank step.

The controls of the tests are switches of `steps`: `local_bn` leaves the
BN statistics per rank (`mesh.batch_stats_sum` the identity),
`local_denominators` the loss and metric denominators
(`mesh.global_count` the identity), and `dgamma_twice` all-reduces the
fused chain's BN gradients once before the gradient all-reduce adds
them again. On a points mesh: `local_pool` pools over the rank's points
alone (`mesh.points_max` the local max), `local_masking` masks the
rank's points alone (no gather in `point_cloud_masking`),
`box_grads_everywhere` sums the box stages' gradients over every rank,
and `box_cotangent_unsummed` leaves BoxPC's cotangent of the box it
reads on the rank's points unsummed over the points group
(`mesh.from_replicated` the identity).
"""

from __future__ import annotations

import contextlib
import os
import shutil
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from transferable3d_torch.core import bins as tbins
from transferable3d_torch.models import boxpc as tboxpc
from transferable3d_torch.models import layers as tlayers
from transferable3d_torch.models import model_util, registry
from transferable3d_torch.parallel import mesh as mesh_lib
from transferable3d_torch.train import schedules as tsched
from transferable3d_torch.train import semisup as tsemi
from transferable3d_torch.train import train_loop as tloop
from transferable3d_torch.utils import bridge

CFG = tbins.SUNRGBD


def _entry(rank, world, fn, args, init_method, tmp, points):
    torch.set_num_threads(1)
    if points > 1:
        mesh = mesh_lib.data_points_mesh(
            world // points, points, ["cpu"], rank=rank, world_size=world,
            init_method=init_method)
    else:
        mesh = mesh_lib.data_parallel_mesh(
            ["cpu"], rank=rank, world_size=world, init_method=init_method)
    try:
        with mesh_lib.use(mesh):
            out = fn(mesh, *args)
    finally:
        mesh_lib.destroy(mesh)
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))


class Ranks:
    """`world` spawned CPU ranks running `fn(mesh, *args)`; the caller
    may work meanwhile. `results()` joins them (a rank that raised makes
    it raise) and returns their results in rank order."""

    def __init__(self, fn, world: int, *args, points: int = 1):
        import torch.multiprocessing as mp

        self.world = world
        self.tmp = tempfile.mkdtemp(prefix="t3d_dp_test_")
        self.ctx = mp.start_processes(
            _entry, nprocs=world, join=False, start_method="spawn",
            args=(world, fn, args,
                  "file://" + os.path.join(self.tmp, "rendezvous"),
                  self.tmp, points))

    def results(self) -> list:
        try:
            while not self.ctx.join():
                pass
            return [torch.load(os.path.join(self.tmp, f"rank{r}.pt"),
                               weights_only=False)
                    for r in range(self.world)]
        finally:
            shutil.rmtree(self.tmp, ignore_errors=True)


@contextlib.contextmanager
def controls(names, model=None):
    """The named faults (see the module docstring) for the block."""
    saved = (mesh_lib.batch_stats_sum, mesh_lib.global_count,
             mesh_lib.all_reduce_grads, mesh_lib.points_max,
             model_util.point_cloud_masking, mesh_lib.from_replicated)
    if "box_cotangent_unsummed" in names:
        mesh_lib.from_replicated = lambda x: x
    if "local_pool" in names:
        mesh_lib.points_max = lambda x, dim: x.amax(dim=dim)
    if "local_masking" in names:
        def masking(*a, **kw):
            gather = mesh_lib.points_gather
            mesh_lib.points_gather = lambda x: x
            try:
                return saved[4](*a, **kw)
            finally:
                mesh_lib.points_gather = gather
        model_util.point_cloud_masking = masking
    if "box_grads_everywhere" in names:
        mesh_lib.all_reduce_grads = lambda params, replicated=(): saved[2](
            params)
    if "local_bn" in names:
        mesh_lib.batch_stats_sum = lambda s, s2, rows: (s, s2, rows)
    if "local_denominators" in names:
        mesh_lib.global_count = lambda count: count
    if "dgamma_twice" in names:
        from transferable3d_torch.models.pointnet2 import GroupedPointMLP

        twice = [p for m in model.modules() if isinstance(m, GroupedPointMLP)
                 for i in range(len(m.features))
                 for p in (getattr(m, f"bn_{i}").scale,
                           getattr(m, f"bn_{i}").bias)]

        def all_reduce_grads(params, replicated=()):
            for p in twice:
                dist.all_reduce(p.grad)
            saved[2](params, replicated)
        mesh_lib.all_reduce_grads = all_reduce_grads
    try:
        yield
    finally:
        (mesh_lib.batch_stats_sum, mesh_lib.global_count,
         mesh_lib.all_reduce_grads, mesh_lib.points_max,
         model_util.point_cloud_masking, mesh_lib.from_replicated) = saved


@contextlib.contextmanager
def keep_masks(masks):
    """`layers.dropout_keep_mask` returns `masks` (whole-batch tensors) in
    turn."""
    queue = list(masks)
    saved = tlayers.dropout_keep_mask
    tlayers.dropout_keep_mask = lambda shape, rate, gen: queue.pop(0)
    try:
        yield
    finally:
        tlayers.dropout_keep_mask = saved
    assert not queue, "a keep mask was not drawn"


def _permuted(batch, keep, order, points_order=None):
    """The batch and keep masks with the frustums in `order` and each
    frustum's points in `points_order` (the arrays that hold points:
    `points`, `seg`)."""
    if order is not None:
        batch = {k: v[order] for k, v in batch.items()}
        keep = [m[torch.from_numpy(order)] for m in keep]
    if points_order is not None:
        batch = {k: v[:, points_order] if k in ("points", "seg") else v
                 for k, v in batch.items()}
        keep = [m[:, torch.from_numpy(points_order)] for m in keep]
    return batch, keep


def snap_to_grid(mod, args):
    """Forward pre-hook of the box net (chip_smoke's `_snap_to_grid`):
    its input points moved rigidly onto the 1/256 grid around their
    mean, so every rank count and order feeds the box net the same exact
    coordinates, and FPS and the balls take the same picks, however the
    T-Net's bf16 output rounds. The gradient passes straight through."""
    obj = args[0]
    with torch.no_grad():
        snapped = torch.round((obj - obj[:, :1]) * 256) / 256
        snapped -= torch.round(snapped.mean(dim=1, keepdim=True) * 256) / 256
    return (snapped + (obj - obj.detach()), *args[1:])


def _model(spec):
    """The spec's model from its state_dict; with `margin`, the
    foreground logit's bias raised by it (every point masked, past any
    rounding) and the box net's input snapped (`snap_to_grid`)."""
    detector = {} if spec["name"] == "box_estimation_v1" else dict(
        in_channels=spec["batch"]["points"].shape[-1],
        num_object_point=spec["nobj"])
    model = registry.get_model(spec["name"], CFG, dtype=spec["dtype"],
                               device="cpu", **detector)
    model.load_state_dict(spec["state_dict"])
    if spec.get("margin"):
        with torch.no_grad():
            model.seg_net.seg_out.bias[1] += spec["margin"]
        model.box_net.register_forward_pre_hook(snap_to_grid)
    return model


def _outcome(model, metrics, masks):
    params, stats = bridge.state_dict_to_flax(model)
    return {"metrics": {k: np.asarray(v.cpu() if torch.is_tensor(v) else v,
                                      np.float32)
                        for k, v in metrics.items()},
            "grads": bridge.grads_to_flax(model), "params": params,
            "stats": stats, "masks": masks}


@contextlib.contextmanager
def permuted_draws(order):
    """BoxPC's step with every draw it takes (the perturbation, the
    aug, the dropout masks) permuted on the batch axis by `order`, as its
    frustums are: the witness's step is then the same function of each
    frustum. A no-op without `order`."""
    if order is None:
        yield
        return
    idx = torch.from_numpy(order)
    saved = (tboxpc.perturbation_draws, tsemi.shape_aug_draws,
             tlayers.dropout_keep_mask)

    def permuted(fn):
        def draws(*a):
            out = fn(*a)
            return (out[idx] if torch.is_tensor(out)
                    else tuple(x[idx] for x in out))
        return draws
    (tboxpc.perturbation_draws, tsemi.shape_aug_draws,
     tlayers.dropout_keep_mask) = map(permuted, saved)
    try:
        yield
    finally:
        (tboxpc.perturbation_draws, tsemi.shape_aug_draws,
         tlayers.dropout_keep_mask) = saved


def train_step(spec, faults=(), order=None, points_order=None):
    """One `make_train_step` of `spec` (model name, dtype, state_dict,
    the global numpy batch, the global keep mask or None for a model
    without dropout, nobj) on this rank's block of the current mesh
    (none: one rank, the whole batch), the frustums in `order` and their
    points in `points_order`, with the named faults."""
    if spec.get("fused"):
        os.environ.pop("T3D_FUSED_SA", None)
    model = _model(spec)
    batch, keep = _permuted(
        spec["batch"], [] if spec["keep"] is None else [spec["keep"]],
        order, points_order)
    b = len(batch["points"])
    lr = tsched.exponential_staircase_lr(batch_size=b)
    bn = tsched.bn_momentum_schedule(batch_size=b)
    state = tloop.create_train_state(model, tloop.make_optimizer(lr),
                                     generator=torch.Generator())
    seen = []
    hook = model.register_forward_hook(
        lambda mod, args, out: seen.append(out["mask"].numpy()))
    step = tloop.make_train_step(CFG, lr, bn)
    with controls(faults, model), keep_masks(keep):
        _, metrics = step(state, mesh_lib.local_rows(batch))
    hook.remove()
    return _outcome(model, metrics, seen)


def predict_step(spec, faults=()):
    """`make_predict_step` of `spec`'s model (eval mode) on this rank's
    block of the current mesh, with the named faults: the detections as
    numpy arrays."""
    if spec.get("fused"):
        os.environ.pop("T3D_FUSED_SA", None)
    model = _model(spec)
    step = tloop.make_predict_step(model, CFG)
    with controls(faults, model):
        out = step(mesh_lib.local_rows(spec["batch"]))
    return {k: v.numpy() for k, v in out.items()}


@contextlib.contextmanager
def counted(calls):
    """The calls of the fused chain's forward (K5's twin) and of its
    first backward step (K9's) counted in `calls` for the block."""
    from transferable3d_torch.ops import fused_sa

    saved = {n: getattr(fused_sa, n) for n in ("sa_extract",
                                               "sa_bwd_step0")}
    for name, fn in saved.items():
        def count(*a, _fn=fn, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **kw)
        setattr(fused_sa, name, count)
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(fused_sa, name, fn)


def semisup_step(spec, faults=(), order=None, points_order=None):
    """One `make_semisup_train_step` of `spec` (the detector's and
    BoxPC's state_dicts, the global strong and weak batches, their keep
    masks, the weak-loss weights) on this rank's block of the current
    mesh, the frustums in `order` and their points in `points_order`,
    with the named faults; the calls of the fused chain's twins are in
    the outcome's `calls`."""
    if spec.get("fused"):
        os.environ.pop("T3D_FUSED_SA", None)
    det = _model(spec)
    bp = registry.get_model("boxpc_fit", CFG, device="cpu")
    bp.load_state_dict(spec["boxpc"])
    strong, keep = _permuted(spec["batch"], spec["keep"][:1], order,
                             points_order)
    weak, keep_w = _permuted(spec["weak"], spec["keep"][1:], order,
                             points_order)
    b = len(strong["points"])
    lr = tsched.exponential_staircase_lr(base_lr=1e-3, batch_size=b)
    bn = tsched.bn_momentum_schedule(batch_size=b)
    state = tsemi.SemisupState(
        detector=tloop.create_train_state(det, tloop.make_optimizer(lr),
                                          generator=torch.Generator()),
        boxpc=bp)
    seen = []
    hook = det.register_forward_hook(
        lambda mod, args, out: seen.append(out["mask"].numpy()))
    step = tsemi.make_semisup_train_step(
        CFG, lr, bn, weights=tsemi.WeakLossWeights(**spec["weights"]),
        diag_classes=CFG.num_classes)
    calls, box = {}, {}
    with controls(faults, det), keep_masks(keep + keep_w), counted(calls), \
            box_cotangent(box):
        _, metrics = step(state, mesh_lib.local_rows(strong),
                          mesh_lib.local_rows(weak))
    hook.remove()
    return {**_outcome(det, metrics, seen), "calls": calls,
            "box_cotangent": box["cotangent"]}


@contextlib.contextmanager
def box_cotangent(out):
    """`out["cotangent"]`: the cotangent [rows, 7] of the predicted box
    (center, size, heading) that the weak losses read, as numpy, once
    the step's backward has run."""
    saved = tsemi.differentiable_box
    parts = {}

    def hooked(*a, **kw):
        box = saved(*a, **kw)
        for i, t in enumerate(box):
            t.register_hook(lambda g, i=i: parts.__setitem__(i, g))
        return box
    tsemi.differentiable_box = hooked
    try:
        yield
    finally:
        tsemi.differentiable_box = saved
    out["cotangent"] = torch.cat(
        [parts[0], parts[1], parts[2][:, None]], dim=1).float().numpy()


@contextlib.contextmanager
def injected_draws(spec, b):
    """With the spec's `draws` (the whole batch's perturbation and aug
    draws and the head's two keep masks, as JAX drew them), the step
    takes them in place of its generator's, asked for the whole batch's
    `b` rows. A no-op without them."""
    draws = spec.get("draws")
    if draws is None:
        yield
        return
    saved = tboxpc.perturbation_draws, tsemi.shape_aug_draws

    def sample(gen, n):
        assert n == b, (n, b)
        return draws["sample"]

    def aug(gen, n, log_range):
        assert n == b, (n, b)
        return draws["aug"]
    tboxpc.perturbation_draws, tsemi.shape_aug_draws = sample, aug
    try:
        with keep_masks(draws["keep"]):
            yield
    finally:
        tboxpc.perturbation_draws, tsemi.shape_aug_draws = saved


def boxpc_step(spec, faults=(), order=None, points_order=None):
    """One phase-A `make_boxpc_train_step` of `spec` (BoxPC's
    state_dict, the global strong batch, the state generator's seed, the
    aug's log range, optionally JAX's `draws`) on this rank's block of
    the current mesh. The step draws the whole batch's perturbation, aug
    and dropout masks from the state's generator, seeded alike on every
    rank, and keeps the rank's rows (or takes the injected draws,
    `injected_draws`); with `order`, the frustums and every draw are
    permuted alike (`permuted_draws`), with `points_order` each
    frustum's points."""
    model = registry.get_model("boxpc_fit", CFG, device="cpu")
    model.load_state_dict(spec["state_dict"])
    batch = _permuted(spec["batch"], [], order, points_order)[0]
    b = len(batch["points"])
    state = tsemi.create_boxpc_state(
        model, tloop.make_optimizer(tsched.exponential_staircase_lr(
            base_lr=1e-3, batch_size=b)), seed=spec["seed"])
    step = tsemi.make_boxpc_train_step(
        CFG, tsched.bn_momentum_schedule(batch_size=b),
        aniso_aug=spec["aniso"])
    with controls(faults), permuted_draws(order), injected_draws(spec, b):
        _, metrics = step(state, mesh_lib.local_rows(batch))
    return _outcome(model, metrics, [])


def boxpc_draws(mesh, spec):
    """The draws that one BoxPC step of `spec` hands to
    `perturbed_from_draws` and `shape_aug_from_draws` on this rank, and
    the aug's output points (the rank's block)."""
    seen = {}
    saved = tboxpc.perturbed_from_draws, tsemi.shape_aug_from_draws

    def perturbed(gt, *draws, **kw):
        seen["sample"] = [d.clone() for d in draws]
        return saved[0](gt, *draws, **kw)

    def aug(points, gt, s_log, u_on, **kw):
        out = saved[1](points, gt, s_log, u_on, **kw)
        seen.update(aug=[s_log.clone(), u_on.clone()],
                    points=out[0].clone())
        return out
    tboxpc.perturbed_from_draws, tsemi.shape_aug_from_draws = perturbed, aug
    try:
        boxpc_step(spec)
    finally:
        tboxpc.perturbed_from_draws, tsemi.shape_aug_from_draws = saved
    return seen


def steps(mesh, fn, spec, runs):
    """`fn(spec, faults)` for each tuple of faults in `runs`."""
    return [fn(spec, faults) for faults in runs]


def sharding(mesh, batch, state_dict):
    """This rank's `shard_batch` rows, and a model's state after
    `replicate` from a copy that differs on every rank."""
    model = registry.get_model("frustum_pointnets_v1", CFG, device="cpu",
                               in_channels=batch["points"].shape[-1])
    model.load_state_dict(state_dict)
    state = tloop.create_train_state(
        model, tloop.make_optimizer(tsched.exponential_staircase_lr()),
        generator=torch.Generator().manual_seed(mesh.rank))
    state.step = 10 + mesh.rank
    with torch.no_grad():
        for p in model.parameters():
            p.add_(mesh.rank)
    mesh_lib.replicate(state, mesh)
    return {"rows": {k: v.numpy() for k, v in
                     mesh_lib.shard_batch(batch, mesh).items()},
            "state_dict": {k: v.clone() for k, v in
                           model.state_dict().items()},
            "step": state.step,
            "generator": state.generator.get_state()}


def points_sharding(mesh, batch):
    """This rank's coordinates, `shard_batch` block and `local_rows`
    block of a numpy batch."""
    return {"coords": mesh.coords,
            "rows": {k: v.numpy() for k, v in
                     mesh_lib.shard_batch(batch, mesh).items()},
            "local": {k: np.asarray(v) for k, v in
                      mesh_lib.local_rows(batch).items()}}


def collectives(mesh):
    """On a (1, 2) mesh: `points_max` of a [4, 8, 3] tensor whose maxima
    tie within a shard and across the two shards, and `points_gather`,
    each with the gradient of the rank's share (a half) of sum(w * y)."""
    x = torch.zeros(4, 8, 3)
    x[:, 1] = 2.0           # a tie across the shards (points 1 and 5)
    x[:, 5] = 2.0
    x[0, 6, 0] = 3.0        # a tie within shard 1 (points 6 and 7)
    x[0, 7, 0] = 3.0
    x[1, 2, 1] = 5.0        # one maximum on shard 0
    w = torch.arange(12.0).reshape(4, 3) / 4 + 0.25
    v = torch.arange(96.0).reshape(4, 8, 3) / 8
    own = mesh_lib.points_slice(x).clone().requires_grad_(True)
    y = mesh_lib.points_max(own, dim=1)
    (torch.sum(w * y) / 2).backward()
    mine = mesh_lib.points_slice(v).clone().requires_grad_(True)
    whole = mesh_lib.points_gather(mine)
    (torch.sum(v * whole) / 2).backward()
    return {"max": y.detach(), "dmax": own.grad, "gather": whole.detach(),
            "dgather": mine.grad, "x": x, "w": w, "v": v}
