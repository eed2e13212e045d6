"""Smoke run of the PyTorch port's serving and training paths on one
NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Drives `transferable3d_torch` (no JAX anywhere) through F-PointNet v2 at
the width of the JAX package's bench cells: serving as `v2_infer`
(`get_model("frustum_pointnets_v2", SUNRGBD, dtype=bfloat16)` on cuda:0,
B=128 frustums of N=1024 points with C=4 channels, 512 object points
after masking) and one training step as `v2_train` on the unfused
set-abstraction path (T3D_FUSED_SA=0). Weights are random from a seeded
torch.Generator; the inputs are seeded synthetic frustums.

Serving phases, one line each, under torch.no_grad():
  1. card name and `nvidia-smi` name + power limit;
  2. build of the CUDA kernels (csrc/*.cu: one nvcc per source, all in
     parallel, then one link into a single library) and its time;
  3. model (BN running statistics perturbed away from 0/1) and inputs (an
     object box plus clutter, 3-8 m ahead), and the share of empty /
     short / full / overfull balls at each of the 8 SA scales (no ball on
     this path is empty: every centroid is one of the points it groups;
     phase 5 therefore also checks K2 with half the centroids moved
     100 m away);
  4. one `make_predict_step` call with the launch counters zeroed just
     before it: 4 FPS launches (kernel K1) and 8 fused SA launches
     (kernel K2) are required, and their arguments are captured;
  5. each kernel vs its plain PyTorch twin on those arguments: FPS
     indices identical; K2 >= 99% of pooled values bit-identical, max
     |diff| <= 1% of max |pooled|, >= 10% of pooled nonzero; and the
     card's predict step vs the plain twins on the CPU for 8 frustums
     (seg logits within 3% of their max, mask agreement >= 99%);
  6. `run_inference` over 4 batches (512 frustums): finite detections;
  7. times with CUDA events, each beside the card's name and power
     limit: every kernel and its plain twin at each main-path shape, and
     predict-step frustums/s.
Training phases (T3D_FUSED_SA=0 set for them and restored after):
  8. a fresh bf16 v2 and the `v2_train` batch (the port's copy of the
     synthetic generator: 32 frustums, n_object 600, n_clutter 300, 1024
     points, tiled to B=128); one `make_train_step` call (Adam on the
     exponential staircase, the BN-momentum staircase, IoU metrics on)
     with the counters zeroed just before it: 4 FPS, 0 fused SA, 8 K3
     and 8 K4 launches are required and the K3/K4 arguments captured;
     every loss term, metric and gradient finite; the all-zero gradient
     leaves listed; the ball shares of the 8 scales;
  9. K3 and K4 vs their plain twins on the captured arguments, and again
     with every other centroid moved 100 m away (empty balls): K3 rows
     and counts identical; K4 >= 99.9% bit-identical, within 1 bf16 ulp
     of the sum of the terms' magnitudes (the atomics add in another
     order), and identical on integer-valued cotangents;
 10. one train step on 8 frustums (on a 1/256 grid around their own
     mean) on the card and on the CPU (plain twins) from copies of the
     same model, with one dropout keep mask: in float32, total loss
     within 2% relative and cosine of the concatenated gradients >= 0.99;
     in bf16, with the mask and the box net's balls pinned, total loss
     within 2% and gradient cosines (whole model, seg net, T-Net, box
     net) at the limits of `BF16_COS`, printed beside two noise
     witnesses (each device against itself on the batch reversed) and
     three controls, each of which must fail a limit;
 11. 30 train steps on the fixed batch: losses finite and the mean of
     the last 5 below the first;
then times with CUDA events beside the card's name and power limit: the
train step at B=128 (ms and frustums/s), K3 and K4 vs their plain twins
at each of the 8 shapes and per step, and the peak device memory.
Then a JSON line with the kernels, and last the JSON ok line. Any failed
check exits non-zero and prints no ok line.
"""

from __future__ import annotations

import argparse
import copy
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

B, N, C = 128, 1024, 4
CHECK_B = 8  # frustums in the card-vs-CPU end-to-end check
# Phase 10's bf16 limits: a 2% loss gap and a seg-net cosine of 0.99; the
# whole-model, T-Net and box-net cosines do not reach 0.99 between two
# bf16 implementations, and their limits are set from the readings in
# PERF.md (the T-Net's gradient is a sum over the box net's input
# gradients that cancels to about 2e-4 of their magnitudes). Every limit
# is failed by one of phase 10's controls.
BF16_LOSS_REL = 0.02
BF16_COS = {"all": 0.95, "seg_net": 0.99, "tnet": 0.5, "box_net": 0.97}


def _fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        _fail(msg)


class Record:
    __slots__ = ("frame_id", "class_idx", "frustum_angle", "score", "box2d")

    def __init__(self, frame_id, class_idx, frustum_angle, score):
        self.frame_id = frame_id
        self.class_idx = class_idx
        self.frustum_angle = frustum_angle
        self.score = score
        self.box2d = np.zeros(4, np.float32)


class SyntheticFrustums:
    """Seeded frustums in the rotated-to-center frame: points on the
    surface of one object box (as a depth sensor sees it), plus clutter
    along the frustum ray and a ground plane, with an intensity channel.
    `spread` varies per frustum from a tight crop around the object to a
    frustum reaching meters beyond it. `get_batch` returns the dict
    `make_predict_step` takes."""

    def __init__(self, count: int, cfg, seed: int):
        from transferable3d_torch.core.geometry import rotate_points_y_np

        rng = np.random.RandomState(seed)
        self.records, self.points, self.class_idx = [], [], []
        for i in range(count):
            k = rng.randint(cfg.num_classes)
            size = (cfg.mean_size_array()[k]
                    * rng.uniform(0.8, 1.25, 3)).astype(np.float32)
            depth = rng.uniform(3.0, 8.0)
            center = np.array([rng.uniform(-0.25, 0.25) * depth,
                               rng.uniform(0.2, 1.2), depth], np.float32)
            spread = rng.uniform(0.05, 1.0)
            n_obj = rng.randint(200, N)
            local = rng.uniform(-0.5, 0.5, (n_obj, 3))
            face = rng.randint(0, 3, n_obj)
            local[np.arange(n_obj), face] = np.where(
                rng.rand(n_obj) < 0.5, -0.5, 0.5)
            local = local * size[[0, 2, 1]] + rng.normal(0, 0.01,
                                                         (n_obj, 3))
            obj = rotate_points_y_np(local[None].astype(np.float32),
                                     np.float32(rng.uniform(-np.pi, np.pi)))
            obj = obj[0] + center
            n_gr = rng.randint(0, (N - n_obj) // 2 + 1)
            half = 2.0 * spread
            ground = np.stack([center[0] + rng.uniform(-half, half, n_gr),
                               np.full(n_gr, center[1] + size[2] / 2),
                               center[2] + rng.uniform(-half, half, n_gr)],
                              -1)
            n_cl = N - n_obj - n_gr
            ray = center[None] * rng.uniform(1 - 0.6 * spread,
                                             1 + 0.4 * spread, (n_cl, 1))
            clutter = ray + rng.normal(0, 0.8 * spread, (n_cl, 3))
            pts = np.concatenate([obj, ground, clutter]).astype(np.float32)
            pts = pts[rng.permutation(N)]
            angle = float(-np.arctan2(center[0], center[2]))
            pts = rotate_points_y_np(pts[None], np.float32(angle))[0]
            inten = rng.uniform(0, 1, (N, 1)).astype(np.float32)
            self.points.append(np.concatenate([pts, inten], 1))
            self.class_idx.append(k)
            self.records.append(Record(f"smoke_{i:04d}", k, angle,
                                       float(rng.uniform(0.5, 1.0))))
        self.num_classes = cfg.num_classes

    def __len__(self):
        return len(self.records)

    def get_batch(self, idxs):
        k = np.asarray([self.class_idx[i] for i in idxs])
        return {"points": np.stack([self.points[i] for i in idxs]),
                "one_hot": np.eye(self.num_classes, dtype=np.float32)[k],
                "class_idx": k.astype(np.int64)}


def _perturb_bn(model, gen: torch.Generator) -> None:
    from transferable3d_torch.models.layers import ScheduledBatchNorm

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, ScheduledBatchNorm):
                f = m.mean.numel()
                m.mean.copy_(torch.randn(f, generator=gen) * 0.2)
                m.var.copy_(torch.rand(f, generator=gen) * 1.5 + 0.5)


def _time_ms(fn, warmup: int, iters: int) -> float:
    for _ in range(warmup):
        fn()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def serve(args, dev, card: str):
    """Phases 3-7 (serving); runs under torch.no_grad(). Returns the
    kernels' JSON entries for K1 and K2."""
    from transferable3d_torch.core import bins
    from transferable3d_torch.models import pointnet2, registry
    from transferable3d_torch.ops import _build, fused_sa, sampling
    from transferable3d_torch.train import test as test_lib
    from transferable3d_torch.train import train_loop

    # 3. model and inputs
    cfg = bins.SUNRGBD
    gen = torch.Generator().manual_seed(args.seed)
    model = registry.get_model("frustum_pointnets_v2", cfg,
                               dtype=torch.bfloat16, device=dev,
                               generator=gen).eval()
    _perturb_bn(model, gen)
    data = SyntheticFrustums(4 * B, cfg, args.seed)
    batch = data.get_batch(list(range(B)))
    predict = train_loop.make_predict_step(model, cfg)
    # Shift the foreground logit so about half the points are masked (a
    # random net masks almost none, and the box net then sees one point).
    logits = model.seg_net(torch.as_tensor(batch["points"], device=dev),
                           torch.as_tensor(batch["one_hot"], device=dev))
    logits = logits.float()
    model.seg_net.seg_out.bias[1] -= (logits[..., 1]
                                      - logits[..., 0]).median()
    print(f"phase 3 model: v2 bf16, "
          f"{sum(p.numel() for p in model.parameters())} params, "
          f"B={B} N={N} C={C}, seed {args.seed}", flush=True)

    # 4. the main path, with the kernels' arguments captured
    calls = {"fps": [], "sa_infer": []}
    orig_fps, orig_sa = pointnet2.farthest_point_sample, fused_sa.sa_infer

    def rec_fps(xyz, k):
        calls["fps"].append((xyz, k))
        return orig_fps(xyz, k)

    def rec_sa(*a):
        calls["sa_infer"].append(a)
        return orig_sa(*a)

    pointnet2.farthest_point_sample, fused_sa.sa_infer = rec_fps, rec_sa
    try:
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        out = predict(batch)
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
    finally:
        pointnet2.farthest_point_sample, fused_sa.sa_infer = orig_fps, orig_sa
    print(f"phase 4 predict: launches {launches}", flush=True)
    _check(launches == {"fps": 4, "sa_infer": 8, "extract_fwd": 0,
                        "extract_bwd": 0},
           f"expected 4 FPS and 8 fused SA launches, got {launches}")
    _check(len(calls["fps"]) == 4 and len(calls["sa_infer"]) == 8,
           "captured calls do not match the launches")
    for key, shape in (("center", (B, 3)), ("size", (B, 3)),
                       ("heading", (B,)), ("seg_conf", (B,))):
        _check(tuple(out[key].shape) == shape
               and bool(torch.isfinite(out[key]).all()),
               f"predict output {key} not finite of shape {shape}")
    _check(float(out["mask_count"].float().mean()) > 0, "empty masks only")
    for i, a in enumerate(calls["sa_infer"]):
        cent, xyz, r, k = a[0], a[1], a[4], a[5]
        d2 = sum((cent[:, :, None, c] - xyz[:, None, :, c]) ** 2
                 for c in range(3))
        cnt = (d2 <= fused_sa.radius_sq(r)).sum(-1)
        share = {name: float(m.float().mean()) for name, m in (
            ("empty", cnt == 0), ("short", (cnt > 0) & (cnt < k)),
            ("full", cnt == k), ("overfull", cnt > k))}
        print(f"  scale {i}: S={cent.shape[1]} N={xyz.shape[1]} K={k} "
              f"r={r}: " + " ".join(f"{nm} {v:.4f}"
                                    for nm, v in share.items()),
              flush=True)

    # 5. kernels vs plain twins on the captured arguments
    fps_err = 0.0
    for xyz, k in calls["fps"]:
        got, ref = sampling.fps_cuda(xyz, k), sampling.fps_plain(xyz, k)
        torch.cuda.synchronize()
        same = torch.equal(got, ref)
        fps_err = max(fps_err, float((got - ref).abs().max()))
        print(f"phase 5 fps [{xyz.shape[0]},{xyz.shape[1]}]->{k}: "
              f"indices identical {same}", flush=True)
        _check(same, "FPS kernel indices differ from the plain twin")
    sa_err = 0.0
    for a in calls["sa_infer"]:
        got = fused_sa.sa_infer_cuda(*a)
        ref = fused_sa.sa_infer_plain(*a)
        torch.cuda.synchronize()
        g, r = got.float(), ref.float()
        eq = float((g == r).float().mean())
        err = float((g - r).abs().max())
        top = float(r.abs().max())
        nz = float((r != 0).float().mean())
        sa_err = max(sa_err, err)
        print(f"phase 5 sa_infer S={a[0].shape[1]} K={a[5]} "
              f"F={[p.shape[-1] for p in a[6]]}: bit-identical {eq:.5f} "
              f"max|diff| {err:.4g} (max|pooled| {top:.4g}) "
              f"nonzero {nz:.3f}", flush=True)
        _check(eq >= 0.99 and err <= 0.01 * top and nz >= 0.10,
               "sa_infer kernel disagrees with its plain twin")
        # Every centroid is one of the points it groups, so the main path
        # never has an empty ball: move every other centroid 100 m away
        # to hold the kernel's nearest-point branch against the twin.
        far = a[0].clone()
        far[:, ::2] += 100.0
        got = fused_sa.sa_infer_cuda(far, *a[1:]).float()
        ref = fused_sa.sa_infer_plain(far, *a[1:]).float()
        eq_far = float((got == ref).float().mean())
        err_far = float((got - ref).abs().max())
        print(f"  empty-ball probe: bit-identical {eq_far:.5f} max|diff| "
              f"{err_far:.4g}", flush=True)
        _check(eq_far >= 0.99 and err_far <= 0.01 * float(ref.abs().max()),
               "sa_infer kernel disagrees on empty balls")
    small = data.get_batch(list(range(CHECK_B)))
    cpu_model = copy.deepcopy(model).to("cpu")
    ep_gpu = model(torch.as_tensor(small["points"], device=dev),
                   torch.as_tensor(small["one_hot"], device=dev))
    ep_cpu = cpu_model(torch.as_tensor(small["points"]),
                       torch.as_tensor(small["one_hot"]))
    lg, lc = ep_gpu["seg_logits"].float().cpu(), ep_cpu["seg_logits"].float()
    seg_rel = float((lg - lc).abs().max() / lc.abs().max())
    mask_agree = float((ep_gpu["mask"].cpu() == ep_cpu["mask"]).float().mean())
    print(f"phase 5 end-to-end card vs CPU plain twins ({CHECK_B} frustums):"
          f" seg logits max|diff|/max {seg_rel:.4g}, mask agreement "
          f"{mask_agree:.4f}", flush=True)
    _check(seg_rel <= 0.03 and mask_agree >= 0.99,
           "card path disagrees with the CPU reference")

    # 6. run_inference over 4 batches
    t0 = time.perf_counter()
    dets = test_lib.run_inference(model, data, cfg, batch_size=B)
    wall = time.perf_counter() - t0
    ok = all(np.isfinite(d.center).all() and np.isfinite(d.size).all()
             and math.isfinite(d.score) and math.isfinite(d.heading)
             for d in dets)
    print(f"phase 6 run_inference: {len(dets)} detections in {wall:.3f} s, "
          f"finite {ok}", flush=True)
    _check(len(dets) == 4 * B and ok, "run_inference output not finite")

    # 7. times
    kernels = []
    for name, kern, plain, cl, src, repl, err in (
            ("fps", sampling.fps_cuda, sampling.fps_plain, calls["fps"],
             "transferable3d_torch/csrc/fps.cu",
             "transferable3d_tpu/ops/sampling.py:47", fps_err),
            ("sa_infer", fused_sa.sa_infer_cuda, fused_sa.sa_infer_plain,
             calls["sa_infer"], "transferable3d_torch/csrc/sa_infer.cu",
             "transferable3d_tpu/ops/fused_sa.py:446", sa_err)):
        tot_k = tot_p = 0.0
        for a in cl:
            mk = _time_ms(lambda: kern(*a), 2, 10)
            mp = _time_ms(lambda: plain(*a), 1, 5)
            tot_k += mk
            tot_p += mp
            shape = (f"[{a[0].shape[0]},{a[0].shape[1]}]->{a[1]}"
                     if name == "fps" else
                     f"S={a[0].shape[1]} K={a[5]} "
                     f"F={[p.shape[-1] for p in a[6]]}")
            print(f"phase 7 {name} {shape}: kernel {mk:.4f} ms, plain "
                  f"{mp:.4f} ms {card}", flush=True)
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": repl, "launches": launches[name],
                        "max_abs_err": err, "ms": tot_k, "plain_ms": tot_p})
        print(f"phase 7 {name} per forward ({len(cl)} calls): kernel "
              f"{tot_k:.4f} ms, plain {tot_p:.4f} ms {card}", flush=True)
    step_ms = _time_ms(lambda: predict(batch), 2, 10)
    print(f"phase 7 predict step B={B}: {step_ms:.3f} ms, "
          f"{B * 1000.0 / step_ms:.1f} frustums/s {card}", flush=True)

    return kernels


def _ball_shares(cent, xyz, r, k):
    from transferable3d_torch.ops.grouping import direct_sqdist, radius_sq

    cnt = (direct_sqdist(cent, xyz) <= radius_sq(r)).sum(-1)
    return {name: float(m.float().mean()) for name, m in (
        ("empty", cnt == 0), ("short", (cnt > 0) & (cnt < k)),
        ("full", cnt == k), ("overfull", cnt > k))}


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 unit in the last place of each value of x (float32)."""
    return torch.ldexp(torch.ones_like(x), torch.frexp(x).exponent - 8)


def _grads(model):
    return {k: (torch.zeros_like(p) if p.grad is None else p.grad).float()
            for k, p in model.named_parameters()}


def _snap_to_grid(mod, args):
    """Forward pre-hook of the box net (phase 10, bf16): moves each
    frustum's object points rigidly to a frame both devices agree on, and
    onto the 1/256 grid. Their offsets from the first point lie on the
    grid up to f32 rounding, which the hook removes; their mean on that
    grid is then exact in any summation order. So both devices feed the
    box net the same exact coordinates, however the T-Net's output
    rounds, and take the same FPS picks and balls. The gradient passes
    straight through."""
    obj = args[0]
    with torch.no_grad():
        snapped = torch.round((obj - obj[:, :1]) * 256) / 256
        snapped -= torch.round(snapped.mean(dim=1, keepdim=True) * 256) / 256
    return (snapped + (obj - obj.detach()), *args[1:])


class _BF16SumGather:
    """Phase 10's control: the CPU path's grouped gather with plain
    autograd, which sums a bf16 cotangent in bf16, rounding at every add
    (the grouping code sums it in f32 and rounds once)."""

    @staticmethod
    def apply(src, idx):
        from transferable3d_torch.ops.grouping import flat_row_gather

        return flat_row_gather(src, idx)


def _cos(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    den = float(a.norm() * b.norm())
    return float((a * b).sum()) / den if den > 0 else float("nan")


def train_batch(cfg):
    """bench.py's v2_train batch from the port's data copies: 32
    synthetic frustums (n_object 600, n_clutter 300), 1024 points each,
    rotated to center, tiled to B."""
    from transferable3d_torch.data import synthetic
    from transferable3d_torch.data.provider import FrustumDataset

    recs = synthetic.make_dataset(32, cfg, seed=0, n_object=600,
                                  n_clutter=300)
    ds = FrustumDataset(recs, cfg, npoints=N, rotate_to_center=True)
    small = ds.get_batch(list(range(32)))
    return {k: np.concatenate([v] * (B // 32), axis=0)
            for k, v in small.items()}


def train(args, dev, card: str):
    """Phases 8-11 (training, T3D_FUSED_SA=0) and their times. Returns
    the kernels' JSON entries for K3 and K4."""
    saved = os.environ.get("T3D_FUSED_SA")
    os.environ["T3D_FUSED_SA"] = "0"
    try:
        return _train(args, dev, card)
    finally:
        if saved is None:
            del os.environ["T3D_FUSED_SA"]
        else:
            os.environ["T3D_FUSED_SA"] = saved


def _train(args, dev, card: str):
    from transferable3d_torch.core import bins
    from transferable3d_torch.models import layers, registry
    from transferable3d_torch.ops import _build, grouping
    from transferable3d_torch.train import schedules, train_loop

    # 8. one train step at the v2_train width, K3/K4 arguments captured
    cfg = bins.SUNRGBD
    batch = train_batch(cfg)
    model = registry.get_model(
        "frustum_pointnets_v2", cfg, dtype=torch.bfloat16, device=dev,
        generator=torch.Generator().manual_seed(args.seed + 1))
    initial = copy.deepcopy(model)
    lr = schedules.exponential_staircase_lr(batch_size=B)
    bn = schedules.bn_momentum_schedule(batch_size=B)
    state = train_loop.create_train_state(
        model, train_loop.make_optimizer(lr), seed=args.seed)
    step = train_loop.make_train_step(
        cfg, lr, bn, train_loop.StepConfig(compute_iou_metrics=True))
    calls = {"extract_fwd": [], "extract_bwd": []}
    orig_fwd, orig_bwd = grouping.extract_fwd_cuda, grouping.extract_bwd_cuda

    def detached(a):
        return tuple(x.detach() if torch.is_tensor(x) else x for x in a)

    def rec_fwd(*a):
        calls["extract_fwd"].append(detached(a))
        return orig_fwd(*a)

    def rec_bwd(*a):
        calls["extract_bwd"].append(detached(a))
        return orig_bwd(*a)

    grouping.extract_fwd_cuda, grouping.extract_bwd_cuda = rec_fwd, rec_bwd
    try:
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
    finally:
        grouping.extract_fwd_cuda = orig_fwd
        grouping.extract_bwd_cuda = orig_bwd
    print(f"phase 8 train step: launches {launches}", flush=True)
    _check(launches == {"fps": 4, "sa_infer": 0, "extract_fwd": 8,
                        "extract_bwd": 8},
           f"expected 4 FPS, 0 fused SA, 8 K3 and 8 K4 launches, got "
           f"{launches}")
    _check(len(calls["extract_fwd"]) == 8 and len(calls["extract_bwd"]) == 8,
           "captured calls do not match the launches")
    vals = {k: float(v) for k, v in metrics.items()}
    print("  metrics: " + " ".join(f"{k} {v:.5g}" for k, v in vals.items()),
          flush=True)
    _check(all(math.isfinite(v) for v in vals.values()),
           "a loss term or metric is not finite")
    grads = _grads(model)
    bad = [k for k, g in grads.items() if not bool(torch.isfinite(g).all())]
    _check(not bad, f"non-finite gradients: {bad}")
    zero = [k for k, g in grads.items() if not bool((g != 0).any())]
    print(f"  gradients: {len(grads)} leaves finite; all-zero leaves "
          f"{zero}", flush=True)
    for i, (cent, xyz, pay, r, k) in enumerate(calls["extract_fwd"]):
        share = _ball_shares(cent, xyz, r, k)
        print(f"  scale {i}: S={cent.shape[1]} N={xyz.shape[1]} K={k} "
              f"C={pay.shape[-1]} r={r}: "
              + " ".join(f"{nm} {v:.4f}" for nm, v in share.items()),
              flush=True)

    # 9. K3 and K4 vs their plain twins on the captured arguments (the
    # backward runs the scales in another order: pair them by inputs)
    fwd_err = bwd_err = 0.0
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def key(a):
        return a[0].data_ptr(), a[1].data_ptr(), a[3], a[4]

    cotangents = {key(a): a[2] for a in calls["extract_bwd"]}
    _check(len(cotangents) == 8, "backward calls do not pair with forward")
    for cent, xyz, pay, r, k in calls["extract_fwd"]:
        dg = cotangents[key((cent, xyz, pay, r, k))]
        far = cent.clone()
        far[:, ::2] += 100.0
        for tag, c in (("", cent), (" empty-ball probe", far)):
            got, cnt = grouping.extract_fwd_cuda(c, xyz, pay, r, k)
            ref, cref = grouping.extract_fwd_plain(c, xyz, pay, r, k)
            same = torch.equal(got, ref) and torch.equal(cnt, cref)
            fwd_err = max(fwd_err, float((got.float() - ref.float())
                                         .abs().max()))
            n = xyz.shape[1]
            have = grouping.extract_bwd_cuda(c, xyz, dg, r, k).float()
            want = grouping.extract_bwd_plain(c, xyz, dg, r, k, n).float()
            # One bf16 ulp of the sum of the terms' magnitudes: f32 sums
            # taken in another order differ by up to that much, however
            # much the terms cancel.
            scale = grouping.extract_bwd_plain(c, xyz, dg.abs(), r, k, n,
                                               torch.float32)
            eq = float((have == want).float().mean())
            err = float((have - want).abs().max())
            within = bool(((have - want).abs() <= _bf16_ulp(scale)).all())
            bwd_err = max(bwd_err, err)
            dgi = torch.randint(-4, 5, dg.shape, generator=gen,
                                device=dev).to(torch.bfloat16)
            exact = torch.equal(grouping.extract_bwd_cuda(c, xyz, dgi, r, k),
                                grouping.extract_bwd_plain(c, xyz, dgi, r,
                                                           k, n))
            print(f"phase 9{tag} S={c.shape[1]} N={n} K={k} "
                  f"C={pay.shape[-1]}: K3 identical {same}, empty "
                  f"{float((cnt == 0).float().mean()):.3f}; K4 "
                  f"bit-identical {eq:.6f} max|diff| {err:.4g} within 1 "
                  f"ulp of sum|terms| {within}, integer cotangents "
                  f"identical {exact}",
                  flush=True)
            _check(same, "K3 disagrees with its plain twin")
            _check(eq >= 0.999 and within and exact,
                   "K4 disagrees with its plain twin")

    # 10. the card against the CPU: one step on 8 frustums from copies of
    # the same model, with one dropout keep mask for every step. The
    # frustums are moved to their own mean and onto a 1/256 grid: far from
    # the origin the two devices' expanded-form distances differ by ~1e-5,
    # enough to move a point across a 0.2 m ball's boundary, and FPS is
    # chaotic (one different pick changes every later one); on the grid
    # the squared distances and the mask centroid are exact, so both
    # devices take the same discrete decisions in the seg net. In bf16
    # two more decisions are pinned: the foreground logit's bias is
    # raised past every logit gap, so that rounding cannot flip a point
    # of the mask on one side only, and the box net's input is snapped
    # to the grid (`_snap_to_grid`), so that the T-Net's bf16 rounding
    # cannot change the box net's balls on one side only.
    small = {k: v[:CHECK_B].copy() for k, v in batch.items()}
    mean = small["points"][..., :3].mean(axis=1)
    small["points"][..., :3] = np.round(
        (small["points"][..., :3] - mean[:, None]) * 256) / 256
    small["center"] = small["center"] - mean
    keep = layers.dropout_keep_mask(
        (CHECK_B, N, 128), 0.5, torch.Generator().manual_seed(args.seed + 2))
    perm = np.arange(CHECK_B)[::-1].copy()

    def one_step(dtype, where, pin=False, order=None, mask_keep=None):
        """One train step on `small` (its frustums in `order`) with the
        dropout keep mask `mask_keep` (default `keep`); `pin` adds the
        foreground `margin` and snaps the box net's input to the grid.
        Returns the loss, the gradients and the mask."""
        m = registry.get_model("frustum_pointnets_v2", cfg, dtype=dtype,
                               device=where)
        m.load_state_dict(initial.state_dict())
        if pin:
            with torch.no_grad():
                m.seg_net.seg_out.bias[1] += margin
            m.box_net.register_forward_pre_hook(_snap_to_grid)
        st = train_loop.create_train_state(
            m, train_loop.make_optimizer(lr), generator=torch.Generator())
        b_, k_ = small, keep if mask_keep is None else mask_keep
        if order is not None:
            b_ = {k: v[order] for k, v in small.items()}
            k_ = k_[torch.from_numpy(order)]
        seen = {}
        hook = m.register_forward_hook(
            lambda mod, a, out: seen.update(mask=out["mask"].cpu()))
        orig_keep = layers.dropout_keep_mask
        layers.dropout_keep_mask = lambda shape, rate, gen: k_
        try:
            _, met = train_loop.make_train_step(cfg, lr, bn)(st, b_)
        finally:
            layers.dropout_keep_mask = orig_keep
            hook.remove()
        mask = seen["mask"]
        if order is not None:
            mask = mask[torch.from_numpy(np.argsort(order))]
        return (float(met["total_loss"]),
                {k: g.cpu() for k, g in _grads(m).items()}, mask)

    def compare(a, b):
        """Relative loss gap, and gradient cosines: the whole model, each
        net, and the worst leaf."""
        (la, ga, _), (lb, gb, _) = a, b
        cos = {}
        for net in ("all", "seg_net", "tnet", "box_net"):
            ks = [k for k in ga if net == "all" or k.startswith(net + ".")]
            cos[net] = _cos(torch.cat([ga[k].ravel() for k in ks]),
                            torch.cat([gb[k].ravel() for k in ks]))
        leaf = min((_cos(ga[k].ravel(), gb[k].ravel()), k) for k in ga
                   if float(gb[k].norm()) > 0)
        return abs(la - lb) / abs(lb), cos, leaf

    def show(tag, res):
        rel, cos, leaf = res
        print(f"phase 10 {tag}: total loss rel {rel:.4g}, gradient cosine "
              + ", ".join(f"{k} {v:.5f}" for k, v in cos.items())
              + f", worst leaf {leaf[1]} {leaf[0]:.4f}", flush=True)

    on_card, on_cpu = (one_step(torch.float32, w) for w in ("cuda", "cpu"))
    _check(torch.equal(on_card[2], on_cpu[2]), "float32 masks differ")
    res = compare(on_card, on_cpu)
    show(f"card vs CPU, float32 ({CHECK_B} frustums)", res)
    _check(res[0] <= 0.02 and res[1]["all"] >= 0.99,
           "the card's float32 train step disagrees with the CPU's")

    probe = copy.deepcopy(initial).train()
    orig_keep = layers.dropout_keep_mask
    layers.dropout_keep_mask = lambda shape, rate, gen: keep
    try:
        with torch.no_grad():
            logits = probe(torch.as_tensor(small["points"], device=dev),
                           torch.as_tensor(small["one_hot"], device=dev),
                           bn(0), torch.Generator())["seg_logits"].float()
    finally:
        layers.dropout_keep_mask = orig_keep
    margin = 1.0 + 2.0 * float((logits[..., 1] - logits[..., 0]).abs().max())
    bf = torch.bfloat16
    on_card, on_cpu = one_step(bf, "cuda", True), one_step(bf, "cpu", True)
    _check(torch.equal(on_card[2], on_cpu[2]) and bool(on_card[2].all()),
           "bf16 masks differ or are not full")
    res = compare(on_card, on_cpu)
    runs = {"card vs CPU": res,
            "witness: card vs card on the batch reversed":
                compare(on_card, one_step(bf, "cuda", True, perm)),
            "witness: CPU vs CPU on the batch reversed":
                compare(on_cpu, one_step(bf, "cpu", True, perm))}
    # Controls: faults the limits must reject. The CPU side summing the
    # grouped cotangent in bf16 (what its backward did before it summed
    # in f32); both sides with the mask and the box net's balls left
    # free to differ; the CPU side with another dropout mask.
    orig_gather = grouping._SlotGather
    grouping._SlotGather = _BF16SumGather
    try:
        controls = {"control: CPU summing the grouped cotangent in bf16":
                    compare(on_card, one_step(bf, "cpu", True))}
    finally:
        grouping._SlotGather = orig_gather
    controls["control: both sides unpinned"] = compare(
        one_step(bf, "cuda"), one_step(bf, "cpu"))
    other = layers.dropout_keep_mask(
        (CHECK_B, N, 128), 0.5, torch.Generator().manual_seed(args.seed + 3))
    controls["control: CPU with another dropout mask"] = compare(
        on_card, one_step(bf, "cpu", True, mask_keep=other))
    print(f"phase 10 bf16 ({CHECK_B} frustums, foreground margin "
          f"{margin:.4g}); limits: total loss rel <= {BF16_LOSS_REL}, "
          "cosine " + ", ".join(f"{k} >= {v}" for k, v in BF16_COS.items()),
          flush=True)

    def failed(r):
        return ((["loss"] if r[0] > BF16_LOSS_REL else [])
                + [k for k, v in BF16_COS.items() if r[1][k] < v])

    for tag, r in {**runs, **controls}.items():
        show(f"  {tag}", r)
        print(f"    fails {failed(r) or 'no limit'}", flush=True)
    _check(not failed(res),
           "the card's bfloat16 train step disagrees with the CPU's")
    caught = {k for r in controls.values() for k in failed(r)}
    _check(caught >= {"loss", *BF16_COS},
           f"no control fails the limits {sorted({'loss', *BF16_COS} - caught)}")

    # 11. 30 steps on the fixed batch
    losses = []
    for _ in range(30):
        state, met = step(state, batch)
        losses.append(float(met["total_loss"]))
    print(f"phase 11 30 steps: first {losses[0]:.5g}, mean of last 5 "
          f"{np.mean(losses[-5:]):.5g}, all finite "
          f"{all(map(math.isfinite, losses))}", flush=True)
    _check(all(map(math.isfinite, losses)), "a training loss is not finite")
    _check(np.mean(losses[-5:]) < losses[0], "the loss did not decrease")

    # times
    torch.cuda.reset_peak_memory_stats(dev)
    step_ms = _time_ms(lambda: step(state, batch), 2, 5)
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"times train step B={B}: {step_ms:.3f} ms, "
          f"{B * 1000.0 / step_ms:.1f} frustums/s, peak device memory "
          f"{peak / 2**30:.2f} GiB {card}", flush=True)
    kernels = []
    for name, kern, plain, cl, repl, err in (
            ("extract_fwd", grouping.extract_fwd_cuda,
             grouping.extract_fwd_plain, calls["extract_fwd"],
             "transferable3d_tpu/ops/grouping.py:365", fwd_err),
            ("extract_bwd", grouping.extract_bwd_cuda,
             lambda c, x, d, r, k: grouping.extract_bwd_plain(
                 c, x, d, r, k, x.shape[1]),
             calls["extract_bwd"],
             "transferable3d_tpu/ops/grouping.py:381", bwd_err)):
        tot_k = tot_p = 0.0
        for a in cl:
            mk = _time_ms(lambda: kern(*a), 2, 10)
            mp = _time_ms(lambda: plain(*a), 1, 5)
            tot_k += mk
            tot_p += mp
            print(f"times {name} S={a[0].shape[1]} N={a[1].shape[1]} "
                  f"K={a[4]} C={a[2].shape[-1]}: kernel {mk:.4f} ms, plain "
                  f"{mp:.4f} ms {card}", flush=True)
        print(f"times {name} per step ({len(cl)} calls): kernel "
              f"{tot_k:.4f} ms, plain {tot_p:.4f} ms {card}", flush=True)
        kernels.append({"name": name, "route": "cuda",
                        "source": "transferable3d_torch/csrc/ball_extract.cu",
                        "replaces": repl, "launches": launches[name],
                        "max_abs_err": err, "ms": tot_k, "plain_ms": tot_p})
    return kernels

def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is false: this smoke run needs an "
              "NVIDIA GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from transferable3d_torch.ops import _build

    # Products accumulate in f32, as in the JAX package: no TF32, and no
    # bf16 partial sums in cuBLAS's split reductions.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda:0")

    # 1. the card
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    card = f"[{smi}]"
    print(f"phase 1 device: {kind}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, count {torch.cuda.device_count()}",
          flush=True)
    print(smi, flush=True)

    # 2. build
    t0 = time.perf_counter()
    _build.library()
    print(f"phase 2 build: kernels ready in "
          f"{time.perf_counter() - t0:.2f} s (nvcc "
          f"{'ran' if _build.build_seconds is not None else 'cached'})",
          flush=True)

    with torch.no_grad():
        kernels = serve(args, dev, card)
    kernels += train(args, dev, card)

    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
