"""Smoke run of the PyTorch port's serving path on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Drives `transferable3d_torch` (no JAX anywhere) through the F-PointNet v2
serving path at the width of the JAX package's `v2_infer` bench cell:
`get_model("frustum_pointnets_v2", SUNRGBD, dtype=bfloat16)` on cuda:0,
B=128 frustums of N=1024 points with C=4 channels, 512 object points
after masking. Weights are random from a seeded torch.Generator, BN
running statistics are perturbed away from 0/1, and the inputs are
seeded synthetic frustums (an object box plus clutter, 3-8 m ahead).

Phases, one line each (any failure exits non-zero and prints no ok line):
  1. card name and `nvidia-smi` name + power limit;
  2. build of the CUDA kernels (csrc/*.cu) and its time;
  3. model and inputs, and the share of empty / short / full / overfull
     balls at each of the 8 SA scales (no ball on this path is empty:
     every centroid is one of the points it groups; phase 5 therefore
     also checks K2 with half the centroids moved 100 m away);
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
Then a JSON line with the kernels, and last the JSON ok line.
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is false: this smoke run needs an "
              "NVIDIA GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from transferable3d_torch.core import bins
    from transferable3d_torch.models import pointnet2, registry
    from transferable3d_torch.ops import _build, fused_sa, sampling
    from transferable3d_torch.train import test as test_lib
    from transferable3d_torch.train import train_loop

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # Serving only: no autograd anywhere, so the arguments captured
    # under the predict step's inference mode can be reused below.
    torch.set_grad_enabled(False)
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
    _check(launches == {"fps": 4, "sa_infer": 8},
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

    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
