"""Where a train step of the PyTorch port spends its time on the card.

    python3 scripts/torch_profile_train_step.py [--fused 0|1] [--steps 3]
    python3 scripts/torch_profile_train_step.py --model v1 [--e2e [--hw 480x640]]
    python3 scripts/torch_profile_train_step.py --predict [--root PATH]

Builds F-PointNet v2 (or, with `--model v1`, v1) in bf16 at the
`v2_train` width of chip_smoke.py (B=128, N=1024, C=4, 512 object
points; seeded weights and the port's synthetic batch). With `--e2e`
(v1 only) the step is chip_smoke's end-to-end one: every step lifts 128
frustums of 3 channels from 32 synthetic 96x128 depth maps on the card
(`scene_to_train_batch`, kernel K15) and trains on them, and the
preprocessing's share of the step's device time and its kernels are
printed; `--hw 480x640` takes the depth maps at SUN RGB-D's resolution
(chip_smoke.py's phase 21) instead of `bench.py`'s reduced one. Runs 3
warm-up steps, times `--steps` steps with CUDA
events, then profiles the same number of steps with `torch.profiler` and
prints: the step time, the device time per step (the sum of the kernels'
own times, so the idle share follows), the number of device kernels per
step, the five training kernels' (or, with `--fused 0`, K3/K4's) times by
name, and the operators that hold the most device time. `--fused 1` (the
default) leaves `T3D_FUSED_SA` unset; `--fused 0` sets it to "0". With
`--predict` the step is v2's `make_predict_step` in chip_smoke.py's
serving configuration (perturbed BN statistics, half the points masked)
instead of a train step. `--root PATH` imports the port and chip_smoke.py
from another checkout, so that two trees are measured on one card in one
call (parent, tree, tree, parent). Needs one NVIDIA GPU; imports no JAX.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--fused", type=int, default=1, choices=(0, 1))
    ap.add_argument("--model", default="v2", choices=("v1", "v2"))
    ap.add_argument("--e2e", action="store_true",
                    help="v1 only: depth maps -> frustums -> step")
    ap.add_argument("--hw", default="96x128",
                    help="--e2e: the depth maps' height x width")
    ap.add_argument("--predict", action="store_true",
                    help="v2's predict step (serving) instead of a train step")
    ap.add_argument("--root", default=ROOT,
                    help="checkout to import the port from")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    if args.e2e and args.model != "v1":
        ap.error("--e2e runs F-PointNet v1: pass --model v1")
    h, w = (int(x) for x in args.hw.split("x"))
    if args.predict and (args.e2e or args.model != "v2"):
        ap.error("--predict runs F-PointNet v2's predict step")
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU (CUDA)")
    import chip_smoke
    from transferable3d_torch.core import bins
    from transferable3d_torch.data import depth_pipeline
    from transferable3d_torch.models import registry
    from transferable3d_torch.train import schedules, train_loop

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda:0")
    cfg = bins.SUNRGBD
    nb = chip_smoke.B
    model = registry.get_model(
        f"frustum_pointnets_{args.model}", cfg, dtype=torch.bfloat16,
        device=dev, in_channels=3 if args.e2e else 4,
        generator=torch.Generator().manual_seed(args.seed + 1))
    lr = schedules.exponential_staircase_lr(batch_size=nb)
    bn = schedules.bn_momentum_schedule(batch_size=nb)
    state = train_loop.create_train_state(
        model, train_loop.make_optimizer(lr), seed=args.seed)
    train_step = train_loop.make_train_step(
        cfg, lr, bn, train_loop.StepConfig(
            compute_iou_metrics=not args.e2e, use_valid_weights=args.e2e))
    if args.predict:
        gen = torch.Generator().manual_seed(args.seed)
        model = registry.get_model("frustum_pointnets_v2", cfg,
                                   dtype=torch.bfloat16, device=dev,
                                   generator=gen).eval()
        chip_smoke._perturb_bn(model, gen)
        batch = chip_smoke.SyntheticFrustums(nb, cfg, args.seed).get_batch(
            list(range(nb)))
        with torch.no_grad():
            logits = model.seg_net(
                torch.as_tensor(batch["points"], device=dev),
                torch.as_tensor(batch["one_hot"], device=dev)).float()
            model.seg_net.seg_out.bias[1] -= (logits[..., 1]
                                              - logits[..., 0]).median()
        predict = train_loop.make_predict_step(model, cfg)

        def step():
            predict(batch)
    elif args.e2e:
        scene = depth_pipeline.scene_to_device(depth_pipeline.make_depth_scene(
            np.random.RandomState(args.seed), cfg, n_frames=nb // 4,
            boxes_per_frame=4, h=h, w=w)[0], dev)
        gen = torch.Generator(device=dev).manual_seed(args.seed)

        def prep():
            return depth_pipeline.scene_to_train_batch(
                scene, gen, chip_smoke.N, cfg, device=dev)

        def step():
            with torch.profiler.record_function("scene_to_train_batch"):
                batch = prep()
            train_step(state, batch)
    else:
        batch = chip_smoke.train_batch(cfg)

        def step():
            train_step(state, batch)

    with chip_smoke.fused_sa_env(None if args.fused else "0"):
        ms = chip_smoke._time_ms(step, 3, args.steps)
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(args.steps):
                step()
            torch.cuda.synchronize()
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    # Kernel rows carry the device's own time; an operator row repeats the
    # time of the kernels it launched, so only one kind is summed.
    from torch.autograd import DeviceType

    rows = [e for e in events if e.device_type == DeviceType.CUDA]
    total = sum(dev_us(e) for e in rows)
    kernels = sum(e.count for e in rows)
    path = (f"v1, end to end from {h}x{w} depth maps" if args.e2e else "v1"
            if args.model == "v1" else "fused (T3D_FUSED_SA unset)"
            if args.fused else "T3D_FUSED_SA=0")
    what = "predict step" if args.predict else "train step"
    print(f"[{card}] [{os.path.abspath(args.root)}] {what} B={nb}, {path}: "
          f"{ms:.3f} ms a step "
          f"unprofiled ({nb * 1000.0 / ms:.1f} frustums/s); device time "
          f"{total / 1e3 / args.steps:.3f} ms a step, idle share "
          f"{1 - total / 1e3 / args.steps / ms:.3f}; {kernels // args.steps} "
          "device kernels a step")
    if total == 0:
        sys.exit("the profiler recorded no device time")
    for e in events:
        # The span has two rows: the host's (the kernels launched inside
        # it, and its host time under the profiler) and the device's (from
        # its first kernel's start to its last one's end on the card).
        if e.key != "scene_to_train_batch":
            continue
        t = getattr(e, "device_time_total",
                    getattr(e, "cuda_time_total", 0)) / 1e3 / args.steps
        if e.device_type == DeviceType.CUDA:
            print(f"  scene_to_train_batch spans {t:.3f} ms a step on the "
                  f"card's timeline ({t / ms:.1%} of the step)")
        else:
            print(f"  scene_to_train_batch: its kernels take {t:.3f} ms of "
                  f"device time a step ({t * 1e3 * args.steps / total:.1%}); "
                  f"{e.cpu_time_total / 1e3 / args.steps:.3f} ms on the "
                  "host under the profiler")
    ours = [e for e in rows if "sa_" in e.key or "extract" in e.key
            or "fps" in e.key or "reduce_partials" in e.key
            or "fetch_select" in e.key or "round_bf16" in e.key]
    for e in sorted(ours, key=dev_us, reverse=True):
        print(f"  kernel {e.key[:70]}: {dev_us(e) / 1e3 / args.steps:.3f} ms "
              f"a step ({dev_us(e) / total:.1%}), {e.count // args.steps} "
              "launches")
    print("  operators by their own device time:")
    top = sorted((e for e in events if e.key.startswith("aten::")),
                 key=dev_us, reverse=True)[:12]
    for e in top:
        print(f"    {e.key}: {dev_us(e) / 1e3 / args.steps:.3f} ms a step "
              f"({dev_us(e) / total:.1%}), {e.count // args.steps} calls")
    if not args.e2e:
        return
    # The preprocessing alone: its kernels and operators by device time.
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(args.steps):
            prep()
        torch.cuda.synchronize()
    events = prof.key_averages()
    rows = [e for e in events if e.device_type == DeviceType.CUDA]
    ptot = sum(dev_us(e) for e in rows)
    print(f"  scene_to_train_batch alone: {ptot / 1e3 / args.steps:.3f} ms "
          f"of device time a call in {sum(e.count for e in rows) // args.steps}"
          " kernels; kernels by their own device time:")
    for e in sorted(rows, key=dev_us, reverse=True)[:10]:
        print(f"    {e.key[:90]}: {dev_us(e) / 1e3 / args.steps:.4f} ms "
              f"({dev_us(e) / ptot:.1%}), {e.count // args.steps} launches")
    print("    operators:")
    for e in sorted((e for e in events if e.key.startswith("aten::")),
                    key=dev_us, reverse=True)[:10]:
        print(f"    {e.key}: {dev_us(e) / 1e3 / args.steps:.4f} ms "
              f"({dev_us(e) / ptot:.1%}), {e.count // args.steps} calls")


if __name__ == "__main__":
    main()
