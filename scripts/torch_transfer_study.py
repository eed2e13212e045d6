"""Transfer-effect study on the PyTorch port: seeds x ablations of the
weak-class losses.

The port's twin of `scripts/transfer_study.py`, with its command line,
variants, seed-major loop, resume from `--out_json`, JSON record and
summary table. It runs the port's semi-supervised driver
(`transferable3d_torch.train.train_semisup`) on the HARD synthetic
distribution for each variant and seed:

  transfer   -- all four weak losses (fit / refine / reproj / size prior)
  control    -- weak_weight = 0 (strong classes only; no weak supervision)
  no_fit / no_refine / no_reproj / no_prior -- leave-one-out ablations

and reports mean +/- std of weak-class mAP@0.25 (full inference -> VOC
AP pipeline, not the in-graph IoU proxy), with a one-sided Mann-Whitney
U test of each variant against the control.

Usage:  python scripts/torch_transfer_study.py [--seeds 3] [--epochs 60]
        [--device cpu]
Runs on the card unless `--device` names another device; with no card
and no `--device` it raises. Writes the results to `--out_json`
(torch_transfer_study.json, not the JAX script's transfer_study.json,
which holds the JAX package's runs) and prints a table.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

# (fit, refine, reproj, size_prior, size_cls, trust_gate)
WEIGHTS = {"transfer": (1, 1, 1, 0.5, 0, True),
           "control": (1, 1, 1, 0.5, 0, True),
           "no_trust": (1, 1, 1, 0.5, 0, False),
           "no_fit": (0, 1, 1, 0.5, 0, True),
           "no_refine": (1, 0, 1, 0.5, 0, True),
           "no_reproj": (1, 1, 0, 0.5, 0, True),
           "no_prior": (1, 1, 1, 0, 0, True),
           "with_sizecls": (1, 1, 1, 0.5, 1, True)}


def study_config(variant: str, seed: int, args):
    """The run's `SemisupConfig`, field for field the JAX study's."""
    from transferable3d_torch.train import train_semisup

    wf, wr, wp, ws, wsc, trust = WEIGHTS[variant]
    return train_semisup.SemisupConfig(
        model=args.model, num_point=args.num_point,
        per_class_diag=args.diag,
        num_channels=4, batch_size=args.batch_size,
        max_epoch=args.epochs, boxpc_epochs=args.boxpc_epochs,
        synthetic_train=args.train_size, synthetic_val=args.val_size,
        synthetic_hard=True, compute_dtype="bfloat16",
        device_data=True, max_points_device=1024,
        log_dir=os.path.join(args.out_dir, f"{variant}_s{seed}"), seed=seed,
        eval_every_epochs=20, ckpt_every_epochs=20,
        weak_weight=0.0 if variant == "control" else args.weak_weight,
        weak_warmup_steps=args.weak_warmup_steps,
        weak_fit=wf, weak_refine=wr, weak_reproj=wp, weak_size_prior=ws,
        weak_size_cls=wsc, weak_trust_gate=trust,
        boxpc_aniso_aug=args.boxpc_aniso_aug)


def weak_val_map(cfg, device) -> dict:
    """Weak-class APs@0.25 of the newest detector checkpoint in
    `cfg.log_dir` through the full inference + VOC AP pipeline."""
    from transferable3d_torch.eval import ap as ap_lib
    from transferable3d_torch.models import registry
    from transferable3d_torch.train import schedules, train_loop
    from transferable3d_torch.train import test as test_lib
    from transferable3d_torch.train import train_semisup
    from transferable3d_torch.utils.checkpoint import CheckpointManager

    bins_cfg = cfg.bin_config()
    _, _, weak_val = train_semisup.build_semisup_datasets(cfg)
    sample = weak_val.get_batch(
        list(range(min(cfg.batch_size, len(weak_val)))))
    kw = ({} if cfg.model == "box_estimation_v1"
          else {"in_channels": sample["points"].shape[-1]})
    detector = registry.get_model(cfg.model, bins_cfg, dtype=torch.bfloat16,
                                  device=device, **kw)
    lr = schedules.exponential_staircase_lr(batch_size=cfg.batch_size)
    tx = train_loop.make_optimizer(lr)
    template = train_loop.create_train_state(detector, tx)
    ckpt = CheckpointManager(f"{cfg.log_dir}/ckpt")
    state = ckpt.restore_latest(template)
    ckpt.close()
    if state is None:
        raise FileNotFoundError(f"no ckpt in {cfg.log_dir}")
    dets = test_lib.run_inference(state.model, weak_val, bins_cfg,
                                  cfg.batch_size)
    return ap_lib.eval_det(test_lib.detections_to_eval_boxes(dets),
                           test_lib.groundtruth_boxes(weak_val, bins_cfg),
                           iou_thresh=0.25)


def run_one(variant: str, seed: int, args) -> dict:
    from transferable3d_torch import resolve_device
    from transferable3d_torch.train import train_semisup

    device = resolve_device(args.device)
    cfg = study_config(variant, seed, args)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.time()
    train_semisup.train(cfg, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        print(f"[{variant} seed {seed}] peak device memory "
              f"{torch.cuda.max_memory_allocated(device) / 2 ** 30:.3f} GiB "
              f"in training on {torch.cuda.get_device_name(device)}",
              flush=True)
    train_s = time.time() - t0
    aps = weak_val_map(cfg, device)
    return {"variant": variant, "seed": seed, "model": cfg.model,
            "mAP": aps["mAP"],
            "per_class": {k: v for k, v in aps.items() if k != "mAP"},
            "train_seconds": round(train_s, 1)}


def summary(results) -> None:
    """Each variant's mean +/- std, its gap to the control and, with 3 or
    more runs on both sides, the one-sided Mann-Whitney U test's p."""
    print("\n== summary (weak-class mAP@0.25, mean +/- std) ==")
    by_var = {}
    for r in results:
        by_var.setdefault(r["variant"], []).append(r["mAP"])
    ctl = by_var.get("control", [0])
    base = np.mean(ctl)
    for v, xs in sorted(by_var.items()):
        line = (f"{v:10s} {np.mean(xs):.4f} +/- {np.std(xs):.4f}  "
                f"(delta vs control: {np.mean(xs) - base:+.4f}, "
                f"n={len(xs)}")
        if v != "control" and len(xs) >= 3 and len(ctl) >= 3:
            from scipy.stats import mannwhitneyu
            p_val = mannwhitneyu(xs, ctl, alternative="greater").pvalue
            line += f", U-test p={p_val:.3f}"
        print(line + ")")


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--seeds", type=int, default=3)
    p.add_argument("--epochs", type=int, default=60)
    p.add_argument("--boxpc_epochs", type=int, default=40)
    p.add_argument("--train_size", type=int, default=2048)
    p.add_argument("--val_size", type=int, default=512)
    p.add_argument("--num_point", type=int, default=512)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--model", default="frustum_pointnets_v1",
                   help="detector registry name (the v2 study runs with"
                        " frustum_pointnets_v2)")
    p.add_argument("--diag", action="store_true",
                   help="log per-class trust-gate/loss diagnostics to"
                        " the run's metrics_train.csv")
    p.add_argument("--weak_weight", type=float, default=1.0)
    p.add_argument("--boxpc_aniso_aug", type=float, default=0.8,
                   help="phase-A joint cloud+box anisotropic rescale "
                        "log-range (0 disables)")
    p.add_argument("--weak_warmup_steps", type=int, default=0)
    p.add_argument("--variants", default="transfer,control,no_fit,"
                                         "no_refine,no_reproj,no_prior")
    p.add_argument("--seed_list", default=None,
                   help="comma-separated explicit seeds (overrides"
                        " --seeds)")
    # Not JAX's defaults: its JSON at the root holds the JAX package's
    # runs, which resume (keyed on variant and seed) would take as done.
    p.add_argument("--out_dir", default=os.path.join(
        tempfile.gettempdir(), "torch_transfer_study"))
    p.add_argument("--out_json", default="torch_transfer_study.json")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; cpu for tests)")
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    results = []
    if os.path.exists(args.out_json):  # resume
        with open(args.out_json) as f:
            results = json.load(f)
    done = {(r["variant"], r["seed"]) for r in results}
    seeds = ([int(s) for s in args.seed_list.split(",")]
             if args.seed_list else list(range(args.seeds)))
    # Seed-major so an interrupted run leaves a balanced partial record
    # (every finished seed has all its variants).
    for seed in seeds:
        for variant in args.variants.split(","):
            if (variant, seed) in done:
                continue
            r = run_one(variant, seed, args)
            results.append(r)
            with open(args.out_json, "w") as f:
                json.dump(results, f, indent=1)
            print(f"[{variant} seed {seed}] mAP@0.25 = {r['mAP']:.4f} "
                  f"({r['train_seconds']}s)", flush=True)
    summary(results)


if __name__ == "__main__":
    main()
