"""Phase B of the transfer study's control arm in both packages, on the CPU.

Runs the JAX package's semi-supervised driver
(`transferable3d_tpu.train.train_semisup.train`) and the port's
(`transferable3d_torch.train.train_semisup.train(cfg, device="cpu")`) at
study6's protocol (`scripts/torch_transfer_study6.sh`, the JAX package's
`scripts/tpu_sweep.sh` stage 8): v2 backbone in bf16, N=512, B=64, C=4,
4,096 train and 1,024 val hard synthetic frustums, device-resident data,
weak warmup 2,000 steps, per-class diagnostics, the control arm
(weak_weight = 0). Only the length is cut: `--epochs` phase-B epochs of
25 or 26 steps, as the seed's strong split gives (5 by default: steps
25-125 at seeds 0 and 1), and `--boxpc_epochs` BoxPC epochs
(1 by default; `--check_phase_a` shows that with weak_weight = 0 phase
A's length changes neither the detector's start nor its data).

It then reads each run's `metrics_train.csv` beside the study's card and
TPU runs of the same seeds and writes one JSON: the box and seg losses
at every logged step for four sources (JAX on the CPU, the port on the
CPU, JAX on the TPU from `artifacts/study6_control_s<seed>_metrics.csv`,
the port on the H100 from
`chiprun_out/pr12_study/control_s<seed>/metrics_train.csv`), their
ranges over seeds (the random streams differ between the packages, so
the sources are compared by distribution), and which case the three box
losses (heading class, heading residual, centre) show at every epoch
that all four sources reach:

  (a) every seed of JAX on the CPU lies inside the port's range (its CPU
      and card seeds together) and outside JAX on the TPU's: the
      difference comes from the JAX package's TPU run;
  (b) every one lies inside JAX on the TPU's range and outside the
      port's: the port is at fault;
  (c) neither: the JSON lists, for each loss and epoch, where JAX on the
      CPU's seeds lie.

This script imports both packages, so it runs only where JAX is
installed (the card's machine has none). Each run is a child process
under a time limit; runs whose CSV already reaches the last step are
not run again.

Usage:
  python scripts/torch_vs_jax_semisup.py [--seeds 0,1,2] [--epochs 5]
      [--packages jax,torch] [--jobs 3] [--threads 2] [--out_dir DIR]
      [--out_json torch_vs_jax_semisup.json]
  python scripts/torch_vs_jax_semisup.py --collect   # only the JSON
  python scripts/torch_vs_jax_semisup.py --check_phase_a
  python scripts/torch_vs_jax_semisup.py --lockstep [--ls_steps 100]
      [--ls_batch 32] [--ls_points 256] [--ls_dtype float32]
      [--out_json lockstep.json]

`--lockstep` runs both packages' phase-B step (control arm) from one
bridged state on the same batches and dropout masks, beside a witness
(see `lockstep`), to find where the two part.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

KEYS = ("heading_class_loss", "heading_residual_loss", "center_loss",
        "size_class_loss", "seg_loss")
BOX_KEYS = KEYS[:3]  # the terms whose gap C3 is about
PACKAGES = ("jax", "torch")
CHECK_STEPS = 2  # phase-B steps of each `--check_phase_a` run


def study_kwargs(seed: int, log_dir: str, epochs: int, boxpc_epochs: int,
                 max_steps: int = 0) -> dict:
    """`SemisupConfig` fields of study6's control arm (the same in both
    packages), cut to `epochs` phase-B and `boxpc_epochs` BoxPC epochs."""
    return dict(
        model="frustum_pointnets_v2", num_point=512, per_class_diag=True,
        num_channels=4, batch_size=64, max_epoch=epochs,
        boxpc_epochs=boxpc_epochs, synthetic_train=4096,
        synthetic_val=1024, synthetic_hard=True, compute_dtype="bfloat16",
        device_data=True, max_points_device=1024, log_dir=log_dir,
        seed=seed, eval_every_epochs=20, ckpt_every_epochs=20,
        weak_weight=0.0, weak_warmup_steps=2000, weak_fit=1,
        weak_refine=1, weak_reproj=1, weak_size_prior=0.5,
        weak_size_cls=0, weak_trust_gate=True, boxpc_aniso_aug=0.8,
        max_steps=max_steps)


def run_jax(kw: dict) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_prng_impl", "rbg")  # as the study
    from transferable3d_tpu.train import train_semisup

    train_semisup.train(train_semisup.SemisupConfig(**kw))


def run_torch(kw: dict, threads: int) -> None:
    import torch

    from transferable3d_torch.train import train_semisup

    torch.set_num_threads(threads)
    train_semisup.train(train_semisup.SemisupConfig(**kw), device="cpu")


def read_csv(path: str) -> dict:
    """{step: {key: value}} of a run's `metrics_train.csv`."""
    with open(path) as f:
        return {int(r["step"]): {k: float(r[k]) for k in KEYS}
                for r in csv.DictReader(f)}


def run_dir(out_dir: str, package: str, seed: int) -> str:
    return os.path.join(out_dir, f"{package}_control_s{seed}")


def finished(path: str, epochs: int) -> bool:
    """Whether a run's CSV holds its `epochs` logged epochs."""
    return os.path.exists(path) and len(read_csv(path)) >= epochs


def launch(args, cpus: str, package: str, seed: int, log_dir: str,
           epochs: int, boxpc_epochs: int, max_steps: int = 0
           ) -> subprocess.Popen:
    """One run as a child process on the CPUs `cpus` (taskset's list)."""
    cmd = ["taskset", "-c", cpus, "timeout", "-k", "10", str(args.timeout),
           sys.executable,
           os.path.abspath(__file__), "--run", package, "--seed", str(seed),
           "--log_dir", log_dir, "--epochs", str(epochs),
           "--boxpc_epochs", str(boxpc_epochs), "--max_steps",
           str(max_steps), "--threads", str(args.threads)]
    os.makedirs(log_dir, exist_ok=True)
    with open(os.path.join(log_dir, "stdout.txt"), "w") as log:
        return subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                                cwd=ROOT)


def run_all(args, jobs) -> None:
    """Run `jobs` [(package, seed, log_dir, epochs, boxpc_epochs,
    max_steps)] as child processes, `args.jobs` at a time; raise if one
    fails."""
    pending, running, failed = list(jobs), [], []
    free = [",".join(str(c) for c in range(i * args.threads,
                                           (i + 1) * args.threads))
            for i in range(args.jobs)]
    while pending or running:
        while pending and free:
            job, cpus = pending.pop(0), free.pop(0)
            running.append((job, cpus, time.time(),
                            launch(args, cpus, *job)))
            print(f"started {job[0]} seed {job[1]} in {job[2]} on CPUs "
                  f"{cpus}", flush=True)
        time.sleep(5)
        for item in list(running):
            job, cpus, t0, proc = item
            if proc.poll() is None:
                continue
            running.remove(item)
            free.append(cpus)
            print(f"{job[0]} seed {job[1]}: exit {proc.returncode} after "
                  f"{time.time() - t0:.1f} s", flush=True)
            if proc.returncode:
                failed.append(job)
    if failed:
        raise SystemExit(f"runs failed (see their stdout.txt): {failed}")


def detector_leaves(package: str, log_dir: str, kw: dict) -> dict:
    """The newest detector checkpoint of a run as {name: numpy array}."""
    import numpy as np

    if package == "torch":
        import torch

        from transferable3d_torch.utils.checkpoint import CheckpointManager

        ckpt = CheckpointManager(os.path.join(log_dir, "ckpt"))
        state = torch.load(os.path.join(ckpt.directory, str(ckpt.steps()[-1]),
                                        "state.pt"), weights_only=False)
        return {k: v.float().numpy() if v.is_floating_point() else v.numpy()
                for k, v in state["model"].items()}
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_prng_impl", "rbg")  # as the runs
    from transferable3d_tpu.models import registry
    from transferable3d_tpu.train import schedules, train_loop, train_semisup
    from transferable3d_tpu.utils.checkpoint import CheckpointManager

    cfg = train_semisup.SemisupConfig(**kw)
    bins_cfg = cfg.bin_config()
    strong, _, _ = train_semisup.build_semisup_datasets(cfg)
    detector = registry.get_model(cfg.model, bins_cfg, dtype=jnp.bfloat16)
    tx = train_loop.make_optimizer(schedules.exponential_staircase_lr(
        batch_size=cfg.batch_size))
    template = train_loop.create_train_state(
        detector, bins_cfg, tx, strong.get_batch(list(range(64))))
    ckpt = CheckpointManager(os.path.join(log_dir, "ckpt"))
    state = ckpt.restore_latest(template)
    ckpt.close()
    flat = jax.tree_util.tree_flatten_with_path(
        {"params": state.params, "batch_stats": state.batch_stats})[0]
    return {jax.tree_util.keystr(p): np.asarray(v, dtype=np.float32)
            for p, v in flat}


def check_phase_a(args) -> dict:
    """Each package run twice with weak_weight = 0 for `CHECK_STEPS`
    phase-B steps, once after 1 and once after 2 BoxPC epochs: the
    detector's checkpoint and the logged losses must be the same bits."""
    import numpy as np

    steps = CHECK_STEPS
    base = os.path.join(args.out_dir, "phase_a_check")
    jobs = [(p, 0, os.path.join(base, f"{p}_boxpc{b}"), 1, b, steps)
            for p in PACKAGES for b in (1, 2)]
    run_all(args, [j for j in jobs if not finished(
        os.path.join(j[2], "metrics_train.csv"), 1)])
    out = {}
    for p in PACKAGES:
        dirs = [os.path.join(base, f"{p}_boxpc{b}") for b in (1, 2)]
        kw = study_kwargs(0, dirs[0], 1, 1, steps)
        a, b = (detector_leaves(p, d, kw) for d in dirs)
        same_weights = (a.keys() == b.keys() and all(
            np.array_equal(a[k], b[k]) for k in a))
        ca, cb = (read_csv(os.path.join(d, "metrics_train.csv"))
                  for d in dirs)
        out[p] = {"phase_b_steps": steps, "tensors": len(a),
                  "detector_bit_identical": bool(same_weights),
                  "losses_identical": ca == cb,
                  "losses": ca[steps]}
        print(f"{p}: {len(a)} detector tensors after {steps} phase-B steps "
              f"bit-identical with 1 and 2 BoxPC epochs: {same_weights}; "
              f"losses identical: {ca == cb}", flush=True)
    with open(os.path.join(base, "phase_a_check.json"), "w") as f:
        json.dump(out, f, indent=1)
    return out


def _numpy_tree(tree) -> dict:
    """A pytree of mappings -> nested dicts of numpy arrays."""
    import numpy as np

    if hasattr(tree, "items"):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.array(tree)


def _leaves(tree, prefix="") -> dict:
    """Nested dicts -> {"a/b/kernel": float32 array}."""
    import numpy as np

    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if hasattr(v, "items"):
            out.update(_leaves(v, path))
        else:
            out[path] = np.asarray(v, np.float32)
    return out


def _rel_gap(a: dict, b: dict) -> float:
    """Relative L2 distance between two {name: array} sets of weights."""
    num = sum(float(((a[k] - b[k]) ** 2).sum()) for k in a)
    den = sum(float((a[k] ** 2).sum()) for k in a)
    return (num / den) ** 0.5


def box_net_split(detector, params, stats, port_model, batch, keep, m,
                  rng) -> dict:
    """Where the two packages' first forward parts, from one state on one
    batch and dropout mask: the seg logits, the box net's input (the
    masked object points less the T-Net's delta) and each package's box
    net on both inputs, as relative gaps to JAX's box net on JAX's input.
    The port's model is copied, so its BN statistics stay as they are."""
    import copy

    import jax.numpy as jnp
    import numpy as np
    import torch

    from transferable3d_tpu.models import model_util as jmu
    from transferable3d_tpu.models.frustum_pointnet_v2 import (
        BoxEstimationNetV2)
    from transferable3d_torch.models import layers as tlayers

    ep, upd = detector.apply(
        {"params": params, "batch_stats": stats}, batch["points"],
        batch["one_hot"], train=True, bn_momentum=m, rngs={"dropout": rng},
        mutable=["batch_stats", "intermediates"],
        capture_intermediates=lambda mdl, _: mdl.name == "tnet")
    delta = upd["intermediates"]["tnet"]["__call__"][0]
    masked = jmu.point_cloud_masking(jnp.asarray(batch["points"]),
                                     ep["seg_logits"],
                                     detector.num_object_point)
    obj_j = np.asarray(masked.object_points - delta[:, None, :])

    model = copy.deepcopy(port_model)
    got = {}
    model.box_net.register_forward_pre_hook(
        lambda mod, a: got.__setitem__("obj", a[0].detach().numpy().copy()))
    real_mask = tlayers.dropout_keep_mask
    tlayers.dropout_keep_mask = lambda shape, rate, gen: keep
    try:
        tep = model(torch.from_numpy(batch["points"]),
                    torch.from_numpy(batch["one_hot"]), bn_momentum=m,
                    generator=torch.Generator())
    finally:
        tlayers.dropout_keep_mask = real_mask
    obj_t = got["obj"]
    one_hot = batch["one_hot"]
    jbox = BoxEstimationNetV2(cfg=detector.cfg, dtype=detector.dtype)

    def run_jax(obj):
        out, _ = jbox.apply({"params": params["box_net"],
                             "batch_stats": stats["box_net"]},
                            jnp.asarray(obj), jnp.asarray(one_hot),
                            train=True, bn_momentum=m,
                            mutable=["batch_stats"])
        return np.asarray(out, np.float64)

    def run_port(obj):
        net = copy.deepcopy(port_model.box_net)
        return net(torch.from_numpy(obj), torch.from_numpy(one_hot),
                   m).detach().double().numpy()

    ref = run_jax(obj_j)
    scale = float(np.abs(ref).max())
    seg_j = np.asarray(ep["seg_logits"], np.float64)
    seg_t = tep["seg_logits"].detach().double().numpy()
    return {
        "seg_logits_rel_gap": float(np.abs(seg_t - seg_j).max()
                                    / np.abs(seg_j).max()),
        "seg_mask_points_differing": int(
            (tep["mask"].numpy() != np.asarray(ep["mask"])).sum()),
        "box_net_input_max_abs_gap": float(np.abs(obj_t - obj_j).max()),
        "box_net_input_max_abs": float(np.abs(obj_j).max()),
        "box_net_input_entries_differing": int((obj_t != obj_j).sum()),
        "box_net_input_entries": int(obj_j.size),
        "box_net_output_rel_gap_to_jax_on_jax_input": {
            "jax_on_port_input": float(np.abs(run_jax(obj_t) - ref).max()
                                       / scale),
            "port_on_jax_input": float(np.abs(run_port(obj_j) - ref).max()
                                       / scale),
            "port_on_port_input": float(np.abs(run_port(obj_t) - ref).max()
                                        / scale)}}


def lockstep(args) -> dict:
    """Phase B of the control arm in both packages, step by step, from one
    bridged state on the same batches and the same dropout masks.

    JAX's detector and BoxPC are drawn as its driver draws them and
    bridged into the port's; every step takes one strong and one weak
    batch of the host dataset (the same numpy arrays for both) and JAX's
    own seg-head dropout masks (read from its intermediates at the step's
    key) in place of the port's draws. A witness runs the port a second
    time from the bridged weights moved by a few ulps, with the same
    batches and masks: how far it parts from the port is how far
    rounding alone carries two runs of one function. Writes each step's
    losses and, every `--ls_every` steps, the weights' relative L2 gap."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    jax.config.update("jax_platforms", "cpu")
    from transferable3d_tpu.models import boxpc as jboxpc
    from transferable3d_tpu.models import registry as jreg
    from transferable3d_tpu.train import schedules as jsched
    from transferable3d_tpu.train import semisup as jsemi
    from transferable3d_tpu.train import train_loop as jloop
    from transferable3d_tpu.train import train_semisup as jts
    from transferable3d_torch.models import boxpc as tboxpc
    from transferable3d_torch.models import layers as tlayers
    from transferable3d_torch.train import semisup as tsemi
    from transferable3d_torch.train import train_loop as tloop
    from transferable3d_torch.train import train_semisup as tts
    from transferable3d_torch.train import train_sup as tsup
    from transferable3d_torch.utils import bridge

    torch.set_num_threads(args.threads)
    kw = study_kwargs(args.seed, tempfile.mkdtemp(prefix="lockstep_"),
                      1, 1)
    kw.update(num_point=args.ls_points, batch_size=args.ls_batch,
              compute_dtype=args.ls_dtype, device_data=False)
    jcfg, tcfg = jts.SemisupConfig(**kw), tts.SemisupConfig(**kw)
    bins = jcfg.bin_config()
    strong_ds, weak_ds, _ = jts.build_semisup_datasets(jcfg)
    dtype = jnp.bfloat16 if jcfg.compute_dtype == "bfloat16" else jnp.float32
    b = jcfg.batch_size

    # JAX's start, as its driver draws it
    detector = jreg.get_model(jcfg.model, bins, dtype=dtype)
    lr = jsched.exponential_staircase_lr(
        jcfg.learning_rate, jcfg.lr_decay_rate, jcfg.lr_decay_samples, b,
        jcfg.min_lr)
    bn = jsched.bn_momentum_schedule(
        jcfg.bn_init_decay, jcfg.bn_decay_rate, jcfg.bn_decay_samples, b,
        jcfg.bn_decay_clip)
    tx = jloop.make_optimizer(lr)
    sample = strong_ds.get_batch(list(range(b)))
    det0 = jloop.create_train_state(detector, bins, tx, sample,
                                    seed=jcfg.seed)
    bp_model = jboxpc.BoxPCFitNet(cfg=bins)
    bp0 = jsemi.create_boxpc_state(bp_model, bins, tx, sample,
                                   seed=jcfg.seed)
    weights = dict(fit=jcfg.weak_fit, refine=jcfg.weak_refine,
                   reprojection=jcfg.weak_reproj,
                   size_prior=jcfg.weak_size_prior,
                   size_cls=jcfg.weak_size_cls,
                   trust_gate=jcfg.weak_trust_gate)
    step_kw = dict(weak_weight=jcfg.weak_weight,
                   weak_warmup_steps=jcfg.weak_warmup_steps,
                   diag_classes=bins.num_classes)
    jstep = jsemi.make_semisup_train_step(
        detector, bp_model, bins, tx, lr, bn,
        weights=jsemi.WeakLossWeights(**weights), **step_kw)
    params0 = _numpy_tree(det0.params)
    stats0 = _numpy_tree(det0.batch_stats)
    jstate = jsemi.SemisupState(detector=det0, boxpc_params=bp0.params,
                                boxpc_batch_stats=bp0.batch_stats)

    @jax.jit
    def keep_masks(params, stats, strong, weak, rng, m):
        """The seg head's keep masks of the step's strong and weak
        passes: kept where dropout's output is not 0 or its input is."""
        r_s, r_w = jax.random.split(rng)

        def run(stats, batch, r):
            ep, upd = detector.apply(
                {"params": params, "batch_stats": stats}, batch["points"],
                batch["one_hot"], train=True, bn_momentum=m,
                rngs={"dropout": r},
                mutable=["batch_stats", "intermediates"],
                capture_intermediates=lambda mdl, _: mdl.name in (
                    "dp", "head_mlp"))
            seg = upd["intermediates"]["seg_net"]
            out = seg["dp"]["__call__"][0]
            inp = seg["head_mlp"]["__call__"][0]
            return (out != 0) | (inp == 0), upd["batch_stats"], ep["mask"]

        keep_s, st, mask = run(stats, strong, r_s)
        keep_w, _, _ = run(st, weak, r_w)
        return keep_s, keep_w, mask

    # the port from the same weights, and the witness a few ulps away
    tlr, tbn = tsup.build_schedules(tcfg)
    rng = np.random.RandomState(args.seed)

    def port_state(nudge: bool):
        det = tsup.build_model(tcfg, sample["points"].shape[-1], "cpu")
        p = params0
        if nudge:
            p = jax.tree_util.tree_map(
                lambda x: (x * (1 + 4 * np.finfo(np.float32).eps
                                * rng.choice([-1, 1], x.shape))
                           ).astype(x.dtype), params0)
        bridge.load_flax_variables(det, p, stats0)
        bp = tboxpc.BoxPCFitNet(bins, device="cpu")
        bridge.load_flax_variables(bp, _numpy_tree(bp0.params),
                                   _numpy_tree(bp0.batch_stats))
        return tsemi.SemisupState(
            detector=tloop.create_train_state(
                det, tloop.make_optimizer(tlr), seed=tcfg.seed,
                generator=torch.Generator()), boxpc=bp)

    tstates = {"port": port_state(False), "witness": port_state(True)}
    seen = []  # each pass's seg mask (object points), strong pass first
    for st in tstates.values():
        st.detector.model.register_forward_hook(
            lambda mod, a, o: seen.append(o["mask"].detach().numpy()))
    tstep = tsemi.make_semisup_train_step(
        bins, tlr, tbn, weights=tsemi.WeakLossWeights(**weights),
        **step_kw)
    masks = []
    real_mask = tlayers.dropout_keep_mask
    tlayers.dropout_keep_mask = lambda shape, rate, gen: masks.pop(0)

    keys = KEYS + ("total_loss",)
    out = {"config": {k: kw[k] for k in (
        "model", "num_point", "batch_size", "compute_dtype", "seed",
        "weak_weight")}, "steps": [],
        "losses": {s: {k: [] for k in keys}
                   for s in ("jax", "port", "witness")},
        "weights_gap": {"every": args.ls_every, "port_vs_jax": [],
                        "witness_vs_port": []},
        "seg_mask_points_differing": {"port_vs_jax": [],
                                      "witness_vs_port": []}}
    order = np.random.RandomState(args.seed)
    t0 = time.time()
    first = None
    try:
        for step in range(args.ls_steps):
            strong = strong_ds.get_batch(
                list(order.choice(len(strong_ds), b, replace=False)))
            weak = weak_ds.get_batch(
                list(order.choice(len(weak_ds), b, replace=False)))
            det = jstate.detector
            keep_s, keep_w, jmask = keep_masks(
                det.params, det.batch_stats, strong, weak,
                jax.random.fold_in(det.rng, det.step), bn(det.step))
            keep_s, keep_w = (torch.from_numpy(np.asarray(x))
                              for x in (keep_s, keep_w))
            if first is None:
                first = box_net_split(
                    detector, det.params, det.batch_stats,
                    tstates["port"].detector.model, strong, keep_s,
                    float(bn(det.step)),
                    jax.random.split(jax.random.fold_in(det.rng,
                                                        det.step))[0])
                out["first_forward"] = first
                print("first forward:", json.dumps(first), flush=True)
            jstate, jm = jstep(jstate, strong, weak)
            res = {"jax": {k: float(jm[k]) for k in keys}}
            tmask = {}
            for name in ("port", "witness"):
                masks[:] = [keep_s, keep_w]
                seen.clear()
                tstates[name], tm = tstep(tstates[name], strong, weak)
                res[name] = {k: float(tm[k]) for k in keys}
                tmask[name] = seen[0]
            out["seg_mask_points_differing"]["port_vs_jax"].append(
                int((tmask["port"] != np.asarray(jmask)).sum()))
            out["seg_mask_points_differing"]["witness_vs_port"].append(
                int((tmask["witness"] != tmask["port"]).sum()))
            out["steps"].append(step + 1)
            for src, vals in res.items():
                for k in keys:
                    out["losses"][src][k].append(vals[k])
            if (step + 1) % args.ls_every == 0 or step == 0:
                jp = _leaves(_numpy_tree(jstate.detector.params))
                tp = {n: _leaves(bridge.state_dict_to_flax(
                    tstates[n].detector.model)[0])
                      for n in ("port", "witness")}
                out["weights_gap"]["port_vs_jax"].append(
                    (step + 1, _rel_gap(jp, tp["port"])))
                out["weights_gap"]["witness_vs_port"].append(
                    (step + 1, _rel_gap(tp["port"], tp["witness"])))
                print(f"step {step + 1} ({time.time() - t0:.0f} s): "
                      + "  ".join(
                          f"{k[:-5]} jax {res['jax'][k]:.4f} port "
                          f"{res['port'][k]:.4f} witness "
                          f"{res['witness'][k]:.4f}" for k in BOX_KEYS)
                      + f"; seg mask points differing port-jax "
                      f"{out['seg_mask_points_differing']['port_vs_jax'][-1]}"
                      f", witness-port "
                      f"{out['seg_mask_points_differing']['witness_vs_port'][-1]}"
                      + f"; weights gap port-jax "
                      f"{out['weights_gap']['port_vs_jax'][-1][1]:.3g}, "
                      f"witness-port "
                      f"{out['weights_gap']['witness_vs_port'][-1][1]:.3g}",
                      flush=True)
    finally:
        tlayers.dropout_keep_mask = real_mask

    def first_parting(a, b_, tol):
        for i, (x, y) in enumerate(zip(a, b_)):
            if abs(x - y) > tol * max(abs(x), 1e-30):
                return out["steps"][i]
        return None

    band = 3e-4  # test_semisup_step_v1_f32_equal_jax's rtol on the losses
    out["first_step_beyond_band"] = {
        "band": band,
        "port_vs_jax": {k: first_parting(out["losses"]["jax"][k],
                                         out["losses"]["port"][k], band)
                        for k in keys},
        "witness_vs_port": {k: first_parting(out["losses"]["port"][k],
                                             out["losses"]["witness"][k],
                                             band) for k in keys}}
    print(json.dumps(out["first_step_beyond_band"], indent=1))
    return out


def _range(xs):
    return [min(xs), max(xs)] if xs else None


SOURCES = {
    "jax_cpu": "transferable3d_tpu train_semisup.train on the CPU (this "
               "script)",
    "torch_cpu": "transferable3d_torch train_semisup.train(device='cpu') "
                 "(this script)",
    "jax_tpu": "artifacts/study6_control_s<seed>_metrics.csv",
    "torch_h100": "chiprun_out/pr12_study/control_s<seed>/metrics_train.csv",
}


def source_csv(src: str, out_dir: str, seed: int) -> str:
    if src in ("jax_cpu", "torch_cpu"):
        return os.path.join(run_dir(out_dir, src.split("_")[0], seed),
                            "metrics_train.csv")
    return os.path.join(ROOT, SOURCES[src].replace("<seed>", str(seed)))


def collect(args, seeds) -> dict:
    """The losses of the first `args.epochs` logged epochs (an epoch is
    25 or 26 steps, as the seed's strong split gives) of every source and
    seed, their ranges and means over seeds, and the case at epoch 2."""
    per_seed = {}
    for src in SOURCES:
        per_seed[src] = {}
        for s in seeds:
            path = source_csv(src, args.out_dir, s)
            if os.path.exists(path):
                rows = sorted(read_csv(path).items())[:args.epochs]
                per_seed[src][str(s)] = [dict(step=t, **v) for t, v in rows]

    def over_seeds(src, epoch, key):
        return [rows[epoch][key] for rows in per_seed[src].values()
                if len(rows) > epoch]

    epochs = range(args.epochs)
    ranges = {src: [{k: _range(over_seeds(src, e, k)) for k in KEYS}
                    for e in epochs] for src in SOURCES}
    mean = {src: [{k: (sum(v) / len(v) if (v := over_seeds(src, e, k))
                       else None) for k in KEYS} for e in epochs]
            for src in SOURCES}

    def inside(x, rng):
        return rng is not None and rng[0] <= x <= rng[1]

    check = os.path.join(args.out_dir, "phase_a_check", "phase_a_check.json")
    phase_a = None
    if os.path.exists(check):
        with open(check) as f:
            phase_a = json.load(f)

    # Each box loss at each epoch: where JAX on the CPU's seeds lie
    # against the port's range (its CPU and card seeds together) and JAX
    # on the TPU's.
    cells = []
    for key in BOX_KEYS:
        for e in epochs:
            jax_cpu = over_seeds("jax_cpu", e, key)
            port_rng = _range(over_seeds("torch_cpu", e, key)
                              + over_seeds("torch_h100", e, key))
            tpu_rng = ranges["jax_tpu"][e][key]
            if not jax_cpu or port_rng is None or tpu_rng is None:
                continue
            sides = {{(True, True): "both", (True, False): "port",
                      (False, True): "tpu", (False, False): "neither"}[
                          (inside(x, port_rng), inside(x, tpu_rng))]
                     for x in jax_cpu}
            cells.append({"key": key, "epoch": e + 1, "jax_cpu": jax_cpu,
                          "port_range": port_rng, "jax_tpu_range": tpu_rng,
                          "jax_cpu_in": sorted(sides)})
    if cells and all(c["jax_cpu_in"] == ["port"] for c in cells):
        case = "a"
    elif cells and all(c["jax_cpu_in"] == ["tpu"] for c in cells):
        case = "b"
    else:
        case = "c"
    return {
        "what": "control arm of the transfer study at study6's widths "
                "(v2 bf16, N=512, B=64, C=4, 4,096 / 1,024 hard synthetic "
                "frustums, warmup 2,000, weak_weight 0), the losses each "
                "driver logs at the end of each of the first epochs of "
                "phase B",
        "seeds": seeds, "epochs": args.epochs, "keys": list(KEYS),
        "sources": SOURCES, "per_seed": per_seed, "range": ranges,
        "mean": mean, "phase_a_check": phase_a,
        "decision": {"cells": cells, "case": case},
    }


def print_table(res: dict) -> None:
    for key in res["keys"]:
        print(f"\n{key}: range over seeds {res['seeds']}, by epoch")
        print("epoch " + "  ".join(f"{s:>15s}" for s in res["range"]))
        for e in range(res["epochs"]):
            cells = []
            for src in res["range"]:
                rng = res["range"][src][e][key]
                cells.append(f"{rng[0]:.3f}-{rng[1]:.3f}" if rng else "-")
            print(f"{e + 1:5d} " + "  ".join(f"{c:>15s}" for c in cells))
    print("\nJAX on the CPU against the port's range and JAX on the "
          "TPU's:")
    for c in res["decision"]["cells"]:
        print(f"  {c['key']}, epoch {c['epoch']}: "
              f"{', '.join(c['jax_cpu_in'])}")
    print(f"case: {res['decision']['case']}")


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--seeds", default="0,1,2")
    p.add_argument("--packages", default=",".join(PACKAGES),
                   help="whose runs to make (the JSON reads every run "
                        "found under --out_dir)")
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--boxpc_epochs", type=int, default=1)
    p.add_argument("--jobs", type=int, default=4,
                   help="runs at a time (each a process)")
    p.add_argument("--threads", type=int, default=2,
                   help="CPUs a run (jobs x threads CPUs in all)")
    p.add_argument("--timeout", type=int, default=14400,
                   help="seconds a run may take")
    p.add_argument("--out_dir", default=os.path.join(
        tempfile.gettempdir(), "torch_vs_jax_semisup"))
    p.add_argument("--out_json", default="torch_vs_jax_semisup.json")
    p.add_argument("--lockstep", action="store_true",
                   help="both packages step by step from one bridged "
                        "state on the same batches and dropout masks")
    p.add_argument("--ls_steps", type=int, default=100)
    p.add_argument("--ls_points", type=int, default=256)
    p.add_argument("--ls_batch", type=int, default=32)
    p.add_argument("--ls_dtype", default="float32",
                   choices=("float32", "bfloat16"))
    p.add_argument("--ls_every", type=int, default=10,
                   help="steps between two reads of the weights' gap")
    p.add_argument("--collect", action="store_true",
                   help="write the JSON from the runs already made")
    p.add_argument("--check_phase_a", action="store_true",
                   help="check that phase A's length does not change "
                        "phase B with weak_weight = 0")
    # one run (a child process)
    p.add_argument("--run", choices=PACKAGES)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log_dir")
    p.add_argument("--max_steps", type=int, default=0)
    return p


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    if args.run:
        kw = study_kwargs(args.seed, args.log_dir, args.epochs,
                          args.boxpc_epochs, args.max_steps)
        if args.run == "jax":
            run_jax(kw)
        else:
            run_torch(kw, args.threads)
        return
    if args.check_phase_a:
        print(json.dumps(check_phase_a(args), indent=1))
        return
    if args.lockstep:
        res = lockstep(args)
        with open(args.out_json, "w") as f:
            json.dump(res, f, indent=1)
        return
    seeds = [int(s) for s in args.seeds.split(",")]
    if not args.collect:
        run_all(args, [
            (p, s, run_dir(args.out_dir, p, s), args.epochs,
             args.boxpc_epochs, 0)
            for p in args.packages.split(",") for s in seeds
            if not finished(os.path.join(run_dir(args.out_dir, p, s),
                                         "metrics_train.csv"), args.epochs)])
    res = collect(args, seeds)
    with open(args.out_json, "w") as f:
        json.dump(res, f, indent=1)
    print_table(res)


if __name__ == "__main__":
    main()
