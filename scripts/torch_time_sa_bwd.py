"""Time the fused set-abstraction backward kernels K8 and K9 on the card.

For each of the eight grouped set-abstraction scales of F-PointNet v2 at
the training batch (B = 128) this launches K8 at the top step (j = 1) and
K9 at step j = 0 on random tensors of the training shapes, and prints the
time per launch (CUDA events), the bytes the launch must move (inputs
read once, outputs written once), that many bytes' time at 3.35 TB/s, and
the tile plan the launcher chose. The last lines are the totals over the
eight scales: one training step's worth of K8 and of K9.

As in a training step, the K rows of a centroid repeat: a ball with `eff`
members fills its K slots with them in turn, so rows k and k + eff are
equal in every layer and the pooled maximum is held by K / eff rows. Here
eff is drawn per centroid, uniform in 1..K (`--no-repeats`: K distinct
random rows, where ties are rare and K8's tie handling has nothing to do).

With `--phases` the kernels are built with their phase clocks, and under
each launch's line stands where block 0 spent its cycles per tile: the
ring's wait, the first pass (h_j, dz and, in K9, Sz and the ball query's
count), the second pass (the pooled rows' dz, the ball query's members),
the two products with dy_j's epilogue, and the way out (K8's stores, K9's
scatter and Sdy). The clocks cost a few hundred cycles a tile.

With `--step` the launches are instead those of one fused v2 bf16
train step at config 2's widths (N=1024, C=6, `--batch` frustums,
default 32, from the driver's own model and device dataset of one seed):
each K8 and K9 launch of the step is captured and timed on its own
arguments, in the step's order. K9's line also gives the bytes of its
member buffer and rank table, which the balls of that step decide.
`--root PATH` imports the port from another checkout (a `git archive`
of another commit), so that two trees are timed in one call.

    python3 scripts/torch_time_sa_bwd.py [--batch 128] [--iters 10]
        [--phases] [--step] [--root PATH]

Needs an NVIDIA GPU; the kernels are built at first use.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
from pathlib import Path

import torch

# name, N, S, radius, K, (F0, F1, F2)
SCALES = [("seg SA1 s1", 1024, 128, 0.2, 32, (32, 32, 64)),
          ("seg SA1 s2", 1024, 128, 0.4, 64, (64, 64, 128)),
          ("seg SA1 s3", 1024, 128, 0.8, 128, (64, 96, 128)),
          ("seg SA2 s1", 128, 32, 0.4, 64, (64, 64, 128)),
          ("seg SA2 s2", 128, 32, 0.8, 64, (128, 128, 256)),
          ("seg SA2 s3", 128, 32, 1.6, 128, (128, 128, 256)),
          ("box SA1", 512, 128, 0.2, 64, (64, 64, 128)),
          ("box SA2", 128, 32, 0.4, 64, (128, 128, 256))]
HBM_BYTES_PER_S = 3.35e12


def _ms(fn, warmup: int, iters: int) -> float:
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _phase_cycles(fn) -> str:
    """Block 0's cycles per tile in each phase of one launch."""
    lib = _build.library()
    lib.t3d_sa_bwd_clocks.argtypes = [ctypes.c_void_p]
    buf = (ctypes.c_ulonglong * 8)()
    _build.check(lib.t3d_sa_bwd_clocks(buf), "t3d_sa_bwd_clocks")
    fn()
    _build.check(lib.t3d_sa_bwd_clocks(buf), "t3d_sa_bwd_clocks")
    tiles = max(1, buf[7])
    names = ("wait", "first pass", "second pass", "products", "way out")
    return (f"    block 0, {tiles} tiles, cycles a tile: " + ", ".join(
        f"{name} {buf[i] // tiles}" for i, name in enumerate(names)))


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def captured_step(batch: int, seed: int):
    """The K8 and K9 launches of one fused v2 bf16 train step at config
    2's widths, as (tag, function, arguments) in the step's order."""
    import dataclasses

    from transferable3d_torch.data import device_dataset
    from transferable3d_torch.ops import fused_sa
    from transferable3d_torch.train import config as config_lib
    from transferable3d_torch.train import train_loop, train_sup

    cfg = dataclasses.replace(
        config_lib.PRESETS["config2_fpointnet_v1_sunrgbd"],
        model="frustum_pointnets_v2", compute_dtype="bfloat16",
        synthetic_train=max(512, batch), synthetic_val=batch,
        batch_size=batch, seed=seed)
    train_sup.f32_numerics()
    train_ds, _ = train_sup.build_datasets(cfg)
    model = train_sup.build_model(cfg, cfg.num_channels, "cuda")
    lr, bn = train_sup.build_schedules(cfg)
    state = train_loop.create_train_state(
        model, train_loop.make_optimizer(lr), seed=seed)
    data = device_dataset.build_device_dataset(
        train_ds.records, cfg.bin_config(), cfg.max_points_device)
    step_batch = next(device_dataset.DeviceEpochIterator(
        data, cfg.bin_config(), cfg.batch_size, cfg.num_point,
        seed=seed).epoch())
    calls = []
    saved = {}
    for tag, name in (("K8", "sa_bwd_step_cuda"), ("K9", "sa_bwd_step0_cuda")):
        fn = saved[name] = getattr(fused_sa, name)

        def wrapped(*a, _fn=fn, _tag=tag):
            calls.append((_tag, _fn, a))
            return _fn(*a)
        setattr(fused_sa, name, wrapped)
    try:
        train_loop.make_train_step(cfg.bin_config(), lr, bn)(state, step_batch)
    finally:
        for name, fn in saved.items():
            setattr(fused_sa, name, fn)
    torch.cuda.synchronize()
    return calls


def time_step(args, card) -> int:
    """Each K8 and K9 launch of one captured train step, timed on its
    own arguments."""
    totals = {"K8": [0.0, 0, 0.0], "K9": [0.0, 0, 0.0]}
    for tag, fn, a in captured_step(args.batch, args.seed):
        ms = _ms(lambda: fn(*a), 2, args.iters)
        z_j, z_j1 = a[2], a[3]
        k, fj, fj1 = z_j.shape[2], z_j.shape[-1], z_j1.shape[-1]
        tensors = [t for t in a if torch.is_tensor(t)]
        tensors += [t for t in a[4] if torch.is_tensor(t)] if a[1] else []
        by = _nbytes(*tensors)
        extra = ""
        if tag == "K8":
            by += z_j.numel() * 2  # dy_j out
        else:
            b, s, n = z_j.shape[0], z_j.shape[1], a[6].shape[1]
            by += (b * n * (2 * fj + 1) + 2 * b * s * fj) * 4
            # a tree from before K9's member buffer has no scratch
            scratch = getattr(fused_sa, "step0_scratch_bytes", None)
            mem = scratch(a[5], a[6], a[11], k, fj) if scratch else 0
            totals[tag][2] += mem
            extra = (f", member buffer and rank table {mem / 1e6:.2f} MB "
                     f"(bound with them "
                     f"{(by + mem) / HBM_BYTES_PER_S * 1e3:.4f} ms)"
                     if mem else "")
        bound = by / HBM_BYTES_PER_S * 1e3
        totals[tag][0] += ms
        totals[tag][1] += by
        print(f"{tag} step K={k} F={fj}<-{fj1} top={a[1]} train={a[0]}: "
              f"{ms:.4f} ms, {by / 1e6:.1f} MB, bound {bound:.4f} ms"
              f"{extra} ({card})", flush=True)
        if args.phases:
            print(_phase_cycles(lambda: fn(*a)), flush=True)
    for tag, (ms, by, mem) in totals.items():
        print(f"{tag} per captured step (B={args.batch}): {ms:.4f} ms, bound "
              f"by bytes {by / HBM_BYTES_PER_S * 1e3:.4f} ms"
              + (f", with the member buffer and rank table "
                 f"{(by + mem) / HBM_BYTES_PER_S * 1e3:.4f} ms" if mem else "")
              + f" ({card})", flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-repeats", action="store_true",
                    help="K distinct random rows a centroid")
    ap.add_argument("--phases", action="store_true",
                    help="build with the phase clocks and print them")
    ap.add_argument("--step", action="store_true",
                    help="time the launches of one captured train step")
    ap.add_argument("--root", default=None,
                    help="import the port from this checkout")
    args = ap.parse_args()
    args.batch = args.batch or (32 if args.step else 128)
    sys.path.insert(0, os.path.abspath(args.root) if args.root
                    else str(Path(__file__).resolve().parent.parent))
    global _build, fused_sa
    from transferable3d_torch.ops import _build, fused_sa
    if args.phases:
        os.environ[_build.CLOCKS_ENV] = "1"
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU (CUDA)", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}; port from {os.path.dirname(fused_sa.__file__)}",
          flush=True)
    if args.step:
        return time_step(args, card)
    g = torch.Generator(device=dev).manual_seed(args.seed)
    bf = torch.bfloat16

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    def pack(f):
        return fused_sa._make_pack(
            torch.rand(f, generator=g, device=dev) + 0.5, randn(f, scale=0.2),
            randn(f, scale=0.1), torch.rand(f, generator=g, device=dev) + 0.5,
            1e-3, randn(f, scale=1e-3), randn(f, scale=1e-3))

    b = args.batch
    totals = {"K8": [0.0, 0.0], "K9": [0.0, 0.0]}
    for name, n, s, r, k, (f0, f1, f2) in SCALES:
        xyz = randn(b, n, 3, scale=0.5)
        cent = xyz[:, :s].contiguous()
        z0, z1, z2 = (randn(b, s, k, f).to(bf) for f in (f0, f1, f2))
        dy1 = randn(b, s, k, f1, scale=1e-2).to(bf)
        if not args.no_repeats:
            eff = torch.randint(1, k + 1, (b, s, 1), generator=g, device=dev)
            slot = (torch.arange(k, device=dev) % eff)[..., None]
            z0, z1, z2, dy1 = (t.gather(2, slot.expand_as(t))
                               for t in (z0, z1, z2, dy1))
        p0, p1, p2 = pack(f0), pack(f1), pack(f2)
        w0, w1 = randn(f0, f1, scale=0.1), randn(f1, f2, scale=0.1)
        zf = z2.float()
        pooled = fused_sa._pool_epilogue(zf.amax(dim=2), zf.amin(dim=2), p2)
        del zf
        dpooled = randn(b, s, f2).to(bf)
        qc = randn(b, s, f0).to(bf)
        a8 = (True, True, z1, z2, (pooled, dpooled), p1, p2, w1)
        a9 = (True, False, z0, z1, dy1, cent, xyz, qc, p0, p1, w0, r)
        by8 = _nbytes(z1, z2, pooled, dpooled, p1, p2, w1) + z1.numel() * 2
        by9 = (_nbytes(z0, z1, dy1, cent, xyz, qc, p0, p1, w0)
               + (b * n * (2 * f0 + 1) + 2 * b * s * f0) * 4)
        for tag, fn, a, by, plan in (
                ("K8", fused_sa.sa_bwd_step_cuda, a8, by8,
                 fused_sa.sa_bwd_plan(k, f1, f2, True)),
                ("K9", fused_sa.sa_bwd_step0_cuda, a9, by9,
                 fused_sa.sa_bwd_plan(k, f0, f1, False))):
            ms = _ms(lambda: fn(*a), 2, args.iters)
            bound = by / HBM_BYTES_PER_S * 1e3
            totals[tag][0] += ms
            totals[tag][1] += bound
            fj, fj1 = a[2].shape[-1], a[3].shape[-1]
            print(f"{tag} {name} S={s} K={k} F={fj}<-{fj1}: {ms:.4f} ms, "
                  f"{by / 1e6:.1f} MB, bound {bound:.4f} ms, "
                  f"{by / ms / 1e6:.0f} GB/s, {ms / bound:.2f} x bound; "
                  f"ct {plan.ct} stages {plan.stages} W in smem "
                  f"{plan.w_smem} smem {plan.smem} ({card})", flush=True)
            if args.phases:
                print(_phase_cycles(lambda: fn(*a)), flush=True)
        del xyz, cent, z0, z1, z2, dy1, pooled, dpooled, a8, a9
        torch.cuda.empty_cache()
    for tag, (ms, bound) in totals.items():
        print(f"{tag} per step (8 launches, B={b}): {ms:.4f} ms, bound by "
              f"bytes {bound:.4f} ms, {ms / bound:.2f} x bound ({card})",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
