"""Time the forward set-abstraction kernels K2 (inference) and K6/K7 (the
training forward step) alone on the card, on a step's own tensors.

K2's arguments are captured from one `make_predict_step` call of
chip_smoke.py's serving configuration (F-PointNet v2 in bf16, B = 128
frustums of N = 1024 points, seeded weights with perturbed BN statistics,
half the points masked), so its balls have the step's distribution of
members (`eff`): a ball's K slots repeat its members, and the kernel runs
the chain on the members only. K6's and K7's arguments are captured from
one fused `make_train_step` call on chip_smoke.py's `v2_train` batch, so
their rows repeat as a ball's slots do. Each launch is timed with CUDA
events (`--iters` launches after two warm-up ones) and printed beside its
bound (the least time the card could take: K2's products over the eff
rows at 989 TFLOP/s, or K6/K7's bytes at 3.35 TB/s, each input read once
and each output written once) and the plan the launcher chose; the last
lines are the sums over one step's eight launches of each kernel.

With `--phases` the kernels are built with their phase clocks
(`T3D_KERNEL_CLOCKS=1`, a library of its own name) and under each line
stands where the first warp of block 0 (K2: per centroid: the ball query,
z1 and h_0, the inner layers, the last layer with the max, the pooled
row) or thread 0 of block 0 (K6/K7: per tile: the ring's wait, the
products with their epilogue, the way out) spent its cycles.

`--root PATH` imports the port (and chip_smoke.py) from another checkout,
so that two trees are timed on one card in one call; `--phases` needs a
tree whose kernels have the clocks.

    python3 scripts/torch_time_sa_fwd.py [--root PATH] [--iters 10] [--phases]

Needs an NVIDIA GPU; the kernels are built at first use. Imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
from pathlib import Path

import torch

PEAK_BYTES, PEAK_BF16 = 3.35e12, 989e12


def _phase_cycles(lib, fn_name, names, fn) -> str:
    """The phase clocks of one launch, per unit they count."""
    get = getattr(lib, fn_name)
    get.argtypes = [ctypes.c_void_p]
    buf = (ctypes.c_ulonglong * 8)()
    for _ in range(2):  # clear, then one launch
        if get(buf) != 0:
            raise RuntimeError(f"{fn_name} failed")
        if _ == 0:
            fn()
    units = max(1, buf[7])
    return (f"    {units} units, cycles a unit: " + ", ".join(
        f"{name} {buf[i] // units}" for i, name in enumerate(names)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=None,
                    help="checkout to import the port from")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", action="store_true",
                    help="build with the phase clocks and print them")
    args = ap.parse_args()
    root = Path(args.root or Path(__file__).resolve().parent.parent).resolve()
    sys.path.insert(0, str(root))
    if args.phases:
        os.environ["T3D_KERNEL_CLOCKS"] = "1"
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU (CUDA)", file=sys.stderr)
        return 1
    import chip_smoke
    from transferable3d_torch.core import bins
    from transferable3d_torch.models import registry
    from transferable3d_torch.ops import _build, fused_sa
    from transferable3d_torch.train import schedules, train_loop

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}; port from {root}", flush=True)
    dev = torch.device("cuda:0")
    cfg, nb = bins.SUNRGBD, chip_smoke.B

    # K2's arguments from one predict step (chip_smoke.py's serving set-up)
    gen = torch.Generator().manual_seed(args.seed)
    model = registry.get_model("frustum_pointnets_v2", cfg,
                               dtype=torch.bfloat16, device=dev,
                               generator=gen).eval()
    chip_smoke._perturb_bn(model, gen)
    batch = chip_smoke.SyntheticFrustums(nb, cfg, args.seed).get_batch(
        list(range(nb)))
    with torch.no_grad():
        logits = model.seg_net(torch.as_tensor(batch["points"], device=dev),
                               torch.as_tensor(batch["one_hot"], device=dev))
        logits = logits.float()
        model.seg_net.seg_out.bias[1] -= (logits[..., 1]
                                          - logits[..., 0]).median()
    infer_calls, fwd_calls = [], []
    orig_infer, orig_fwd = fused_sa.sa_infer_cuda, fused_sa.sa_fwd_step_cuda

    def rec_infer(*a):
        infer_calls.append(a)
        return orig_infer(*a)

    def rec_fwd(*a):
        fwd_calls.append(tuple(x.detach() if torch.is_tensor(x) else x
                               for x in a))
        return orig_fwd(*a)

    fused_sa.sa_infer_cuda, fused_sa.sa_fwd_step_cuda = rec_infer, rec_fwd
    try:
        with torch.no_grad():
            train_loop.make_predict_step(model, cfg)(batch)
        tmodel = registry.get_model(
            "frustum_pointnets_v2", cfg, dtype=torch.bfloat16, device=dev,
            generator=torch.Generator().manual_seed(args.seed + 1))
        lr = schedules.exponential_staircase_lr(batch_size=nb)
        bn = schedules.bn_momentum_schedule(batch_size=nb)
        state = train_loop.create_train_state(
            tmodel, train_loop.make_optimizer(lr), seed=args.seed)
        with chip_smoke.fused_sa_env(None):
            train_loop.make_train_step(cfg, lr, bn)(
                state, chip_smoke.train_batch(cfg))
    finally:
        fused_sa.sa_infer_cuda, fused_sa.sa_fwd_step_cuda = (orig_infer,
                                                             orig_fwd)
    torch.cuda.synchronize()
    assert len(infer_calls) == 8 and len(fwd_calls) == 16, (
        len(infer_calls), len(fwd_calls))
    lib = _build.library()
    totals = {}

    def report(tag, fn, a, by, fl, clocks):
        ms = chip_smoke._time_ms(lambda: fn(*a), 2, args.iters)
        bound = max(by / PEAK_BYTES, fl / PEAK_BF16) * 1e3
        tot = totals.setdefault(tag, [0.0, 0.0])
        tot[0] += ms
        tot[1] += bound
        return ms, bound, (_phase_cycles(lib, *clocks, lambda: fn(*a))
                           if args.phases else None)

    for a in infer_calls:
        cent, xyz, pf, qc, r, k, packs, ws, bs = a
        cnt = (fused_sa.direct_sqdist(cent, xyz)
               <= fused_sa.radius_sq(r)).sum(-1)
        rows = float(cnt.clamp(1, k).sum())
        by = (chip_smoke._nbytes(cent, xyz, pf, qc, *packs, *ws, *bs)
              + cent.shape[0] * cent.shape[1] * packs[-1].shape[-1] * 2)
        fl = 2.0 * rows * sum(w.numel() for w in ws)
        dims = tuple(p.shape[-1] for p in packs)
        plan = getattr(fused_sa, "sa_infer_plan", None)
        ms, bound, ph = report(
            "K2", fused_sa.sa_infer_cuda, a, by, fl,
            ("t3d_sa_infer_clocks", ("ball query", "z1 and h_0",
                                     "inner layers", "last layer",
                                     "pooled row")))
        print(f"K2 S={cent.shape[1]} N={xyz.shape[1]} K={k} F={list(dims)}: "
              f"{ms:.4f} ms, eff rows {rows / cnt.numel():.1f} of {k}, "
              f"bound {bound:.4f} ms, {ms / bound:.1f} x bound; "
              f"{plan(k, dims) if plan else 'no plan'} ({card})",
              flush=True)
        if ph:
            print(ph, flush=True)
    for a in fwd_calls:
        z, pack, w, b, last = a
        rows = z.numel() // z.shape[-1]
        by = (chip_smoke._nbytes(z, pack, w, b) + rows * w.shape[-1] * 2
              + (2 * z.shape[0] * z.shape[1] * w.shape[-1] * 4 if last else 0))
        plan = getattr(fused_sa, "sa_fwd_plan", None)
        tag = "K7" if last else "K6"
        ms, bound, ph = report(
            tag, fused_sa.sa_fwd_step_cuda, a, by, 2.0 * rows * w.numel(),
            ("t3d_sa_fwd_clocks", ("wait", "products", "way out")))
        shape = f"S={z.shape[1]} K={z.shape[2]} F={z.shape[-1]}->{w.shape[-1]}"
        print(f"{tag} {shape}: {ms:.4f} ms, {by / 1e6:.1f} MB, bound "
              f"{bound:.4f} ms, {by / ms / 1e6:.0f} GB/s, {ms / bound:.2f} x "
              f"bound; "
              f"{plan(z.shape[2], z.shape[-1], w.shape[-1], last) if plan else 'no plan'}"
              f" ({card})", flush=True)
        if ph:
            print(ph, flush=True)
    for tag, (ms, bound) in totals.items():
        print(f"{tag} per step (8 launches, B={nb}): {ms:.4f} ms, bound "
              f"{bound:.4f} ms, {ms / bound:.2f} x bound ({card})",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
