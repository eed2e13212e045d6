"""Time the forward kernels K1 (farthest-point sampling), K2 (inference),
K5 (the training extraction) and K6/K7 (the training forward step), and
the unfused path's extraction K3 and its backward K4, alone on the card,
on a step's own tensors.

K1's and K2's arguments are captured from one `make_predict_step` call of
chip_smoke.py's serving configuration (F-PointNet v2 in bf16, B = 128
frustums of N = 1024 points, seeded weights with perturbed BN statistics,
half the points masked), so K2's balls have the step's distribution of
members (`eff`): a ball's K slots repeat its members, and the kernel runs
the chain on the members only. K5's, K6's and K7's arguments are captured
from one fused `make_train_step` call on chip_smoke.py's `v2_train`
batch, so K5 meets the step's balls and K6/K7's rows repeat as a ball's
slots do; K3's and K4's from one unfused step (`T3D_FUSED_SA=0`) on the
same batch, so K4 sums the cotangent of a step's repeated slots. Each
launch is timed with CUDA events through its wrapper (`--iters` launches
after two warm-up ones; K3 and K4 also by the profiler: the device time
of every kernel and memset the wrapper launches, over `--iters` calls)
and printed beside its bound (the least time the card could take: K1's
f32 operations, about 10 a point and pick, at 67 TFLOP/s, with its
dependent steps and the time a step beside it; K2's products over the
eff rows at 989 TFLOP/s; K3's, K4's, K5's and K6/K7's bytes at 3.35
TB/s, each input read once and each output written once) and the plan
the launcher chose; the last lines are the sums over one step's launches
of each kernel (K1: 4, the others 8). `--kernels K3,K4` times only those
(and runs only the steps they need).

With `--phases` the kernels are built with their phase clocks
(`T3D_KERNEL_CLOCKS=1`, a library of its own name) and under each line
stands where the first warp of block 0 (K2: per centroid: the ball query,
z1 and h_0, the inner layers, the last layer with the max, the pooled
row; K5: per centroid: the ball query, the rows with their sums, and the
block's sums once) or thread 0 of block 0 (K6/K7: per tile: the ring's
wait, the products with their epilogue, the way out) spent its cycles.

`--root PATH` imports the port (and chip_smoke.py) from another checkout,
so that two trees are timed on one card in one call; `--phases` needs a
tree whose kernels have the clocks.

    python3 scripts/torch_time_sa_fwd.py [--root PATH] [--iters 10] [--phases]
                                         [--kernels K1,K2,K3,K4,K5,K6,K7]

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

PEAK_BYTES, PEAK_BF16, PEAK_F32 = 3.35e12, 989e12, 67e12


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


def _device_ms(fn, iters):
    """Device time of one call of fn by the profiler: every kernel and
    memset it launches, over `iters` calls after one warm-up call; and
    the names of those kernels with their launches a call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]

    def own_ms(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0)) / 1e3 / iters

    kinds = ", ".join(
        f"{e.key.replace('(anonymous namespace)::', '').split('(')[0]} "
        f"x{e.count / iters:g} {own_ms(e):.4f}" for e in rows)
    return sum(own_ms(e) for e in rows), kinds


def _slots_a_point(grouping, cent, xyz, r, k) -> str:
    """How the step's slots fall on the points: K4 sums each point's
    slots in one chain, so the longest chains and the busiest 32-point
    words set its time."""
    idx, _ = grouping._extract_slots(cent, xyz, r, k)
    b, n = xyz.shape[:2]
    hits = torch.zeros(b, -(-n // 32) * 32, device=idx.device)
    hits.scatter_add_(1, idx.reshape(b, -1),
                      torch.ones(idx.reshape(b, -1).shape,
                                 device=idx.device))
    words = hits.view(b, -1, 32).sum(-1)
    none = float((hits[:, :n] == 0).float().mean())
    return (f"slots a point: mean {float(hits[:, :n].mean()):.1f}, max "
            f"{float(hits.max()):.0f}, none {none:.2f}; a word: mean "
            f"{float(words.mean()):.0f}, max {float(words.max()):.0f}")


def _plan(mod, name, *a):
    """The launcher's plan, where the imported tree has one."""
    fn = getattr(mod, name, None)
    return fn(*a) if fn else "no plan"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=None,
                    help="checkout to import the port from")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", action="store_true",
                    help="build with the phase clocks and print them")
    ap.add_argument("--kernels", default="K1,K2,K3,K4,K5,K6,K7",
                    help="comma-separated kernels to time")
    args = ap.parse_args()
    want = set(args.kernels.split(","))
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
    from transferable3d_torch.ops import _build, fused_sa, grouping, sampling
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
    calls = {"fps_cuda": [], "sa_infer_cuda": [], "sa_extract_cuda": [],
             "sa_fwd_step_cuda": [], "extract_fwd_cuda": [],
             "extract_bwd_cuda": []}
    mods = {"fps_cuda": sampling, "sa_infer_cuda": fused_sa,
            "sa_extract_cuda": fused_sa, "sa_fwd_step_cuda": fused_sa,
            "extract_fwd_cuda": grouping, "extract_bwd_cuda": grouping}
    orig = {name: getattr(mods[name], name) for name in calls}

    def recorder(name):
        def rec(*a):
            calls[name].append(tuple(x.detach() if torch.is_tensor(x)
                                     else x for x in a))
            return orig[name](*a)
        return rec

    def train_step(fused):
        tmodel = registry.get_model(
            "frustum_pointnets_v2", cfg, dtype=torch.bfloat16, device=dev,
            generator=torch.Generator().manual_seed(args.seed + 1))
        lr = schedules.exponential_staircase_lr(batch_size=nb)
        bn = schedules.bn_momentum_schedule(batch_size=nb)
        state = train_loop.create_train_state(
            tmodel, train_loop.make_optimizer(lr), seed=args.seed)
        with chip_smoke.fused_sa_env(None if fused else "0"):
            train_loop.make_train_step(cfg, lr, bn)(
                state, chip_smoke.train_batch(cfg))

    for name in calls:
        setattr(mods[name], name, recorder(name))
    try:
        if want & {"K1", "K2"}:
            with torch.no_grad():
                train_loop.make_predict_step(model, cfg)(batch)
        if want & {"K1", "K5", "K6", "K7"}:
            train_step(fused=True)
        if want & {"K3", "K4"}:
            train_step(fused=False)
    finally:
        for name in calls:
            setattr(mods[name], name, orig[name])
    torch.cuda.synchronize()
    # the predict step's four FPS calls come first, then the train steps'
    fps_calls = calls["fps_cuda"][:4] if "K1" in want else []
    infer_calls, fwd_calls = calls["sa_infer_cuda"], calls["sa_fwd_step_cuda"]
    lib = _build.library()
    totals = {}

    def report(tag, fn, a, by, fl, clocks, peak=PEAK_BF16):
        ms = chip_smoke._time_ms(lambda: fn(*a), 2, args.iters)
        bound = max(by / PEAK_BYTES, fl / peak) * 1e3
        tot = totals.setdefault(tag, [0, 0.0, 0.0])
        tot[0] += 1
        tot[1] += ms
        tot[2] += bound
        return ms, bound, (_phase_cycles(lib, *clocks, lambda: fn(*a))
                           if args.phases and clocks else None)

    for tag, fn, cl in (("K3", grouping.extract_fwd_cuda,
                         calls["extract_fwd_cuda"]),
                        ("K4", grouping.extract_bwd_cuda,
                         calls["extract_bwd_cuda"])):
        if tag not in want:
            continue
        assert len(cl) == 8, (tag, len(cl))
        # the profiler's first run may drop events: warm it up
        _device_ms(lambda: fn(*cl[0]), 1)
        dev_tot = 0.0
        for a in cl:
            cent, xyz, other, r, k = a
            b, s, c = cent.shape[0], cent.shape[1], other.shape[-1]
            # K3: payload in, rows and counts out; K4: rows in, dpay out
            by = chip_smoke._nbytes(cent, xyz, other) + (
                b * s * k * c * 2 + b * s * 4 if tag == "K3"
                else b * xyz.shape[1] * c * 2)
            ms, bound, _ = report(tag, fn, a, by, 0.0, None)
            dms, kinds = _device_ms(lambda: fn(*a), args.iters)
            dev_tot += dms
            cnt = (grouping.direct_sqdist(cent, xyz)
                   <= grouping.radius_sq(r)).sum(-1)
            print(f"{tag} S={s} N={xyz.shape[1]} K={k} C={c}: {ms:.4f} ms "
                  f"through its wrapper, {dms:.4f} ms on the card by the "
                  f"profiler ({kinds}), {by / 1e6:.1f} MB, eff "
                  f"{float(cnt.clamp(1, k).float().mean()):.1f} of {k}, "
                  f"bound {bound:.4f} ms, {ms / bound:.2f} x bound; "
                  f"{_slots_a_point(grouping, cent, xyz, r, k)} ({card})",
                  flush=True)
            if args.phases and tag == "K4":
                print(_phase_cycles(lib, "t3d_extract_bwd_clocks", (
                    "words and transposes", "warp 0's stream"),
                    lambda: fn(*a)).replace("units", "blocks"), flush=True)
        print(f"{tag} by the profiler per step (8 launches, B={nb}): "
              f"{dev_tot:.4f} ms ({card})", flush=True)

    steps = 0
    for a in fps_calls:
        xyz, k = a
        b, n, _ = xyz.shape
        ms, bound, _ = report("K1", sampling.fps_cuda, a,
                              xyz.numel() * 4 + b * k * 4, 10.0 * b * n * k,
                              None, PEAK_F32)
        steps += k - 1
        print(f"K1 [{b},{n}]->{k}: {ms:.4f} ms, {k - 1} dependent steps, "
              f"{ms * 1e6 / (k - 1):.0f} ns a step, bound {bound:.4f} ms; "
              f"{_plan(sampling, 'fps_plan', n)} ({card})", flush=True)
    for a in calls["sa_extract_cuda"] if "K5" in want else []:
        cent, xyz, pf, qc, r, k = a
        cnt = (fused_sa.direct_sqdist(cent, xyz)
               <= fused_sa.radius_sq(r)).sum(-1)
        rows = cent.shape[0] * cent.shape[1] * k
        by = chip_smoke._nbytes(cent, xyz, pf, qc) + rows * pf.shape[-1] * 2
        ms, bound, ph = report(
            "K5", fused_sa.sa_extract_cuda, a, by, 0.0,
            ("t3d_sa_extract_clocks", ("ball query", "rows and sums",
                                       "block sums")))
        print(f"K5 S={cent.shape[1]} N={xyz.shape[1]} K={k} "
              f"F0={pf.shape[-1]}: {ms:.4f} ms, {by / 1e6:.1f} MB, eff "
              f"{float(cnt.clamp(1, k).float().mean()):.1f} of {k}, bound "
              f"{bound:.4f} ms, {by / ms / 1e6:.0f} GB/s, {ms / bound:.2f} x "
              f"bound; {_plan(fused_sa, 'sa_extract_plan', k, pf.shape[-1])}"
              f" ({card})", flush=True)
        if ph:
            print(ph, flush=True)
    for a in infer_calls if "K2" in want else []:
        cent, xyz, pf, qc, r, k, packs, ws, bs = a
        cnt = (fused_sa.direct_sqdist(cent, xyz)
               <= fused_sa.radius_sq(r)).sum(-1)
        rows = float(cnt.clamp(1, k).sum())
        by = (chip_smoke._nbytes(cent, xyz, pf, qc, *packs, *ws, *bs)
              + cent.shape[0] * cent.shape[1] * packs[-1].shape[-1] * 2)
        fl = 2.0 * rows * sum(w.numel() for w in ws)
        dims = tuple(p.shape[-1] for p in packs)
        ms, bound, ph = report(
            "K2", fused_sa.sa_infer_cuda, a, by, fl,
            ("t3d_sa_infer_clocks", ("ball query", "z1 and h_0",
                                     "inner layers", "last layer",
                                     "pooled row")))
        print(f"K2 S={cent.shape[1]} N={xyz.shape[1]} K={k} F={list(dims)}: "
              f"{ms:.4f} ms, eff rows {rows / cnt.numel():.1f} of {k}, "
              f"bound {bound:.4f} ms, {ms / bound:.1f} x bound; "
              f"{_plan(fused_sa, 'sa_infer_plan', k, dims)} ({card})",
              flush=True)
        if ph:
            print(ph, flush=True)
    for a in fwd_calls:
        z, pack, w, b, last = a
        if ("K7" if last else "K6") not in want:
            continue
        rows = z.numel() // z.shape[-1]
        by = (chip_smoke._nbytes(z, pack, w, b) + rows * w.shape[-1] * 2
              + (2 * z.shape[0] * z.shape[1] * w.shape[-1] * 4 if last else 0))
        tag = "K7" if last else "K6"
        ms, bound, ph = report(
            tag, fused_sa.sa_fwd_step_cuda, a, by, 2.0 * rows * w.numel(),
            ("t3d_sa_fwd_clocks", ("wait", "products", "way out")))
        shape = f"S={z.shape[1]} K={z.shape[2]} F={z.shape[-1]}->{w.shape[-1]}"
        plan = _plan(fused_sa, "sa_fwd_plan", z.shape[2], z.shape[-1],
                     w.shape[-1], last)
        print(f"{tag} {shape}: {ms:.4f} ms, {by / 1e6:.1f} MB, bound "
              f"{bound:.4f} ms, {by / ms / 1e6:.0f} GB/s, {ms / bound:.2f} x "
              f"bound; {plan} ({card})", flush=True)
        if ph:
            print(ph, flush=True)
    for tag, (count, ms, bound) in totals.items():
        extra = (f", {steps} dependent steps, {ms * 1e6 / steps:.0f} ns a "
                 "step" if tag == "K1" else "")
        print(f"{tag} per step ({count} launches, B={nb}): {ms:.4f} ms, "
              f"bound {bound:.4f} ms, {ms / bound:.2f} x bound{extra} "
              f"({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
