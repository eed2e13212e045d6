"""Time kernel K15 (csrc/fetch_select.cu, the depth->frustum pass's
systematic sampler) alone on the card at three shapes, on the arguments
that `lift_depth_frustums` gives it there:

  * e2e 96x128: chip_smoke.py's phase 16, 32 synthetic 96x128 depth maps
    (`make_depth_scene`) with 4 boxes each, 1,024 points: 128 frustums of
    12,288 points;
  * probe 480x640 x 16: chip_smoke.py's phase 17 probe, 4 random 480x640
    depth maps with 4 random boxes each: 16 frustums of 307,200 points;
  * e2e 480x640 x 128: chip_smoke.py's phase 21, 32 synthetic 480x640
    depth maps with 4 boxes each: 128 frustums of 307,200 points.

Each shape prints K15's time through its wrapper (the median of 20
windows of 50 back-to-back calls of `fetch_select_cuda`, each timed with
CUDA events, the host's wrapper included: at 96x128 the host's time a
call sets it, and the host's pace varies within a run), its device time
by the profiler over `--iters` calls, back to back and with the L2 cache
flushed before each call (a 128 MB write: at 480x640 the 39 MB mask
would otherwise stay in the 50 MB L2), the bound (the least time the
card could take: the mask, the phases, the slot order and the rows this
run's frustums take read once, the outputs written once, at 3.35 TB/s;
chip_smoke.py's `k15_cost`), the plain twin's time, the launch plan
where the tree has one, whether the kernel's outputs equal the twin's,
and the host's time a call of the wrapper (`time.perf_counter` over
2,000 calls, which the card keeps up with).

With `--phases` K15 is built with its phase clocks (`T3D_KERNEL_CLOCKS=1`,
a library of its own name) and under each shape stands the mean cycles a
block spends in each phase: the mask's loads into words, the block's
scan, the group's totals (the cluster barrier and the other blocks'
totals), the slots.

`--root PATH` imports the port from another checkout (a `git archive` of
the parent under `_verify/`), so that two trees are timed on one card in
one call (parent, tree, tree, parent).

    python3 scripts/torch_time_fetch.py [--root PATH] [--iters 20] [--phases]

Needs an NVIDIA GPU; the kernels are built at first use. Imports no JAX.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

PEAK_BYTES = 3.35e12
NPOINTS = 1024


def _host_us(fn, iters: int = 2000) -> float:
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    us = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return us


def _kernel_ms(fn, iters: int, flush=None) -> float:
    """The device time of the K15 kernel a call, by the profiler, over
    `iters` calls; `flush` runs before each call and is not counted."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            if flush is not None:
                flush()
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and "fetch_select" in e.key]
    if not rows:
        raise RuntimeError("the profiler recorded no K15 kernel")
    return sum(getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))
               for e in rows) / 1e3 / iters


def _bound_ms(pts, inside, u, npoints) -> float:
    f, m = inside.shape[:2]
    c = pts.shape[-1]
    out = f * m * (npoints * (c + 1) + 1) * 4
    rows = int(inside.sum(-1).clamp(max=npoints).sum())
    nbytes = (inside.numel() + u.numel() * 4 + npoints * 4 + rows * c * 4
              + out)
    return nbytes / PEAK_BYTES * 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=None,
                    help="checkout to import the port from")
    ap.add_argument("--iters", type=int, default=20)
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
    from torch_time_sa_fwd import _phase_cycles
    from transferable3d_torch.core import bins
    from transferable3d_torch.data import depth_pipeline, frustum_jit
    from transferable3d_torch.ops import _build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; port from {root}", flush=True)
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(args.seed + 5)

    calls = []
    orig = frustum_jit.fetch_select_cuda

    def rec(*a):
        calls.append(a)
        return orig(*a)

    def captured(depth, k, boxes):
        del calls[:]
        frustum_jit.fetch_select_cuda = rec
        try:
            frustum_jit.lift_depth_frustums(depth, k, boxes, NPOINTS, gen,
                                            device=dev)
        finally:
            frustum_jit.fetch_select_cuda = orig
        assert len(calls) == 1, len(calls)
        return calls[0]

    def scene(seed, h, w):
        s, _ = depth_pipeline.make_depth_scene(
            np.random.RandomState(seed), bins.SUNRGBD, n_frames=32,
            boxes_per_frame=4, h=h, w=w)
        return captured(s.depth, s.K, s.boxes2d)

    rng = np.random.RandomState(args.seed + 6)
    k_big = np.array([[520.0, 0, 320.0], [0, 520.0, 240.0], [0, 0, 1]],
                     np.float32)
    depth = rng.uniform(0.5, 8.0, (4, 480, 640)).astype(np.float32)
    depth[rng.rand(4, 480, 640) < 0.1] = 0.0
    x0, y0 = rng.uniform(0, 400, (4, 4)), rng.uniform(0, 300, (4, 4))
    boxes = np.stack([x0, y0, x0 + rng.uniform(20, 239.5, (4, 4)),
                      y0 + rng.uniform(20, 179.5, (4, 4))],
                     -1).astype(np.float32)
    shapes = [("e2e 96x128 x 128", scene(args.seed, 96, 128)),
              ("probe 480x640 x 16", captured(depth, k_big, boxes)),
              ("e2e 480x640 x 128", scene(args.seed + 8, 480, 640))]
    scratch = torch.empty(128 * 2**20, dtype=torch.uint8, device=dev)
    plan_fn = getattr(frustum_jit, "fetch_select_plan", None)
    for tag, a in shapes:
        pts, inside, u, npoints = a
        got = frustum_jit.fetch_select_cuda(*a)
        ref = frustum_jit.fetch_select_plain(*a)
        same = all(torch.equal(g, r) for g, r in zip(got, ref))
        wrapper = float(np.median([chip_smoke._time_ms(
            lambda: frustum_jit.fetch_select_cuda(*a), 3, 50)
            for _ in range(20)]))
        warm = _kernel_ms(lambda: frustum_jit.fetch_select_cuda(*a),
                          args.iters)
        cold = _kernel_ms(lambda: frustum_jit.fetch_select_cuda(*a),
                          args.iters, flush=lambda: scratch.fill_(1))
        host = _host_us(lambda: frustum_jit.fetch_select_cuda(*a))
        plain = chip_smoke._time_ms(
            lambda: frustum_jit.fetch_select_plain(*a), 3, 5)
        bound = _bound_ms(*a)
        plan = (plan_fn(pts.shape[1], inside.shape[0] * inside.shape[1])
                if plan_fn else "one block a frustum")
        cnt = got[2]
        print(f"K15 {tag}: pts {list(pts.shape)} inside "
              f"{list(inside.shape)}, counts {int(cnt.min())}-"
              f"{int(cnt.max())}; {wrapper:.4f} ms through its wrapper "
              f"(the host's {host:.2f} us a call), "
              f"{warm:.4f} ms by the profiler back to back, {cold:.4f} ms "
              f"by the profiler with the L2 flushed; bound {bound:.4f} ms "
              f"(bytes), {cold / bound:.1f} x bound cold; plain "
              f"{plain:.4f} ms; identical to the twin {same}; plan {plan} "
              f"({card})", flush=True)
        if args.phases:
            print(_phase_cycles(_build.library(), "t3d_fetch_select_clocks", (
                "loads", "scan", "group totals", "slots"),
                lambda: frustum_jit.fetch_select_cuda(*a)).replace(
                    "units", "blocks"), flush=True)
        if not same:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
