"""Does the port's training repeat bit for bit on one card?

    python3 scripts/torch_repro_check.py [--seed 0] [--diagnose]

Runs, in one process on cuda:0, each twice from one seed and compares
the two runs bit for bit after every step:
  * the supervised driver, `train_sup.train` at config 2's widths (v2
    bf16, N=1024, C=6, B=32, 512 train and 128 val synthetic frustums
    resident on the card, 48 steps), as chip_smoke phase 22 runs it:
    every parameter, BN buffer and Adam moment, and each step's loss;
  * the transfer loop, `train_semisup.train` at config 4's widths (v2
    bf16 detector, 640 train and 160 val frustums, 2 BoxPC epochs, 32
    phase-B steps), as chip_smoke phase 25 runs it: the detector's
    parameters, buffers and Adam moments after every phase-B step;
  * every hand kernel of the fused training step (K1, K5-K9), launched
    twice on the arguments one driver step gave it: each output the same
    bits, or the count of elements that differ.
The two runs are chip_smoke's (`run_driver`, `run_transfer`), whose
phase 27 gates what this prints; the script adds the kernels' outputs
and, for a hunt, the diagnosis below.
It prints the first step at which two runs part, if they do.

`--diagnose` also runs the driver and the transfer loop once under
`torch.use_deterministic_algorithms(True, warn_only=True)` and lists
every PyTorch op on their path that has no deterministic CUDA
implementation (hand kernels are not on that list), then runs the driver
twice more in that mode and compares the runs.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import os
import sys
import tempfile
import time
import warnings

import torch


def compare_runs(what, a, b):
    from chip_smoke import first_parting

    first, n_end, gap = first_parting(a, b)
    print(f"{what}: {len(a)} and {len(b)} steps; "
          + ("bit-identical at every step" if first is None else
             f"first parting after step {first + 1}; at the end "
             f"{n_end} of {len(a[-1])} tensors differ, max |diff| {gap:.4g}"),
          flush=True)
    return first is None


_KERNELS = {  # wrapper name in its module -> label
    ("sampling", "fps_cuda"): "K1",
    ("fused_sa", "sa_extract_cuda"): "K5",
    ("fused_sa", "sa_fwd_step_cuda"): "K6/K7",
    ("fused_sa", "sa_bwd_step_cuda"): "K8",
    ("fused_sa", "sa_bwd_step0_cuda"): "K9",
}


def kernels_twice(seed, tmp):
    """Every hand kernel of one fused driver step, twice on the arguments
    the step gave it."""
    from chip_smoke import driver_cfg
    from transferable3d_torch.data import device_dataset
    from transferable3d_torch.ops import fused_sa, sampling
    from transferable3d_torch.train import train_loop, train_sup

    mods = {"fused_sa": fused_sa, "sampling": sampling}
    cfg = driver_cfg(seed, os.path.join(tmp, "kernels"))
    train_ds, _ = train_sup.build_datasets(cfg)
    model = train_sup.build_model(cfg, cfg.num_channels, "cuda")
    lr, bn = train_sup.build_schedules(cfg)
    state = train_loop.create_train_state(
        model, train_loop.make_optimizer(lr), seed=seed)
    data = device_dataset.build_device_dataset(
        train_ds.records, cfg.bin_config(), cfg.max_points_device)
    batch = next(device_dataset.DeviceEpochIterator(
        data, cfg.bin_config(), cfg.batch_size, cfg.num_point,
        seed=seed).epoch())
    calls = collections.defaultdict(list)
    saved = {}
    for (mod, name), label in _KERNELS.items():
        fn = getattr(mods[mod], name)
        saved[(mod, name)] = fn

        def wrapped(*a, _fn=fn, _label=label, **kw):
            calls[_label].append((a, kw))
            return _fn(*a, **kw)
        setattr(mods[mod], name, wrapped)
    try:
        train_loop.make_train_step(cfg.bin_config(), lr, bn)(state, batch)
    finally:
        for (mod, name), fn in saved.items():
            setattr(mods[mod], name, fn)
    torch.cuda.synchronize()
    ok = True
    for (mod, name), label in _KERNELS.items():
        fn = saved[(mod, name)]
        differ, total = [], 0
        for a, kw in calls[label]:
            one, two = fn(*a, **kw), fn(*a, **kw)
            one = one if isinstance(one, (tuple, list)) else (one,)
            two = two if isinstance(two, (tuple, list)) else (two,)
            for i, (x, y) in enumerate(zip(one, two)):
                total += 1
                if not torch.equal(x, y):
                    differ.append(
                        f"output {i} {int((x != y).sum())} of {x.numel()} "
                        f"elements, max |diff| "
                        f"{float((x.float() - y.float()).abs().max()):.3g}")
        ok &= not differ
        print(f"{label} twice on one step's arguments ({len(calls[label])} "
              f"launches, {total} outputs): "
              + ("the same bits" if not differ else "; ".join(differ)),
              flush=True)
    return ok


@contextlib.contextmanager
def deterministic_warnings(found):
    """PyTorch's deterministic mode, warning (not raising) at every op
    that has no deterministic implementation; the warnings' texts are
    counted into `found`."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield
        for w in caught:
            text = str(w.message).split("\n")[0][:200]
            if "deterministic" in text.lower():
                found[text] += 1
    finally:
        torch.use_deterministic_algorithms(False)


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--diagnose", action="store_true")
    args = p.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this check runs on the card")
    import transferable3d_torch

    print(f"port from {os.path.dirname(transferable3d_torch.__file__)}; "
          f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}",
          flush=True)
    t0 = time.time()
    tmp = tempfile.mkdtemp(prefix="t3d_repro_")
    from chip_smoke import run_driver, run_transfer

    ok = kernels_twice(args.seed, tmp)
    ok &= compare_runs("driver, 48 steps, two runs",
                       run_driver(args.seed, tmp, "d1"),
                       run_driver(args.seed, tmp, "d2"))
    ok &= compare_runs("transfer loop, 32 phase-B steps, two runs",
                       run_transfer(args.seed, tmp, "t1"),
                       run_transfer(args.seed, tmp, "t2"))
    if args.diagnose:
        found = collections.Counter()
        with deterministic_warnings(found):
            a = run_driver(args.seed, tmp, "dd1")
            run_transfer(args.seed, tmp, "td1")
        print("ops without a deterministic CUDA implementation "
              f"(warnings, count): {len(found)} kinds", flush=True)
        for text, count in found.most_common():
            print(f"  {count:6d}  {text}", flush=True)
        with deterministic_warnings(collections.Counter()):
            b = run_driver(args.seed, tmp, "dd2")
        compare_runs("driver under torch.use_deterministic_algorithms, "
                     "two runs", a, b)
    print(f"repro check {'passed' if ok else 'FAILED'} in "
          f"{time.time() - t0:.1f} s", flush=True)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
