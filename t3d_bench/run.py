"""Run one cell of the benchmark once and print its result line.

    python3 t3d_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell, its configuration, traffic mix and metrics are named in
BENCHMARK.json at the root of the checkout (t3d_bench/bench.py says how
each is found). The last line on standard output is one JSON object:
`correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end
metrics, or with `--trace 1` its per-layer metrics), `device`, with
`--trace 1` `breakdown`, and last `checks`, each compared number beside
its limit; the same numbers are the last lines on standard error.

Without an NVIDIA GPU, or with fewer than the cell asks for, the run
exits with code 2 and prints no result. It exits with code 3 if a module
of JAX or of the JAX package was loaded.
"""

import time

T0_WALL = time.time()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from t3d_bench import bench

    spec = bench.load_spec()
    errs = bench.check_spec(spec)
    if errs:
        print("BENCHMARK.json: " + "; ".join(errs), file=sys.stderr)
        return 2
    cell = bench.workload(spec, args.workload)

    import torch

    if not torch.cuda.is_available():
        print("no NVIDIA GPU: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} GPUs, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2

    from t3d_bench import cells

    # One process a chip, few host threads: the card's work is queued by
    # one thread, and fewer threads steady the host's pace.
    torch.set_num_threads(2)
    run = cells.Run(
        cell=cell["name"], chips=cell["chips"], seed=args.seed,
        seconds=args.seconds, trace=bool(args.trace), t0_wall=T0_WALL,
        cfg=bench.config(spec, cell["config"]),
        mix=bench.traffic(cell["traffic"]),
        knobs=bench.cell_file(cell["name"]),
        per_layer=tuple((m["name"], m["unit"]) for m in
                        bench.metrics_of(spec, cell["name"], "per_layer")))
    out = cells.run_cell(run)
    forbidden = bench.forbidden_modules()
    if forbidden:
        print(f"loaded modules of JAX or the JAX package: {forbidden}",
              file=sys.stderr)
        return 3
    if out.get("breakdown") is None:
        out.pop("breakdown", None)
    sys.stderr.flush()
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(bench.result_line(out["correct"], out["attempted"], out["failed"],
                            out["metrics"], out["device"], out["checks"],
                            out.get("breakdown")), flush=True)
    return 0


if __name__ == "__main__":
    # The compile caches stay inside the checkout, at fixed paths.
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / ".bench_cache" / "ext")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / ".bench_cache" / "triton")
    os.environ["USE_FLAX"] = "0"
    sys.exit(main())
