"""The readings that a cell's correctness limits are set from.

    python3 t3d_bench/readings.py --workload <cell> --seeds 1,2,3 \
        [--judged program|control] [--faults half_batch] [--seconds 2] \
    [--mix '{"depth": [0.5, 1.0]}'] [--dtype float32]

For each seed, in one process: the program's run at the cell's own size
with a short window (or, with `--judged control`, the reference in fp8
put in the program's place; or the program with a fault planted), and
the numbers that the cell compares, one JSON line a seed. The lower
reading of a number is the largest over a dozen seeds or more of the
program; the upper one the smallest of the control's, and for training
of each fault's (PERF.md gives them beside each limit). Runs on the
card; the benchmark's own runs do not run it.
"""

import time

T0_WALL = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--judged", choices=("program", "control"),
                   default="program")
    p.add_argument("--faults", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--mix", default="{}",
                   help="JSON of traffic keys to override (a witness)")
    p.add_argument("--dtype", default="",
                   help="the program's compute type instead of the "
                   "configuration's (a witness)")
    args = p.parse_args()

    import torch

    from t3d_bench import bench, cells

    if not torch.cuda.is_available():
        print("no NVIDIA GPU", file=sys.stderr)
        return 2
    spec = bench.load_spec()
    cell = bench.workload(spec, args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        run = cells.Run(
            cell=cell["name"], chips=cell["chips"], seed=seed,
            seconds=args.seconds, trace=False, t0_wall=time.time(),
            cfg={**bench.config(spec, cell["config"]),
                 **({"compute_dtype": args.dtype} if args.dtype else {})},
            mix={**bench.traffic(cell["traffic"]), **json.loads(args.mix)},
            knobs=bench.cell_file(cell["name"]),
            faults=tuple(f for f in args.faults.split(",") if f),
            judged=args.judged, detail=True)
        out = cells.run_cell(run)
        checks = out.get("numbers", out["checks"])
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "judged": args.judged, "faults": args.faults,
                          "mix": args.mix, "dtype": args.dtype,
                          "checks": checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
