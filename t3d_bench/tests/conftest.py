"""The benchmark's tests: on the CPU at tiny sizes; those marked `cuda`
need the card and skip without one (the decision is made in the
`cuda_device` fixture, never at import)."""

import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def tiny_run(cell: str, *, config=None, traffic=None, dtype=None,
             faults=(), judged="program", trace=False, seed=2 ** 31 + 11,
             **mix):
    """A run of `cell` at a size the CPU holds: its configuration at
    published widths, few small batches, `dtype` overriding the
    configuration's compute type. `config` and `traffic` name a
    configuration and a mix that no cell of BENCHMARK.json pairs (the
    knobs and limits are then `cell`'s)."""
    import torch

    from t3d_bench import bench, cells

    torch.set_num_threads(2)
    spec = bench.load_spec()
    w = bench.workload(spec, cell)
    cfg = dict(bench.config(spec, config or w["config"]))
    if dtype:
        cfg["compute_dtype"] = dtype
    m = dict(bench.traffic(traffic or w["traffic"]))
    m.update({"batch": 4, "records": 16, "npoints": 256, "pool_batches": 2,
              **mix})
    knobs = dict(bench.cell_file(cell))
    knobs.update(sample_range=4, sample_calls=2, trace_steps=2)
    return cells.Run(
        cell=cell, chips=1, seed=seed, seconds=0.5, trace=trace,
        t0_wall=time.time(), cfg=cfg, mix=m, knobs=knobs,
        per_layer=tuple((x["name"], x["unit"]) for x in
                        bench.metrics_of(spec, cell, "per_layer")),
        faults=tuple(faults), judged=judged)
