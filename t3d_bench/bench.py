"""The benchmark's specification, its data-driven discovery and its result
line.

`BENCHMARK.json` at the root of the checkout names each cell's
configuration, traffic mix and chips and each metric's cells. Everything
that belongs to one of them is a file of its own, found by its name:

  configs/<config>.json       the configuration as it is run
  traffic/<traffic>.json      a traffic mix (traffic/frustums.py reads it)
  workloads/<cell>.json       the cell's correctness limits and run knobs
  metrics/<metric>.py         a per-layer metric's reader, `read(readings)`;
                              a name with a dot (`mfu_pct.train`) falls
                              back to the reader of the part before its
                              first dot (`metrics/mfu_pct.py`), which
                              then serves each of its modes

so a later change adds a cell, a configuration or a metric by adding
files and entries, without editing a file that exists.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES_E2E = ("host_clock", "device_trace")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
# Top-level module names that no run may load.
FORBIDDEN = ("jax", "jaxlib", "flax", "transferable3d_tpu")


def load_spec(root: Path = ROOT) -> Dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {path}")
    return json.loads(path.read_text())


def _json(path: Path) -> Dict:
    if not path.is_file():
        raise FileNotFoundError(f"no {path}")
    return json.loads(path.read_text())


def workload(spec: Dict, name: str) -> Dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                   f"{[w['name'] for w in spec['workloads']]}")


def config(spec: Dict, name: str) -> Dict:
    for c in spec["configs"]:
        if c["name"] == name:
            return _json(ROOT / c["file"])
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str) -> Dict:
    return _json(HERE / "traffic" / f"{name}.json")


def cell_file(name: str) -> Dict:
    return _json(HERE / "workloads" / f"{name}.json")


def metrics_of(spec: Dict, cell: str, group: str) -> List[Dict]:
    """The `end_to_end` or `per_layer` metrics that `cell` reports: those
    that list it, and those without a list."""
    return [m for m in spec[group]
            if "workloads" not in m or cell in m["workloads"]]


def reader_file(name: str) -> Path:
    """metrics/<name>.py, or else metrics/<the name before its first
    dot>.py; the first of them for a name that has neither."""
    own = HERE / "metrics" / f"{name}.py"
    shared = HERE / "metrics" / f"{name.split('.')[0]}.py"
    return own if own.is_file() or not shared.is_file() else shared


def reader(name: str):
    """The per-layer metric's reader: `read` of its `reader_file`."""
    path = reader_file(name)
    if not path.is_file():
        raise FileNotFoundError(f"no reader {path}")
    spec = importlib.util.spec_from_file_location(
        f"t3d_bench_metric_{re.sub(r'[^A-Za-z0-9_]', '_', name)}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def check_spec(spec: Dict) -> List[str]:
    """What in `spec` breaks the benchmark's naming rules or leaves a
    name without its file; empty when sound."""
    errs = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in spec[group]]
        errs += [f"{group}: duplicate {n}" for n in set(names)
                 if names.count(n) > 1]
        errs += [f"{group}: bad name {n!r}" for n in names
                 if not NAME.match(n)]
    e2e = {m["name"] for m in spec["end_to_end"]}
    cells = {w["name"] for w in spec["workloads"]}
    for m in spec["end_to_end"] + spec["per_layer"]:
        if not UNIT.match(m["unit"]):
            errs.append(f"{m['name']}: bad unit {m['unit']!r}")
        if m["better"] not in ("lower", "higher"):
            errs.append(f"{m['name']}: better is {m['better']!r}")
        if m["source"] not in SOURCES:
            errs.append(f"{m['name']}: source {m['source']!r}")
        errs += [f"{m['name']}: unknown cell {c}"
                 for c in m.get("workloads", ()) if c not in cells]
    for m in spec["end_to_end"]:
        if m["source"] not in SOURCES_E2E:
            errs.append(f"{m['name']}: end-to-end from {m['source']}")
    for m in spec["per_layer"]:
        if m["moves"] not in e2e:
            errs.append(f"{m['name']}: moves unknown {m['moves']}")
        for c in m.get("workloads", sorted(cells)):
            if m["moves"] not in {x["name"] for x in
                                  metrics_of(spec, c, "end_to_end")}:
                errs.append(f"{m['name']}: {c} does not report "
                            f"{m['moves']}")
        if not reader_file(m["name"]).is_file():
            errs.append(f"{m['name']}: no metrics/{m['name']}.py")
    for c in spec["configs"]:
        if not (ROOT / c["file"]).is_file():
            errs.append(f"config {c['name']}: no {c['file']}")
    for w in spec["workloads"]:
        if not (HERE / "traffic" / f"{w['traffic']}.json").is_file():
            errs.append(f"{w['name']}: no traffic/{w['traffic']}.json")
        if not (HERE / "workloads" / f"{w['name']}.json").is_file():
            errs.append(f"{w['name']}: no workloads/{w['name']}.json")
        reported = {m["name"] for m in metrics_of(spec, w["name"],
                                                  "end_to_end")}
        if "setup_s" not in reported or len(reported) < 2:
            errs.append(f"{w['name']}: reports {sorted(reported)}")
        if not metrics_of(spec, w["name"], "per_layer"):
            errs.append(f"{w['name']}: no per-layer metric")
    return errs


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is a forbidden one."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def result_line(correct: bool, attempted: int, failed: int,
                metrics: Dict[str, Dict], device: Dict,
                checks: Dict[str, Dict], breakdown: Optional[Dict] = None
                ) -> str:
    """The run's last line: the driver's keys, then the compared numbers
    beside their limits under a key of their own, last."""
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)
