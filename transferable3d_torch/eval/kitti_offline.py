"""Python wrapper around the native `kitti_eval` binary (SURVEY.md N4).

Copy of `transferable3d_tpu/eval/kitti_offline.py` (which imports no JAX,
but the port imports nothing of the JAX package). It drives the same
`native/kitti_eval/` sources at the repository root.

Builds the C++ evaluator on first use (cached next to the source), then
invokes it as a subprocess on a GT dir + result dir — the same process
boundary as the reference's `evaluate_object_3d_offline` call in
`train/test.py` (call stack §3.4).
"""

from __future__ import annotations

import os
import subprocess
from typing import Dict, Optional, Tuple

_SRC_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native", "kitti_eval")


def build_binary(src_dir: str = _SRC_DIR) -> str:
    """Compile kitti_eval if needed; returns the binary path."""
    binary = os.path.join(src_dir, "kitti_eval")
    src = os.path.join(src_dir, "kitti_eval.cpp")
    if (not os.path.exists(binary)
            or os.path.getmtime(binary) < os.path.getmtime(src)):
        subprocess.run(["make", "-C", src_dir], check=True,
                       capture_output=True)
    return binary


def evaluate_offline(gt_dir: str, result_dir: str,
                     list_file: Optional[str] = None
                     ) -> Dict[Tuple[str, str, str], float]:
    """Run the evaluator; returns {(class, metric, difficulty): AP_R11}.

    Also leaves the binary's stats_<class>_ap.txt files in result_dir
    (reference-compatible artifact layout).
    """
    binary = build_binary()
    cmd = [binary, gt_dir, result_dir]
    if list_file:
        cmd.append(list_file)
    out = subprocess.run(cmd, check=True, capture_output=True, text=True)

    results: Dict[Tuple[str, str, str], float] = {}
    for line in out.stdout.splitlines():
        # "Car AP(3d) @0.70: easy=12.34/13.00 moderate=... (R11/R40)"
        if " AP(" not in line:
            continue
        head, rest = line.split(":", 1)
        cls = head.split()[0]
        metric = head.split("AP(")[1].split(")")[0]
        for tok in rest.split():
            if "=" in tok:
                dif, vals = tok.split("=")
                results[(cls, metric, dif)] = float(vals.split("/")[0])
    return results
