"""Training log utilities.

Capability parity target: the reference's `log_string()` -> stdout +
`log_train.txt`, plus TF summaries (SURVEY.md §5.5). Here: stdout + file
via `Logger`, structured per-step metrics to CSV, and TensorBoard scalars
when `tensorboardX` is importable (it is baked into the image per
SURVEY.md §5.5; gated so the package works without it).

Copy of `transferable3d_tpu/utils/logging.py`, which imports no JAX (the
port imports nothing of the JAX package): the same files, lines and
columns, and an `echo` switch for the ranks that do not log.
"""

from __future__ import annotations

import csv
import os
import time
from typing import Dict, Optional


class Logger:
    def __init__(self, log_dir: Optional[str] = None,
                 filename: str = "log_train.txt",
                 tensorboard: bool = True, echo: bool = True):
        """`echo=False` (with no `log_dir`) silences the logger: the
        data-parallel drivers give one to every rank but rank 0."""
        self.log_dir = log_dir
        self.echo = echo
        self._file = None
        self._csv = None
        self._csv_writer = None
        self._csv_fields = None
        self._tb = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._file = open(os.path.join(log_dir, filename), "a")
            if tensorboard:
                try:
                    from tensorboardX import SummaryWriter
                    self._tb = SummaryWriter(log_dir)
                except ImportError:
                    self._tb = None

    def log_string(self, msg: str) -> None:
        """stdout + log file (reference `log_string`)."""
        stamp = time.strftime("%H:%M:%S")
        line = f"[{stamp}] {msg}"
        if self.echo:
            print(line, flush=True)
        if self._file:
            self._file.write(line + "\n")
            self._file.flush()

    def log_metrics(self, step: int, metrics: Dict[str, float],
                    prefix: str = "train") -> None:
        metrics = {k: float(v) for k, v in metrics.items()}
        if self._tb:
            for k, v in metrics.items():
                self._tb.add_scalar(f"{prefix}/{k}", v, step)
        if self.log_dir:
            path = os.path.join(self.log_dir, f"metrics_{prefix}.csv")
            fields = ["step"] + sorted(metrics)
            new = not os.path.exists(path)
            with open(path, "a", newline="") as f:
                w = csv.DictWriter(f, fieldnames=fields)
                if new:
                    w.writeheader()
                w.writerow({"step": step, **metrics})

    def close(self) -> None:
        if self._file:
            self._file.close()
        if self._tb:
            self._tb.close()
