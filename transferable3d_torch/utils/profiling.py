"""Profiling helpers: a trace around a region, a call's device time and a
steady-state step timer.

Port of `transferable3d_tpu/utils/profiling.py`: `trace` captures a
`torch.profiler` trace (the card's kernels through CUPTI where the card
is present, the host's operators always) and writes it as a Chrome trace
under `log_dir`, which TensorBoard's profile plugin and
`chrome://tracing` / Perfetto read; `device_ms` times a call with CUDA
events when its tensors live on the card and with the host's clock when
they live on the CPU; `StepTimer` is the JAX package's as it is. The TPU
trace parser `xplane_exclusive_ps` has no counterpart.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[Optional[
        "torch.profiler.profile"]]:
    """Capture a `torch.profiler` trace of the block into `log_dir` as
    `<host>_<pid>.<ms>.pt.trace.json` (no-op, yielding None, if
    `log_dir` is empty). Yields the profiler, whose `key_averages()`
    hold the block's operators and kernels once it has ended."""
    if not log_dir:
        yield None
        return
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


def _cuda_device(args) -> Optional[torch.device]:
    """The device of the first CUDA tensor among `args` (nested lists,
    tuples and dicts included), else None."""
    stack = list(args)
    while stack:
        x = stack.pop(0)
        if torch.is_tensor(x):
            if x.is_cuda:
                return x.device
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
    return None


def device_ms(fn, *args, steps: int = 3) -> float:
    """Milliseconds per call of `fn(*args)`, after one untimed call.

    Where an argument lives on the card, CUDA events on its device's
    current stream bracket `steps` calls; otherwise the host's clock
    does, read after the calls return. Tensors stay where they are and
    no device is chosen."""
    device = _cuda_device(args)
    fn(*args)
    if device is None:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn(*args)
        return (time.perf_counter() - t0) * 1e3 / steps
    with torch.cuda.device(device):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(steps):
            fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / steps


class StepTimer:
    """Steady-state steps/sec with warmup exclusion."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self._n = 0
        self._t0 = None

    def tick(self) -> None:
        self._n += 1
        if self._n == self.warmup:
            self._t0 = time.perf_counter()

    def rate(self) -> float:
        """Steps/sec over the post-warmup window."""
        if self._t0 is None or self._n <= self.warmup:
            return 0.0
        return (self._n - self.warmup) / (time.perf_counter() - self._t0)
