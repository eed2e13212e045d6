"""Profiling helpers: a trace around a region, a call's device time and
the program's spans.

Port of `transferable3d_tpu/utils/profiling.py`: `trace` captures a
`torch.profiler` trace (the card's kernels through CUPTI where the card
is present, the host's operators always) and writes it as a Chrome trace
under `log_dir`, which TensorBoard's profile plugin and
`chrome://tracing` / Perfetto read; `device_ms` times a call with CUDA
events when its tensors live on the card and with the host's clock when
they live on the CPU. The TPU trace parser `xplane_exclusive_ps` has no
counterpart.

`span(name)` marks a phase of the program (the step's draw, forward,
loss, backward, all-reduce, optimizer and metrics; the predict step's
input copy and decode; the model's seg net and box stages). While no
`torch.profiler` records, a span is one check and nothing else. While
one records (`trace(log_dir)`, or a profiler's active steps under a
`schedule`), the span is a `record_function` range in the trace, on the
profiler's own clock, and a pair of CUDA timing events on the current
stream (the host's clock where the process has not initialised CUDA,
whose ops are synchronous); `span_ms()` reads them as each name's count
and device-timeline milliseconds. A span records nothing while the
current stream is being captured into a CUDA graph.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

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


# The process's spans since the last `reset_spans()`: those still to be
# read, as (name, start, end) with CUDA events or host-clock seconds, in
# the order they ended, and {name: [count, ms]} of those read. A span
# sits in library code with no handle of its caller, so the record is
# the module's, as the profiler's own state is.
_PENDING: List[Tuple[str, Any, Any]] = []
_TOTALS: Dict[str, List[float]] = {}


def _mark(cuda: bool):
    if not cuda:
        return time.perf_counter()
    event = torch.cuda.Event(enable_timing=True)
    event.record()
    return event


class span:
    """`with span("t3d.<phase>"):` marks a phase of the program (see the
    module's docstring): off, one check; while a profiler records, a
    `record_function` range and a pair of timing marks that
    `span_ms()` reads."""

    __slots__ = ("name", "_range", "_start")

    def __init__(self, name: str):
        self.name = name
        self._range = None

    def __enter__(self) -> "span":
        if not torch.autograd._profiler_enabled():
            return self
        cuda = torch.cuda.is_initialized()
        if cuda and torch.cuda.is_current_stream_capturing():
            return self
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self._start = _mark(cuda)
        return self

    def __exit__(self, *exc) -> bool:
        if self._range is None:
            return False
        end = _mark(not isinstance(self._start, float))
        self._range.__exit__(*exc)
        self._range = None
        _PENDING.append((self.name, self._start, end))
        return False


def span_ms() -> Dict[str, Tuple[int, float]]:
    """{name: (count, milliseconds summed)} of the spans recorded since
    the last `reset_spans()`. A span's milliseconds are the device
    timeline's from its start to its end, busy and idle together (the
    host's clock without CUDA). Waits for the events it reads."""
    for name, start, end in _PENDING:
        if isinstance(start, float):
            ms = (end - start) * 1e3
        else:
            end.synchronize()
            ms = start.elapsed_time(end)
        total = _TOTALS.setdefault(name, [0, 0.0])
        total[0] += 1
        total[1] += ms
    _PENDING.clear()
    return {k: (int(c), ms) for k, (c, ms) in _TOTALS.items()}


def reset_spans() -> None:
    """Forget every span recorded so far."""
    _PENDING.clear()
    _TOTALS.clear()
