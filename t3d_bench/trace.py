"""Reduction of a `torch.profiler` trace of a bounded stretch of the window.

The traced run profiles a steady stretch of the window with a profiler
`schedule` (wait, warm-up, active steps); every step or call of the
window runs inside a `t3d_bench.step` span of the benchmark's own. The
trace reduces to `Stretch`: the device's activity (kernels, copies,
sets) and the host's spans and operators as plain intervals, from which
the per-layer readers (metrics/) take what they need, and `breakdown`
takes the device operations that took most time and the longest idle
gaps named by what the host was doing.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

STEP_SPAN = "t3d_bench.step"


class Event(NamedTuple):
    name: str
    device: bool      # on the card (kernel, copy, set) or on the host
    start_us: float
    end_us: float


@dataclasses.dataclass
class Stretch:
    """The profiled steps: device events inside [start, end] and the
    host's operators and spans."""
    steps: int
    start_us: float
    end_us: float
    device: List[Event]
    host: List[Event]

    @property
    def seconds(self) -> float:
        return (self.end_us - self.start_us) * 1e-6

    def kernels(self) -> List[Event]:
        """Device events that are kernels (not copies or sets)."""
        return [e for e in self.device if not is_copy_or_set(e.name)]

    def kernel_seconds(self, pattern: str) -> float:
        rx = re.compile(pattern)
        return sum(e.end_us - e.start_us for e in self.device
                   if rx.search(e.name)) * 1e-6


def is_copy_or_set(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


def stretch_from_events(events: Sequence[Event]) -> Optional[Stretch]:
    """The stretch spanned by the `t3d_bench.step` spans among `events`
    (from the first span's start to the later of the last span's end and
    the last device event's end), or None without a span."""
    steps = sorted((e for e in events if not e.device
                    and e.name == STEP_SPAN), key=lambda e: e.start_us)
    if not steps:
        return None
    start = steps[0].start_us
    device = sorted((e for e in events if e.device
                     and e.end_us > start), key=lambda e: e.start_us)
    end = max([steps[-1].end_us] + [e.end_us for e in device])
    host = [e for e in events if not e.device and e.name != STEP_SPAN
            and not e.name.startswith("ProfilerStep") and e.end_us > start]
    return Stretch(len(steps), start, end, device, host)


def union_seconds(intervals: Sequence[Tuple[float, float]],
                  lo: float, hi: float) -> float:
    """Length in seconds of the union of [start, end] microsecond
    intervals, clipped to [lo, hi]."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total * 1e-6


def busy_seconds(st: Stretch) -> float:
    return union_seconds([(e.start_us, e.end_us) for e in st.device],
                         st.start_us, st.end_us)


def idle_gaps(st: Stretch) -> List[Tuple[float, float]]:
    """The stretch's intervals (us) in which no device event ran."""
    gaps, t = [], st.start_us
    for e in st.device:
        if e.start_us > t:
            gaps.append((t, e.start_us))
        t = max(t, e.end_us)
    if st.end_us > t:
        gaps.append((t, st.end_us))
    return gaps


def host_doing(st: Stretch, t_us: float) -> str:
    """The innermost host operator running at t_us (the latest-started
    one that covers it); where none runs, the host is in Python between
    operators: "after <the last one to end>"."""
    best, last = None, None
    for e in st.host:
        if e.start_us <= t_us <= e.end_us:
            if best is None or e.start_us >= best.start_us:
                best = e
        elif e.end_us < t_us and (last is None or e.end_us > last.end_us):
            last = e
    if best is not None:
        return best.name
    return "host idle" if last is None else f"after {last.name}"


def breakdown(st: Stretch, top: int = 10) -> Dict[str, List]:
    """The device operations that took most time (seconds summed over
    the stretch, by name) and the longest idle gaps (seconds, named by
    what the host was doing at the gap's middle)."""
    by_name: Dict[str, float] = {}
    for e in st.device:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.end_us - e.start_us)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(idle_gaps(st), key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[_short(n), v * 1e-6] for n, v in ops],
            "idle_gaps": [[_short(host_doing(st, (a + b) / 2)),
                           (b - a) * 1e-6] for a, b in gaps]}


def _short(name: str, width: int = 120) -> str:
    return name if len(name) <= width else name[:width - 3] + "..."


def events_from_profiler(prof) -> List[Event]:
    """A finished `torch.profiler.profile`'s events as `Event`s. The
    spans' copies on the device's timeline (user annotations, which
    share their host span's name) are left out: they are not work."""
    from torch.autograd import DeviceType

    evs = list(prof.events())
    host_names = {e.name for e in evs if e.device_type != DeviceType.CUDA}
    out = []
    for e in evs:
        device = e.device_type == DeviceType.CUDA
        if device and (getattr(e, "is_user_annotation", False)
                       or e.name in host_names):
            continue
        tr = e.time_range
        out.append(Event(e.name, device, float(tr.start), float(tr.end)))
    return out

