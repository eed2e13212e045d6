"""program_idle_pct (`.train`, `.infer`): 100 x the traced stretch's
device-idle seconds (`trace.idle_gaps`) in which the host was inside one
of the program's root spans (`t3d.train_step` or `t3d.draw` in
training, `t3d.predict` in serving; their host intervals, on the
profiler's clock that the device trace shares) over all of its
device-idle seconds; rank 0's. The rest is idle while the host ran the
caller's code: the benchmark's loop, and in serving its copy-back of
the detections."""

from t3d_bench import trace
from t3d_bench.metrics import _spans


def read(rd):
    if not rd.stretches:
        return None
    st = rd.stretches[0]
    roots = [(e.start_us, e.end_us) for e in st.host
             if e.name in _spans.ROOTS[rd.train]]
    gaps = trace.idle_gaps(st)
    idle = sum(b - a for a, b in gaps) * 1e-6
    if not roots or idle <= 0:
        return None
    inside = sum(trace.union_seconds(roots, a, b) for a, b in gaps)
    return 100.0 * inside / idle
