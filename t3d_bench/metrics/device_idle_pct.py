"""device_idle_pct (`.train`, `.infer`): 100 x (1 - the device's busy
seconds a step, the union of its activity over the traced stretch's
steps / the seconds a step takes without the profiler, on the host's
clock after the stretch); the mean over the ranks. The profiler slows
the host's launches, so the stretch's own length would overstate the
idle share of a step that the host paces."""

from t3d_bench import trace


def read(rd):
    if not rd.stretches or not rd.step_seconds:
        return None
    shares = [trace.busy_seconds(st) / st.steps / s
              for st, s in zip(rd.stretches, rd.step_seconds)]
    return 100.0 * (1.0 - sum(shares) / len(shares))
