"""mfu_pct (`.train`, `.infer`): the FLOPs a step requires by the FLOP
rule (work/counts.py; forward, and in training backward) over the
seconds a step takes on the host's clock after the traced stretch (no
profiler), over the chips' published bf16 peak."""

from t3d_bench.work import counts


def read(rd):
    if rd.peak is None or not rd.step_seconds:
        return None
    seconds = sum(rd.step_seconds) / len(rd.step_seconds)
    flops = counts.step_flops(rd.cfg, rd.frustums_per_step, rd.train)
    return 100.0 * flops / seconds / (rd.peak["bf16_flops"] * rd.chips)
