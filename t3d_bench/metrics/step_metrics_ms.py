"""step_metrics_ms (`.train`): the device timeline's milliseconds of the
span `t3d.step_metrics`, the step's box-IoU metrics and their reduction,
a step of the traced stretch (its sum over the count of
`t3d.train_step`), busy and idle together."""

from t3d_bench.metrics import _spans


def read(rd):
    return _spans.ms_a_step(rd, "t3d.step_metrics")
