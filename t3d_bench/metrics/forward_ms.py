"""forward_ms (`.train`): the device timeline's milliseconds of the span
`t3d.forward`, the step's forward, a step of the traced stretch (its sum
over the count of `t3d.train_step`), busy and idle together."""

from t3d_bench.metrics import _spans


def read(rd):
    return _spans.ms_a_step(rd, "t3d.forward")
