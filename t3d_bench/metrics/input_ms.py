"""input_ms (`.infer`): the device timeline's milliseconds of the span
`t3d.input`, the predict step's copies of the batch to the device, a
call of the traced stretch (its sum over the count of `t3d.predict`),
busy and idle together."""

from t3d_bench.metrics import _spans


def read(rd):
    return _spans.ms_a_step(rd, "t3d.input")
