"""What the readers of the program's spans share. The program
(`transferable3d_torch.utils.profiling.span`) records a span only while
a profiler records, so in a traced run its spans are those of the
stretch's steps, in this process (rank 0's). A program without spans
gives no reading, and no error."""

# The program's root spans: each step's (first) and what the caller runs
# of the program outside it, in training and in serving.
ROOTS = {True: ("t3d.train_step", "t3d.draw"), False: ("t3d.predict",)}


def ms_a_step(rd, name: str):
    """The device timeline's milliseconds of span `name` a step: its sum
    over the count of the step's root span; None without a traced
    stretch or without the spans."""
    if not rd.stretches:
        return None
    from transferable3d_torch.utils import profiling

    span_ms = getattr(profiling, "span_ms", None)
    if span_ms is None:
        return None
    spans = span_ms()
    root = ROOTS[rd.train][0]
    if name not in spans or root not in spans:
        return None
    return spans[name][1] / spans[root][0]
