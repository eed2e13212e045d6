"""sa_infer_roofline: the SA chains' least time (work/counts.py's
function-level bytes and operations, on the traced stretch's balls) over
the device time of the kernels that compute them, matched by name: K2
(csrc/sa_infer.cu). A later change that renames these kernels brings a
metric file of its own."""

from t3d_bench.work import counts

KERNELS = "|".join((
    "sa_infer_mma_kernel",
    "sa_infer_general_kernel",
))


def read(rd):
    if (rd.train or rd.peak is None or not rd.stretches
            or not rd.sa_calls):
        return None
    seconds = rd.stretches[0].kernel_seconds(KERNELS)
    if seconds <= 0:
        return None
    least = sum(counts.least_seconds(*counts.sa_chain_work(
        c["b"], c["s"], c["n"], c["widths"][0], c["widths"],
        c["unique_rows"], rd.train), rd.peak) for c in rd.sa_calls)
    return 100.0 * least / seconds
