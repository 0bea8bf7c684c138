"""``write_rows_cuda``'s share of its roofline: the least time of its
launches (each step's distinct keys: ids once, new rows read once and
written once, over the HBM rate) over their summed time in the device
trace. One launch a step."""

from bench_port.core.roofline import least_s, writeback_bytes

LAYER = "ops.cuda_kernels"
UNIT = "%"
MOVES = "train_samples_per_s"
KERNEL = "write_rows_kernel"


def read(r):
    n, s = r.trace.kernel(KERNEL)
    if n != r.steps or s <= 0:
        return None
    least = sum(least_s(writeback_bytes(u, r.width)) for u in r.u_distinct)
    return least / s * 100.0
