"""``pull_rows_cuda``'s share of its roofline: the least time of its
launches (each step's distinct keys: ids once, rows read once and
written out once at the table's width, over the HBM rate) over their
summed time in the device trace. Two launches a step: the pull and the
push's read of the old rows."""

from bench_port.core.roofline import gather_bytes, least_s

LAYER = "ops.cuda_kernels"
UNIT = "%"
MOVES = "train_samples_per_s"
KERNEL = "gather_rows_kernel"
LAUNCHES_A_STEP = 2


def read(r):
    n, s = r.trace.kernel(KERNEL)
    if n != LAUNCHES_A_STEP * r.steps or s <= 0:
        return None
    least = sum(LAUNCHES_A_STEP * least_s(gather_bytes(u, r.width)) for u in r.u_distinct)
    return least / s * 100.0
