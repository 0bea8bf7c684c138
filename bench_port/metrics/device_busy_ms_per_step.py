"""Device milliseconds a training step keeps the card busy: the union of
the kernels, copies and fills in the traced window, over its steps. The
host's dispatch does not enter it, so it reads alike from run to run where
the rate does not."""

LAYER = "device"
UNIT = "ms"
MOVES = "train_samples_per_s"


def read(r):
    return r.trace.busy_s / r.steps * 1e3 if r.steps and r.trace.busy_s > 0 else None
