"""Host milliseconds a training step spends dispatching its work: the
port's ``superstep_dispatch`` spans (one a superstep of
``resident_scan_batches`` steps), summed over the traced window, over
its steps."""

LAYER = "train.trainer"
UNIT = "ms"
MOVES = "train_samples_per_s"


def read(r):
    s = r.span_s("superstep_dispatch")
    return s / r.steps * 1e3 if s > 0 and r.steps else None
