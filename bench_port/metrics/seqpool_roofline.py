"""The multi-hot seqpool's share of its roofline: the least bytes of the
traced steps' pooling, forward and backward (every pooled key's record and
every pooled row, read or written once each way at the pull width,
``core/layer_counts.py``), at 3.35 TB/s, over the device time of the
kernels launched under the port's ``seqpool`` and ``seqpool.bwd`` spans.
The keys are the program's ``pooled_keys`` counter over the window; None
where it differs from the benchmark's own count of the traced steps'
keys, or the spans have no device time."""

from bench_port.core.layer_counts import seqpool_least_s

LAYER = "ops.seqpool_cvm"
UNIT = "%"
MOVES = "train_samples_per_s"
SPANS = ("seqpool", "seqpool.bwd")


def read(r):
    keys = getattr(r, "pooled_keys", None)
    s = sum(getattr(r, "span_device_s", {}).get(n, 0.0) for n in SPANS)
    if keys is None or keys != r.counted_keys or s <= 0 or not r.steps:
        return None
    return seqpool_least_s(keys, r.steps * r.batch * r.num_slots, r.pull_width) / s * 100.0
