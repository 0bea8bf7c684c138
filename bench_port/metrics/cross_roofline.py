"""DLRM's cross network's share of its roofline: the least time of the
traced steps' cross layers, forward and backward (the larger of their
FLOPs at 989 TFLOP/s and their least bytes at 3.35 TB/s,
``core/layer_counts.py``), over the device time of the kernels launched
under the port's ``dlrm.cross`` and ``dlrm.cross.bwd`` spans. None where
the trace gives those spans no device time."""

from bench_port.core.layer_counts import cross_least_s

LAYER = "models.dlrm"
UNIT = "%"
MOVES = "train_samples_per_s"
SPANS = ("dlrm.cross", "dlrm.cross.bwd")


def read(r):
    s = sum(getattr(r, "span_device_s", {}).get(n, 0.0) for n in SPANS)
    if s <= 0 or not r.steps:
        return None
    return r.steps * cross_least_s(r.batch, r.cross_dim, r.cross_rank, r.cross_layers) / s * 100.0
