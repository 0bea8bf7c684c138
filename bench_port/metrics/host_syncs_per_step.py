"""Blocking host reads of the device a training step: the port's spans of
category ``sync`` (one a wait or read back) in the traced window, over its
steps. None where the program records no ``train_pass.open`` span, so
its waits have no spans to count."""

LAYER = "train.trainer"
UNIT = "count"
MOVES = "train_samples_per_s"


def read(r):
    if not r.steps or not r.span_s("train_pass.open"):
        return None
    return sum(1 for e in r.spans if e.get("cat") == "sync" and e.get("ph") == "X") / r.steps
