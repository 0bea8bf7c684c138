"""Host milliseconds a training step spends at the edges of its
``train_pass`` call: the port's ``train_pass.open``, ``resident_prepare``
and ``train_pass.close`` spans, summed over the traced window, over its
steps. On the resident feed nothing is queued on the card during these
spans, so this is host time that leaves the card idle between calls.
None where the program records no ``train_pass.open`` and
``train_pass.close`` spans."""

LAYER = "train.trainer"
UNIT = "ms"
MOVES = "train_samples_per_s"
SPANS = ("train_pass.open", "resident_prepare", "train_pass.close")


def read(r):
    if not r.steps or not (r.span_s("train_pass.open") and r.span_s("train_pass.close")):
        return None
    return sum(r.span_s(n) for n in SPANS) / r.steps * 1e3
