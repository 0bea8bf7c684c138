"""The share of the traced window in which no kernel, copy or fill ran on
the card: one less the union of the device's operations over the
window."""

LAYER = "device"
UNIT = "%"
MOVES = "train_samples_per_s"


def read(r):
    return r.idle_pct()
