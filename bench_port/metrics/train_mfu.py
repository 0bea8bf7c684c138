"""The training step's share of the chips' bf16 peak (989 TFLOP/s a
card): the tower's forward and backward FLOPs a step, from its shapes,
times the traced steps, over the traced window and the chips."""

LAYER = "train.resident_step + models"
UNIT = "%"
MOVES = "train_samples_per_s"


def read(r):
    return r.mfu_pct()
