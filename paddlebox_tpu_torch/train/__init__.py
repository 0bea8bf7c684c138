from paddlebox_tpu_torch.train.dense_opt import Adam, AdamState
from paddlebox_tpu_torch.train.train_step import TrainState, TrainStepConfig, make_train_step
from paddlebox_tpu_torch.train.resident_step import (
    ResidentPass,
    build_device_batch,
    make_resident_superstep,
)
from paddlebox_tpu_torch.train.trainer import CTRTrainer

__all__ = [
    "TrainState",
    "make_train_step",
    "TrainStepConfig",
    "ResidentPass",
    "build_device_batch",
    "make_resident_superstep",
    "CTRTrainer",
    "Adam",
    "AdamState",
]
