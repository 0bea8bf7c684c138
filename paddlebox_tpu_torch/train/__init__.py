from paddlebox_tpu_torch.train.dense_opt import Adam, AdamState
from paddlebox_tpu_torch.train.train_step import TrainState, TrainStepConfig, make_train_step
from paddlebox_tpu_torch.train.trainer import CTRTrainer

__all__ = [
    "TrainState",
    "make_train_step",
    "TrainStepConfig",
    "CTRTrainer",
    "Adam",
    "AdamState",
]
