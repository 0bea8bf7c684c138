from paddlebox_tpu_torch.train.train_step import TrainState, TrainStepConfig, make_train_step

__all__ = ["TrainState", "make_train_step", "TrainStepConfig"]
