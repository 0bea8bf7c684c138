from paddlebox_tpu_torch.train.dense_opt import Adam, AdamState
from paddlebox_tpu_torch.train.async_dense import AsyncDenseTable
from paddlebox_tpu_torch.train.train_step import TrainState, TrainStepConfig, make_train_step
from paddlebox_tpu_torch.train.resident_step import (
    ResidentPass,
    ResidentPvFeed,
    build_device_batch,
    make_resident_pv_superstep,
    make_resident_superstep,
)
from paddlebox_tpu_torch.train.trainer import CTRTrainer
from paddlebox_tpu_torch.train.checkpoint import (
    CheckpointManager,
    DeltaLineageError,
    MembershipEpochError,
    read_watermark,
    validate_watermark,
    verify_snapshot,
)
from paddlebox_tpu_torch.train.rollback import PassGuard

__all__ = [
    "TrainState",
    "make_train_step",
    "TrainStepConfig",
    "ResidentPass",
    "build_device_batch",
    "make_resident_superstep",
    "ResidentPvFeed",
    "make_resident_pv_superstep",
    "CTRTrainer",
    "CheckpointManager",
    "DeltaLineageError",
    "MembershipEpochError",
    "read_watermark",
    "validate_watermark",
    "verify_snapshot",
    "PassGuard",
    "Adam",
    "AdamState",
    "AsyncDenseTable",
]
