from paddlebox_tpu_torch.train.dense_opt import Adam, AdamState
from paddlebox_tpu_torch.train.async_dense import AsyncDenseTable
from paddlebox_tpu_torch.train.train_step import TrainState, TrainStepConfig, make_train_step
from paddlebox_tpu_torch.train.resident_step import (
    ResidentPass,
    ResidentPvFeed,
    build_device_batch,
    build_mesh_device_batch,
    ensure_sharded,
    make_resident_mesh_superstep,
    make_resident_pv_mesh_superstep,
    make_resident_pv_superstep,
    make_resident_superstep,
)
from paddlebox_tpu_torch.train.sharded_step import (
    init_sharded_train_state,
    kstep_sync_params,
    make_local_mesh_step,
    make_sharded_train_step,
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
from paddlebox_tpu_torch.train.supervisor import (
    HealthGates,
    Incident,
    PassFailure,
    PassRejected,
    PassSupervisor,
    RetryPolicy,
)
from paddlebox_tpu_torch.train.stream import DirectoryTailer, StreamLineageError, StreamSupervisor

__all__ = [
    "TrainState",
    "make_train_step",
    "TrainStepConfig",
    "ResidentPass",
    "build_device_batch",
    "make_resident_superstep",
    "ResidentPvFeed",
    "make_resident_pv_superstep",
    "ensure_sharded",
    "build_mesh_device_batch",
    "make_resident_mesh_superstep",
    "make_resident_pv_mesh_superstep",
    "init_sharded_train_state",
    "make_local_mesh_step",
    "make_sharded_train_step",
    "kstep_sync_params",
    "CTRTrainer",
    "CheckpointManager",
    "DeltaLineageError",
    "MembershipEpochError",
    "read_watermark",
    "validate_watermark",
    "verify_snapshot",
    "PassGuard",
    "HealthGates",
    "Incident",
    "PassFailure",
    "PassRejected",
    "PassSupervisor",
    "RetryPolicy",
    "DirectoryTailer",
    "StreamLineageError",
    "StreamSupervisor",
    "Adam",
    "AdamState",
    "AsyncDenseTable",
]
