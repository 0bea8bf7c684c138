from paddlebox_tpu_torch.table.value_layout import FeatureType, ValueLayout
from paddlebox_tpu_torch.table.sparse_table import HostSparseTable, PassWorkingSet, SpillIOError
from paddlebox_tpu_torch.table.optimizers import SparseOptimizerConfig
from paddlebox_tpu_torch.table.replica_cache import InputTable, ReplicaCache, pull_cache_value

__all__ = [
    "ValueLayout",
    "FeatureType",
    "PassWorkingSet",
    "HostSparseTable",
    "SpillIOError",
    "SparseOptimizerConfig",
    "ReplicaCache",
    "InputTable",
    "pull_cache_value",
]
