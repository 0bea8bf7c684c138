from paddlebox_tpu_torch.metrics.auc import AucState, auc_compute, auc_init, auc_psum, auc_update
from paddlebox_tpu_torch.metrics.registry import (
    CmatchRankMaskMetricMsg,
    CmatchRankMetricMsg,
    MaskMetricMsg,
    MetricMsg,
    MetricRegistry,
    MultiTaskMetricMsg,
    parse_cmatch_rank_group,
)

__all__ = [
    "AucState",
    "auc_init",
    "auc_update",
    "auc_compute",
    "auc_psum",
    "MetricMsg",
    "MaskMetricMsg",
    "CmatchRankMetricMsg",
    "MultiTaskMetricMsg",
    "CmatchRankMaskMetricMsg",
    "MetricRegistry",
    "parse_cmatch_rank_group",
]
