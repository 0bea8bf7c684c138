from paddlebox_tpu_torch.data.slot_schema import SlotInfo, SlotSchema
from paddlebox_tpu_torch.data.slot_record import SlotBatch, SlotRecord, build_batch
from paddlebox_tpu_torch.data.parser import parse_line, parse_logkey
from paddlebox_tpu_torch.data.record_store import ColumnarRecords
from paddlebox_tpu_torch.data.device_pack import BatchPacker, DeviceBatch, pack_batch
from paddlebox_tpu_torch.data.pipeline import prefetch
from paddlebox_tpu_torch.data.dataset import BoxPSDataset, PassStats
from paddlebox_tpu_torch.data.pv_instance import (
    PvInstance,
    PvPlan,
    build_pv_plan,
    build_rank_offset,
    count_pv_batches,
    flatten_pv_instances,
    merge_pv_instances,
    pack_pv_batches,
)

__all__ = [
    "SlotSchema",
    "SlotInfo",
    "SlotRecord",
    "SlotBatch",
    "build_batch",
    "parse_line",
    "parse_logkey",
    "ColumnarRecords",
    "DeviceBatch",
    "pack_batch",
    "BatchPacker",
    "prefetch",
    "BoxPSDataset",
    "PassStats",
    "PvInstance",
    "PvPlan",
    "merge_pv_instances",
    "flatten_pv_instances",
    "build_rank_offset",
    "pack_pv_batches",
    "build_pv_plan",
    "count_pv_batches",
]
