from paddlebox_tpu_torch.data.slot_schema import SlotInfo, SlotSchema
from paddlebox_tpu_torch.data.slot_record import SlotBatch, SlotRecord, build_batch
from paddlebox_tpu_torch.data.parser import parse_line, parse_logkey
from paddlebox_tpu_torch.data.record_store import ColumnarRecords
from paddlebox_tpu_torch.data.device_pack import BatchPacker, DeviceBatch, pack_batch
from paddlebox_tpu_torch.data.pipeline import prefetch
from paddlebox_tpu_torch.data.dataset import BoxPSDataset, PassStats

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
]
