"""Host-side batch packer: SlotBatch -> static-shape arrays for the device.

Everything ragged or key-valued is resolved here on the host —

- keys -> pass-local global rows (PassWorkingSet.lookup)
- cross-slot dedup: unique rows + inverse indices
  (flag enable_pullpush_dedup_keys parity)
- segment ids (slot * batch + ins) for the fused seqpool
- padding to bucketed lengths so the device sees few distinct shapes

The device then runs only gather/segment-sum over these arrays. The arrays
stay numpy: the caller moves them to its device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from paddlebox_tpu_torch import config
from paddlebox_tpu_torch.data.slot_record import SlotBatch
from paddlebox_tpu_torch.data.slot_schema import SlotSchema
from paddlebox_tpu_torch.table.sparse_table import PassWorkingSet


def _round_bucket(n: int, quantum: int) -> int:
    return max(quantum, -(-n // quantum) * quantum)


@dataclass
class DeviceBatch:
    """Static-shape arrays consumed by the step."""

    batch_size: int
    num_slots: int
    uniq_rows: np.ndarray  # int32 [U_pad] table rows, deduped; pads -> padding row
    inverse: np.ndarray  # int32 [L_pad] flat key -> uniq index; pads -> U_pad-1
    segments: np.ndarray  # int32 [L_pad] slot*B+ins; pads -> S*B (trash segment)
    labels: np.ndarray  # f32 [B]
    dense: Optional[np.ndarray]  # f32 [B, dense_dim] or None
    n_keys: int  # true (unpadded) flat key count
    n_uniq: int  # true unique count

    def as_dict(self) -> Dict[str, np.ndarray]:
        d = {
            "uniq_rows": self.uniq_rows,
            "inverse": self.inverse,
            "segments": self.segments,
            "labels": self.labels,
        }
        if self.dense is not None:
            d["dense"] = self.dense
        return d


def _extract_labels_dense(
    batch: SlotBatch,
    schema: SlotSchema,
    label_slot: Optional[str],
    dense_slot: Optional[str],
    dense_dim: int,
):
    """Label and dense-float extraction."""
    label_name = label_slot or schema.label_slot
    if label_name is not None:
        li = schema.float_slot_index(label_name)
        labels = batch.dense_float_matrix(li, 1)[:, 0]
    else:
        labels = np.zeros(batch.batch_size, dtype=np.float32)
    dense = None
    if dense_slot is not None and dense_dim:
        di = schema.float_slot_index(dense_slot)
        dense = batch.dense_float_matrix(di, dense_dim)
    return labels.astype(np.float32), dense


def pack_batch(
    batch: SlotBatch,
    ws: PassWorkingSet,
    schema: SlotSchema,
    dense_slot: Optional[str] = None,
    dense_dim: int = 0,
    label_slot: Optional[str] = None,
    bucket: Optional[int] = None,
    dedup: Optional[bool] = None,
) -> DeviceBatch:
    bucket = bucket or config.get_flag("batch_bucket_rounding")
    if dedup is None:
        dedup = config.get_flag("enable_pullpush_dedup_keys")
    B = batch.batch_size
    S = batch.num_sparse_slots

    rows = ws.lookup(batch.keys)  # int32 [L]
    segments = batch.segment_ids()  # int32 [L], non-decreasing (slot-major)
    L = len(rows)

    if dedup:
        uniq, inverse = np.unique(rows, return_inverse=True)
    else:
        uniq, inverse = rows, np.arange(L, dtype=np.int64)
    U = len(uniq)

    L_pad = _round_bucket(L, bucket)
    U_pad = _round_bucket(U + 1, bucket)  # +1 keeps one guaranteed pad slot

    uniq_p = np.full(U_pad, ws.padding_row, dtype=np.int32)
    uniq_p[:U] = uniq
    inv_p = np.full(L_pad, U_pad - 1, dtype=np.int32)
    inv_p[:L] = inverse
    seg_p = np.full(L_pad, S * B, dtype=np.int32)
    seg_p[:L] = segments

    labels, dense = _extract_labels_dense(batch, schema, label_slot, dense_slot, dense_dim)

    return DeviceBatch(
        batch_size=B,
        num_slots=S,
        uniq_rows=uniq_p,
        inverse=inv_p,
        segments=seg_p,
        labels=labels,
        dense=dense,
        n_keys=L,
        n_uniq=U,
    )
