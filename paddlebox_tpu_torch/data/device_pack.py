"""Host-side batch packers: static-shape arrays for the device.

``pack_batch`` packs one ``SlotBatch`` (the slow feed); ``BatchPacker``
packs batches of a pass's columnar store by record index (the fast feed).
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

import threading
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


class BatchPacker:
    """Pass-scoped fast packer over a ColumnarRecords store.

    Port of the JAX package's ``BatchPacker``, single device. Once per
    pass: key->row resolution of the whole store and the pass's label and
    dense matrices. Per batch, one native call (``csrc/batch_packer.cc``)
    does the ragged row gather, first-occurrence dedup and segment ids —
    MiniBatchGpuPack::pack_instance (data_feed.h:1418-1542) without any
    per-record Python. With ``enable_pullpush_dedup_keys`` off, or
    ``enable_native_parser`` off, the same arrays come from numpy (unique
    rows then sorted).

    ``pack`` is safe from several threads: each thread gets its own native
    scratch handle; the frozen pad shapes change under a lock.
    """

    def __init__(
        self,
        store,  # ColumnarRecords
        ws: PassWorkingSet,
        schema: SlotSchema,
        dense_slot: Optional[str] = None,
        dense_dim: int = 0,
        label_slot: Optional[str] = None,
        bucket: Optional[int] = None,
    ):
        self.store = store
        self.ws = ws
        self.schema = schema
        self.bucket = bucket or config.get_flag("batch_bucket_rounding")
        self.dense_dim = dense_dim
        self._rows = store.resolve_rows(ws)
        self._key_counts = store.key_counts()
        label_name = label_slot or schema.label_slot
        if label_name is not None:
            li = schema.float_slot_index(label_name)
            self._labels = store.float_slot_matrix(li, 1)[:, 0].astype(np.float32)
        else:
            self._labels = np.zeros(len(store), np.float32)
        if dense_slot is not None and dense_dim:
            di = schema.float_slot_index(dense_slot)
            self._dense = store.float_slot_matrix(di, dense_dim)
        else:
            self._dense = None
        self._n_table_rows = ws.n_mesh_shards * ws.capacity
        self._tls = threading.local()
        self._use_native = config.get_flag("enable_native_parser")
        self._dedup = config.get_flag("enable_pullpush_dedup_keys")
        # sticky pad shapes, grown only, under _shape_lock: L_pad frozen
        # from the pass's partition, U_pad from the first batch with 25%
        # headroom (the reused-pack-buffer discipline of MiniBatchGpuPack)
        self._shape_lock = threading.Lock()
        self._L_pad = 0  # guarded-by: _shape_lock
        self._U_pad = 0  # guarded-by: _shape_lock
        # every native handle spawned, in any thread, for close()
        self._all_native: list = []  # guarded-by: _shape_lock

    def freeze_shapes(self, batch_indices) -> None:
        """Fix L_pad for a whole pass up front: every batch's key count is
        known exactly from the record key counts. Call with the pass's
        batch partition before the first pack."""
        max_L = 1
        for idx in batch_indices:
            max_L = max(max_L, int(self._key_counts[np.asarray(idx)].sum()))
        with self._shape_lock:
            self._L_pad = max(self._L_pad, _round_bucket(max_L, self.bucket))

    def _native(self):
        from paddlebox_tpu_torch.utils import native

        p = getattr(self._tls, "packer", None)
        if p is None and self._use_native:
            p = native.NativePacker(
                self._rows, self.store.u64_base, self.store.u64_offsets,
                self.store.n_sparse, self._n_table_rows,
            )
            self._tls.packer = p
            with self._shape_lock:
                self._all_native.append(p)
        return p

    def _gather_flat(self, indices: np.ndarray):
        """(uniq[U], inverse[L], segments[L], L) for the batch, unpadded."""
        from paddlebox_tpu_torch.data.record_store import _ragged_indices

        indices = np.asarray(indices, dtype=np.int64)
        L = int(self._key_counts[indices].sum())
        p = self._native() if self._dedup else None
        if p is not None:
            return (*p.pack(indices, L), L)
        # numpy: per-slot ragged gather (slot-major), then unique
        S = self.store.n_sparse
        B = len(indices)
        off = self.store.u64_offsets[indices].astype(np.int64)
        base = self.store.u64_base[indices]
        parts, segs = [], []
        for s in range(S):
            starts = base + off[:, s]
            lens = off[:, s + 1] - off[:, s]
            parts.append(self._rows[_ragged_indices(starts, lens)])
            segs.append(np.repeat(s * B + np.arange(B, dtype=np.int32), lens))
        rows = np.concatenate(parts) if parts else np.zeros(0, np.int32)
        segments = np.concatenate(segs) if segs else np.zeros(0, np.int32)
        if self._dedup:
            uniq, inverse = np.unique(rows, return_inverse=True)
        else:
            uniq, inverse = rows, np.arange(L, dtype=np.int64)
        return uniq.astype(np.int32), inverse.astype(np.int32), segments, L

    def pack(self, indices: np.ndarray) -> DeviceBatch:
        """Batch of store records ``indices`` -> DeviceBatch."""
        uniq, inverse, segments, L = self._gather_flat(indices)
        B = len(indices)
        S = self.store.n_sparse
        U = len(uniq)
        with self._shape_lock:
            self._L_pad = max(self._L_pad, _round_bucket(L, self.bucket))
            if self._U_pad == 0:
                # first-batch headroom (25%) so later batches rarely grow
                # the shape; capped at L_pad+1 since U <= L always
                self._U_pad = _round_bucket(U + max(self.bucket, U // 4), self.bucket)
            else:
                self._U_pad = max(self._U_pad, _round_bucket(U + 1, self.bucket))
            self._U_pad = min(self._U_pad, _round_bucket(self._L_pad + 1, self.bucket))
            L_pad, U_pad = self._L_pad, self._U_pad
        uniq_p = np.full(U_pad, self.ws.padding_row, dtype=np.int32)
        uniq_p[:U] = uniq
        inv_p = np.full(L_pad, U_pad - 1, dtype=np.int32)
        inv_p[:L] = inverse
        seg_p = np.full(L_pad, S * B, dtype=np.int32)
        seg_p[:L] = segments
        return DeviceBatch(
            batch_size=B,
            num_slots=S,
            uniq_rows=uniq_p,
            inverse=inv_p,
            segments=seg_p,
            labels=self._labels[indices],
            dense=self._dense[indices] if self._dense is not None else None,
            n_keys=L,
            n_uniq=U,
        )

    def close(self) -> None:
        """Free every native scratch handle this packer spawned, including
        those made inside prefetch worker threads."""
        with self._shape_lock:
            handles, self._all_native = self._all_native, []
        for p in handles:
            p.close()
        self._tls.packer = None
