"""Columnar sample records and ragged batches.

``SlotRecord`` mirrors the reference's compact sample representation
(SlotRecordObject + SlotValues{values, offsets}, data_feed.h:777-852): one
flat value array per type with per-slot offsets, instead of a vector of
per-slot vectors.

``SlotBatch`` is the batch-of-records columnar form the device consumes
(analog of the fused uint64/float tensors BuildSlotBatchGPU produces,
data_feed.cc:2404-2522): one flat key array in slot-major order plus a
``[n_slots, batch+1]`` offset matrix per type. All device-side sparse ops key
off this layout.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np

from paddlebox_tpu_torch.data.slot_schema import SlotSchema


@dataclass
class SlotRecord:
    """One sample: flat per-type values + per-slot offsets (len n_slots+1)."""

    u64_values: np.ndarray  # uint64 [total_u64]
    u64_offsets: np.ndarray  # uint32 [n_used_sparse + 1]
    f_values: np.ndarray  # float32 [total_f]
    f_offsets: np.ndarray  # uint32 [n_used_float + 1]
    ins_id: str = ""
    search_id: int = 0
    cmatch: int = 0
    rank: int = 0

    def slot_keys(self, slot_idx: int) -> np.ndarray:
        return self.u64_values[self.u64_offsets[slot_idx] : self.u64_offsets[slot_idx + 1]]

    def slot_floats(self, slot_idx: int) -> np.ndarray:
        return self.f_values[self.f_offsets[slot_idx] : self.f_offsets[slot_idx + 1]]


@dataclass
class SlotBatch:
    """Columnar ragged minibatch, slot-major.

    keys[k] for k in [offsets[s, i], offsets[s, i+1]) are the uint64 feasigns
    of slot s, instance i. Same shape contract for floats.
    """

    batch_size: int
    keys: np.ndarray  # uint64 [total_keys], slot-major then ins-major
    key_offsets: np.ndarray  # int32 [n_sparse, batch+1], per-slot prefix sums
    float_values: np.ndarray  # float32 [total_floats]
    float_offsets: np.ndarray  # int32 [n_float, batch+1]
    ins_ids: Optional[List[str]] = None
    search_ids: Optional[np.ndarray] = None  # uint64 [batch]
    cmatch: Optional[np.ndarray] = None  # int32 [batch]
    rank: Optional[np.ndarray] = None  # int32 [batch]
    rank_offset: Optional[np.ndarray] = None  # int32 [batch, max_rank*2+1] (pv-merged join phase)

    @property
    def num_sparse_slots(self) -> int:
        return self.key_offsets.shape[0]

    @property
    def num_float_slots(self) -> int:
        return self.float_offsets.shape[0]

    def slot_lengths(self) -> np.ndarray:
        """[n_sparse, batch] per-(slot, ins) key counts."""
        return np.diff(self.key_offsets, axis=1)

    def dense_float_matrix(self, slot_idx: int, dim: int) -> np.ndarray:
        """[batch, dim] view of a dense float slot (constant length == dim)."""
        off = self.float_offsets[slot_idx]
        lens = np.diff(off)
        if not np.all(lens == dim):
            out = np.zeros((self.batch_size, dim), dtype=np.float32)
            for i in range(self.batch_size):
                v = self.float_values[off[i] : off[i + 1]][:dim]
                out[i, : len(v)] = v
            return out
        start, stop = off[0], off[-1]
        return self.float_values[start:stop].reshape(self.batch_size, dim)

    def segment_ids(self) -> np.ndarray:
        """int32 [total_keys]: flat (slot * batch + ins) segment id per key.

        This is the host-precomputed analog of the reference's key2slot device
        array (FillKey2Slot, box_wrapper.cu): it drives device-side segment
        pooling with zero device bookkeeping.
        """
        n_slots, bp1 = self.key_offsets.shape
        lens = np.diff(self.key_offsets, axis=1).reshape(-1)  # [n_slots*batch]
        seg = np.repeat(np.arange(n_slots * (bp1 - 1), dtype=np.int32), lens)
        return seg


def _slot_major(values, offsets, n_slots: int, dtype):
    """Gather per-record, per-slot value ranges into one slot-major array.

    ``values[i]`` holds record i's flat values and ``offsets[i]`` its
    ``n_slots + 1`` slot boundaries. Returns (the values slot by slot, each
    slot's records in order; int32 [n_slots, batch + 1] global offsets).
    One vectorized gather instead of a copy a (record, slot)."""
    bs = len(values)
    offs = np.stack(offsets).astype(np.int64).reshape(bs, n_slots + 1)
    lens = np.diff(offs, axis=1).T  # [n_slots, batch]
    rec_base = np.concatenate([[0], np.cumsum([len(v) for v in values])[:-1]]).astype(np.int64)
    starts = (rec_base[None, :] + offs[:, :-1].T).reshape(-1)
    flat_lens = lens.reshape(-1)
    total = int(flat_lens.sum())
    flat = np.concatenate(values).astype(dtype, copy=False)
    idx = np.arange(total, dtype=np.int64) + np.repeat(starts - (np.cumsum(flat_lens) - flat_lens), flat_lens)
    out_offsets = np.zeros((n_slots, bs + 1), dtype=np.int64)
    np.cumsum(lens, axis=1, out=out_offsets[:, 1:])
    slot_base = np.concatenate([[0], np.cumsum(out_offsets[:, -1])[:-1]]).astype(np.int64)
    out_offsets += slot_base[:, None]
    return flat[idx], out_offsets.astype(np.int32)


def build_batch(records: Sequence[SlotRecord], schema: SlotSchema) -> SlotBatch:
    """Concatenate records into a slot-major columnar batch.

    Analog of PutToFeedVec/BuildSlotBatchGPU (data_feed.cc:2404-2522) minus the
    device copy — pure host numpy; device upload happens in the packer.
    """
    bs = len(records)
    ns, nf = schema.num_sparse, schema.num_float
    if bs:
        keys, key_offsets = _slot_major(
            [r.u64_values for r in records], [r.u64_offsets for r in records], ns, np.uint64
        )
        floats, float_offsets = _slot_major(
            [r.f_values for r in records], [r.f_offsets for r in records], nf, np.float32
        )
    else:
        keys, floats = np.empty(0, dtype=np.uint64), np.empty(0, dtype=np.float32)
        key_offsets = np.zeros((ns, 1), dtype=np.int32)
        float_offsets = np.zeros((nf, 1), dtype=np.int32)

    has_meta = schema.parse_ins_id or schema.parse_logkey
    return SlotBatch(
        batch_size=bs,
        keys=keys,
        key_offsets=key_offsets,
        float_values=floats,
        float_offsets=float_offsets,
        ins_ids=[r.ins_id for r in records] if has_meta else None,
        search_ids=np.array([r.search_id for r in records], dtype=np.uint64) if has_meta else None,
        cmatch=np.array([r.cmatch for r in records], dtype=np.int32) if has_meta else None,
        rank=np.array([r.rank for r in records], dtype=np.int32) if has_meta else None,
    )
