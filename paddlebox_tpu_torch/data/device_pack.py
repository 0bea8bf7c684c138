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

On a mesh (``pack_batch_sharded``, ``BatchPacker.pack_sharded``) the
global batch splits over the ranks (record ``i`` goes to rank ``i // b``)
and each rank's unique rows are bucketed by owner shard into
``req_ranks`` [n_dev, n_shards, K] (the row within the shard), so the
device side is ``all_to_all`` + gather (``parallel/sharded_pullpush.py``).
On one host every rank packs the whole global batch and keeps its
block; over several hosts each rank packs only its own batch
(``n_devices`` 1), the global batch being the hosts' blocks in rank
order, and ``freeze_shapes(transport=)`` all-reduces the pads.
``BatchPacker`` freezes K from an exact scan of the pass's partition
(``freeze_shapes(n_devices=)``, :func:`block_pad_stats`) before its
prefetch threads start, so K is the same on every rank, whichever batch
a thread finishes first, with no collective. With the adaptive mesh
wire engaged each bucket is ordered hot rows first (the working set's
``hot_rows``); hot rows past the bucket's bf16 slots count under
``wire.ici_hot_overflow_keys``. :func:`route_serve_requests` buckets the
device scoring tier's hit keys the same way (``serve/scoring_table.py``).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from paddlebox_tpu_torch import config
from paddlebox_tpu_torch.data.slot_record import SlotBatch
from paddlebox_tpu_torch.data.slot_schema import SlotSchema
from paddlebox_tpu_torch.ops import wire_quant
from paddlebox_tpu_torch.table.sparse_table import PassWorkingSet
from paddlebox_tpu_torch.utils.faultinject import InjectedFault
from paddlebox_tpu_torch.utils.faultinject import fire as _fault_fire
from paddlebox_tpu_torch.utils.monitor import STAT_ADD


def _round_bucket(n: int, quantum: int) -> int:
    return max(quantum, -(-n // quantum) * quantum)


def block_pad_stats(rows, u64_base, key_counts, slices, cap: int, ns: int):
    """Per index slice of a pass's records: (key count L, most unique rows
    that fall in one of ``ns`` shards of ``cap`` rows), int64 [n] each,
    over the pass's resolved ``rows``. One native ``pbx_block_stats``
    sweep when ``enable_native_parser`` is on and the slices are of one
    length, else numpy (the same numbers)."""
    if not len(slices):
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    if config.get_flag("enable_native_parser") and len({len(s) for s in slices}) == 1:
        from paddlebox_tpu_torch.utils import native

        blocks = np.stack([np.asarray(s, dtype=np.int64) for s in slices])
        return native.block_stats(rows, u64_base, key_counts, blocks, cap, ns)
    from paddlebox_tpu_torch.data.record_store import _ragged_indices

    L = np.zeros(len(slices), np.int64)
    bmax = np.zeros(len(slices), np.int64)
    for i, sl in enumerate(slices):
        sl = np.asarray(sl, dtype=np.int64)
        r = rows[_ragged_indices(u64_base[sl], key_counts[sl])]
        L[i] = len(r)
        if len(r):
            bmax[i] = int(np.bincount(np.unique(r) // cap, minlength=ns).max())
    return L, bmax


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



@dataclass
class ShardedDeviceBatch:
    """Static-shape arrays of the mesh step; axis 0 = rank.

    ``req_ranks[d, s]`` is the bucket of rows rank d asks of shard s (pads
    -> ``cap - 1``, the padding row); ``inverse[d]`` maps rank d's flat
    keys to bucket positions ``s*K + j``. Slot K-1 of every bucket is a
    pad, so pad keys point at position K-1 (shard 0's)."""

    local_batch: int
    num_slots: int
    req_ranks: np.ndarray  # int32 [n_dev, n_shards, K]
    inverse: np.ndarray  # int32 [n_dev, L_pad] flat key -> bucket pos
    segments: np.ndarray  # int32 [n_dev, L_pad]; pads -> S*local_batch
    labels: np.ndarray  # f32 [n_dev, local_batch]
    dense: Optional[np.ndarray]  # f32 [n_dev, local_batch, dense_dim]

    def as_dict(self) -> Dict[str, np.ndarray]:
        d = {
            "req_ranks": self.req_ranks,
            "inverse": self.inverse,
            "segments": self.segments,
            "labels": self.labels,
        }
        if self.dense is not None:
            d["dense"] = self.dense
        return d


def _route_sharded(
    rows: np.ndarray,
    segments: np.ndarray,
    B: int,
    S: int,
    ws: PassWorkingSet,
    n_devices: int,
    bucket: int,
    labels: np.ndarray,
    dense: Optional[np.ndarray],
    dense_dim: int,
    k_floor: int = 0,
    l_floor: int = 0,
) -> ShardedDeviceBatch:
    """Flat (rows, segments) of a global batch -> per-rank buckets.

    ``k_floor`` / ``l_floor`` keep the pads sticky across a pass's batches;
    ``k_floor == -1`` asks for first-batch headroom (25%) on K."""
    ns = ws.n_mesh_shards
    if ns % n_devices:
        raise ValueError(f"{ns} working-set mesh shards not divisible by {n_devices} packed devices")
    if B % n_devices:
        raise ValueError(f"batch {B} not divisible by {n_devices} devices")
    b = B // n_devices
    cap = ws.capacity
    ins = segments % B
    slot = segments // B
    dev = ins // b

    # hot-first buckets for the adaptive wire: the device side decides
    # precision by slot index alone, so this order IS the hot/cold split
    hot_rows = getattr(ws, "hot_rows", None)
    if hot_rows is not None:
        try:
            _fault_fire("wire.ici_pack")
        except InjectedFault:
            # this batch keeps the plain order: hot keys ride int8
            STAT_ADD("wire.ici_pack_errors", 1)
            hot_rows = None

    per_dev = []  # (uniq_rows, inverse, local_segments) per rank
    max_L = 1
    max_bucket = 1
    for d in range(n_devices):
        sel = np.nonzero(dev == d)[0]
        uniq, inv = np.unique(rows[sel], return_inverse=True)
        local_seg = slot[sel] * b + (ins[sel] - d * b)
        per_dev.append((uniq, inv, local_seg))
        max_L = max(max_L, len(sel))
        if len(uniq):
            counts = np.bincount(uniq // cap, minlength=ns)
            max_bucket = max(max_bucket, int(counts.max()))

    # K-1 is always a pad slot; L_pad and K are the same for every rank
    if k_floor == -1:
        K = _round_bucket(max_bucket + 1 + max(bucket, max_bucket // 4), bucket)
    else:
        K = max(_round_bucket(max_bucket + 1, bucket), k_floor)
    L_pad = max(_round_bucket(max_L, bucket), l_floor)

    req_ranks = np.full((n_devices, ns, K), cap - 1, dtype=np.int32)
    inverse = np.full((n_devices, L_pad), K - 1, dtype=np.int32)
    seg_out = np.full((n_devices, L_pad), S * b, dtype=np.int32)

    hot_overflow = 0
    H = wire_quant.ici_hot_slots(K) if hot_rows is not None else 0
    for d, (uniq, inv, local_seg) in enumerate(per_dev):
        shard_of = (uniq // cap).astype(np.int64)
        rank_of = (uniq % cap).astype(np.int64)
        if hot_rows is not None and len(uniq):
            # lexsort's LAST key is primary: by owner shard, hot first
            cold = ~hot_rows[uniq]
            order = np.lexsort((cold, shard_of))
            per_shard_hot = np.bincount(shard_of[~cold], minlength=ns)
            hot_overflow += int(np.maximum(per_shard_hot - H, 0).sum())
        else:
            order = np.argsort(shard_of, kind="stable")
        counts = np.bincount(shard_of, minlength=ns)
        # bucket position of each unique row: owner_shard*K + slot
        pos_in_bucket = np.empty(len(uniq), dtype=np.int64)
        start = 0
        for s in range(ns):
            c = int(counts[s])
            req_ranks[d, s, :c] = rank_of[order[start : start + c]]
            pos_in_bucket[order[start : start + c]] = s * K + np.arange(c)
            start += c
        inverse[d, : len(inv)] = pos_in_bucket[inv]
        seg_out[d, : len(local_seg)] = local_seg

    if hot_rows is not None and hot_overflow:
        # hot keys past the bf16 slots ride int8 this batch
        STAT_ADD("wire.ici_hot_overflow_keys", hot_overflow)

    labels = labels.reshape(n_devices, b)
    if dense is not None:
        dense = dense.reshape(n_devices, b, dense_dim)
    return ShardedDeviceBatch(
        local_batch=b,
        num_slots=S,
        req_ranks=req_ranks,
        inverse=inverse,
        segments=seg_out,
        labels=labels,
        dense=dense,
    )


def route_serve_requests(
    owner: np.ndarray,
    local_rank: np.ndarray,
    n_devices: int,
    bucket: int,
    pad_rank: int,
):
    """Serve-tier hit keys -> static sharded-pull request buckets.

    ``owner[i]`` is the shard holding hit key i, ``local_rank[i]`` its row
    within that shard's block. Keys split round-robin over the
    ``n_devices`` requesters (one request exercises every shard's card),
    then bucket per owner shard as :func:`_route_sharded` does: K rounds to
    ``bucket`` (a bounded family of shapes) and slot K-1 of every bucket is
    padding (``pad_rank``, the tier's zero row).

    Returns ``(req_ranks int32 [n_dev, n_dev, K], pos int64 [m], K)``:
    ``pos[i]`` is key i's flat row in the pulled ``[n_dev, n_dev*K, width]``
    output (requester-major, then bucket position s*K + j)."""
    m = len(owner)
    if m == 0:
        K = bucket
        req = np.full((n_devices, n_devices, K), pad_rank, dtype=np.int32)
        return req, np.zeros(0, dtype=np.int64), K
    dev = np.arange(m, dtype=np.int64) % n_devices
    grp = dev * n_devices + owner
    order = np.argsort(grp, kind="stable")
    counts = np.bincount(grp, minlength=n_devices * n_devices)
    K = max(_round_bucket(int(counts.max()) + 1, bucket), bucket)
    starts = np.concatenate([[0], np.cumsum(counts)])
    slot = np.arange(m, dtype=np.int64) - starts[grp[order]]
    req = np.full((n_devices, n_devices, K), pad_rank, dtype=np.int32)
    req[dev[order], owner[order], slot] = local_rank[order]
    pos = np.empty(m, dtype=np.int64)
    pos[order] = dev[order] * (n_devices * K) + owner[order] * K + slot
    return req, pos, K


def pack_batch_sharded(
    batch: SlotBatch,
    ws: PassWorkingSet,
    schema: SlotSchema,
    n_devices: int,
    dense_slot: Optional[str] = None,
    dense_dim: int = 0,
    label_slot: Optional[str] = None,
    bucket: Optional[int] = None,
    k_floor: int = 0,
    l_floor: int = 0,
) -> ShardedDeviceBatch:
    """Split a global batch over the mesh and bucket its keys by owner
    shard (the per-GPU split of data_set.cc:2155-2192 plus the host half
    of the key routing PullSparseGPU does inside). ``n_devices`` must
    divide the working set's shard count and the batch size."""
    bucket = bucket or config.get_flag("batch_bucket_rounding")
    rows = ws.lookup(batch.keys)  # int32 [L] global rows (shard*cap + rank)
    segments = batch.segment_ids()  # int32 [L] slot*B + ins
    labels, dense = _extract_labels_dense(batch, schema, label_slot, dense_slot, dense_dim)
    return _route_sharded(
        rows, segments, batch.batch_size, batch.num_sparse_slots, ws, n_devices, bucket,
        labels, dense, dense_dim, k_floor=k_floor, l_floor=l_floor,
    )

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
        self._L_pad = 0  # guarded-by: _shape_lock (per rank on a mesh)
        self._U_pad = 0  # guarded-by: _shape_lock
        self._K_pad = 0  # guarded-by: _shape_lock (the mesh's bucket size)
        # every native handle spawned, in any thread, for close()
        self._all_native: list = []  # guarded-by: _shape_lock

    def freeze_shapes(self, batch_indices, n_devices: int = 0, transport=None) -> None:
        """Fix L_pad for a whole pass up front: every batch's key count is
        known exactly from the record key counts. Call with the pass's
        batch partition before the first pack.

        With ``n_devices`` (the mesh feed) L is a rank's, and K, the
        request bucket of one (rank, shard), is frozen too, from the exact
        unique-row counts of every rank's block (:func:`block_pad_stats`,
        the resident feed's ``ensure_sharded`` scan). Every rank freezes
        the same partition in the same order, so K is the same on every
        rank: ``all_to_all``'s equal splits need that, and a K that grew
        as prefetch threads finished would differ by thread timing.

        Over several hosts (a ``transport`` of more than one rank) each
        host freezes its own partition, and L and K are all-reduced (max)
        over the transport (``freeze-L``, ``freeze-K``), so every host packs
        the same shapes and the mesh's collectives never see mismatched
        ones (lockstep parity, compute_thread_batch_nccl
        data_set.cc:2069-2135)."""
        lockstep = transport is not None and transport.n_ranks > 1
        max_L = 1
        if not n_devices:
            for idx in batch_indices:
                max_L = max(max_L, int(self._key_counts[np.asarray(idx)].sum()))
            if lockstep:
                max_L = transport.allreduce_max(max_L, "freeze-L")
            with self._shape_lock:
                self._L_pad = max(self._L_pad, _round_bucket(max_L, self.bucket))
            return
        slices = []
        for idx in batch_indices:
            idx = np.asarray(idx, dtype=np.int64)
            if len(idx) % n_devices:
                raise ValueError(f"batch of {len(idx)} records not divisible by {n_devices} devices")
            b = len(idx) // n_devices
            slices += [idx[d * b : (d + 1) * b] for d in range(n_devices)]
        L, bmax = block_pad_stats(
            self._rows, self.store.u64_base, self._key_counts, slices, self.ws.capacity, self.ws.n_mesh_shards
        )
        max_L = max(max_L, int(L.max(initial=0)))
        # _route_sharded's own floor: one row a bucket, plus the pad slot
        max_bucket = max(1, int(bmax.max(initial=0)))
        if lockstep:
            max_L = transport.allreduce_max(max_L, "freeze-L")
            max_bucket = transport.allreduce_max(max_bucket + 1, "freeze-K") - 1
        with self._shape_lock:
            self._L_pad = max(self._L_pad, _round_bucket(max_L, self.bucket))
            self._K_pad = max(self._K_pad, _round_bucket(max_bucket + 1, self.bucket))

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

    def pack_sharded(self, indices: np.ndarray, n_devices: int) -> ShardedDeviceBatch:
        """Batch of store records ``indices`` -> mesh-routed
        ShardedDeviceBatch (the native gather, then the routing) at the
        frozen K and L. Raises before ``freeze_shapes(n_devices=)``, and
        on a batch that needs more than the frozen pads: a batch outside
        the frozen partition must not grow K on one rank alone."""
        with self._shape_lock:
            K, L_pad = self._K_pad, self._L_pad
        if not K:
            raise RuntimeError("pack_sharded before freeze_shapes(n_devices=): K would differ by rank")
        uniq, inverse, segments, L = self._gather_flat(indices)
        rows = uniq[inverse] if len(uniq) else np.zeros(0, np.int32)
        out = _route_sharded(
            rows, segments, len(indices), self.store.n_sparse, self.ws, n_devices, self.bucket,
            self._labels[indices], self._dense[indices] if self._dense is not None else None,
            self.dense_dim, k_floor=K, l_floor=L_pad,
        )
        if out.req_ranks.shape[2] != K or out.inverse.shape[1] != L_pad:
            raise RuntimeError(
                f"batch needs K={out.req_ranks.shape[2]}, L={out.inverse.shape[1]} past the frozen "
                f"K={K}, L={L_pad}: freeze_shapes(n_devices=) with a partition that holds it"
            )
        return out

    def close(self) -> None:
        """Free every native scratch handle this packer spawned, including
        those made inside prefetch worker threads."""
        with self._shape_lock:
            handles, self._all_native = self._all_native, []
        for p in handles:
            p.close()
        self._tls.packer = None
