"""Device-resident pass feed: upload the pass once, feed only indices.

Port of the JAX package's ``train/resident_step.py``, single device. The
pass is immutable once ``begin_pass`` has run (PadBoxSlotDataset keeps
``input_records_`` frozen for the pass, data_set.cc:1628-1683), so its
row-resolved key stream lives on the device for the pass:

- **Upload once per pass** (:class:`ResidentPass`): the flat row id of
  every key of every record (``rows``, int32), per-record per-slot key
  counts (``counts``, uint8) and each record's first key (``base``), or
  the full offset matrix ``off`` when a slot holds more than 255 keys; the
  labels and optional dense features.
- **Per batch**: the feed is one [B] record-index vector, sliced on the
  device from the pass's index partition, itself uploaded once.
  :func:`build_device_batch` rebuilds the batch there: a ragged gather by
  cumsum + searchsorted, then the cross-slot dedup by a stable sort and a
  first-occurrence scan (DedupKeysAndFillIdx parity,
  box_wrapper_impl.h:103). Every shape is fixed by the pass's ``L_pad``
  and ``U_pad``, and nothing in it reads a value back to the host: no
  ``.item()``, no ``nonzero``, no boolean-mask indexing, no
  ``torch.unique``.
- **Superstep** (:func:`make_resident_superstep`, the one factory): K
  batches per call, a plain loop over the ported ``make_train_step`` (or
  its eval step) where the JAX package runs ``lax.scan``; the metrics come
  back stacked along a leading K axis.
- **Join phase** (:class:`ResidentPvFeed`, the superstep's ``pv_feed=``):
  the pass's ``PvPlan`` (record indices, rank matrices, ghost weights) is
  uploaded once, and a dispatch takes a [K] slice of a device-resident
  ``arange`` of batch positions.
- **Pass scope** (:class:`ResidentFeed`): one holder per (store, working
  set) keeps the ``ResidentPass``, the index partition it uploaded, the
  join phase's feed and the supersteps built over them.

The arrays a batch gets are those ``BatchPacker.pack`` ships from the host
(slot-major flat order, pads -> padding row / ``U_pad - 1`` / the ``S*B``
trash segment) but for the order of the unique rows: sorted here, first
occurrence there. The step's merge takes the keys in stable order of
``inverse`` (here the builder's own sort, ``merge_order``), so each row's
gradient sums the same keys in the same flat order either way, and the
trained state is the same bits.

On a single-host mesh (:func:`ensure_sharded`,
:func:`build_mesh_device_batch`, the superstep's ``plan=``) every rank holds the same resident arrays (its dataset is a replica) and
builds its own route buckets on its card from its slice of each global
batch, then runs the same per-rank body as the host-packed mesh feeds
(``train/sharded_step.py``). The join phase's mesh tier
(``ResidentPvFeed(plan, device, mesh_plan=)``) uploads only this rank's
block of a plan built for ``n_devices = world`` and builds the rank's
batch from it the same way.

Over several hosts (a ``ResidentPass`` built with ``plan=`` and a
``transport=`` of more than one rank: ``per_device``) every rank holds a
DIFFERENT pass, its host's records; the port runs one process a card, so
each card carries its own host's arrays, the per-device copies of the
JAX package's multi-host feed. Their sizes (``res-L-size``,
``res-N-size``) and their representation (``res-rep``) are all-reduced
over the transport so every host builds the same shapes, and
``ensure_sharded`` all-reduces the pads (``res-L:<n>``, ``res-K:<n>``).
A batch is then the rank's own [b] records (its block of the global
batch, which is the hosts' blocks in rank order), and a pv plan is built
for one device (``ResidentPvFeed(multi_host=True)``).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from paddlebox_tpu_torch import config
from paddlebox_tpu_torch.data.device_pack import _round_bucket, block_pad_stats
from paddlebox_tpu_torch.train.train_step import TrainStepConfig, make_train_step

config.define_flag(
    "enable_resident_feed",
    1,
    "keep the pass's row stream resident on the device and feed only "
    "record indices per batch (0 = host-packed batches)",
)
config.define_flag(
    "resident_scan_batches",
    8,
    "minibatches per dispatched superstep; higher amortizes the dispatch, "
    "lower returns metrics sooner",
)


# keys the resident steps dispatched on one device have pooled since the
# process started, counted on the host from the pass's key counts (no
# device read); like models/layers.padded_products
pooled_keys = 0


class ResidentPass:
    """Pass-scoped device arrays + frozen pad shapes for the resident feed.

    Built once per (store, working set), about 8 bytes per key on the
    device. ``ensure`` grows the frozen pads to cover a batch partition
    (sticky, like ``BatchPacker.freeze_shapes``)."""

    def __init__(
        self,
        store,  # ColumnarRecords
        ws,  # PassWorkingSet (finalized)
        schema,
        device: torch.device,
        dense_slot: Optional[str] = None,
        dense_dim: int = 0,
        label_slot: Optional[str] = None,
        bucket: Optional[int] = None,
        plan=None,  # MeshPlan: needed only over several hosts
        transport=None,  # the host plane: lockstep over several hosts
    ):
        self.store = store
        self.ws = ws
        self.device = device
        self.num_slots = store.n_sparse
        self.bucket = bucket or config.get_flag("batch_bucket_rounding")
        self.n_table_rows = ws.n_mesh_shards * ws.capacity
        self.pad_row = self.n_table_rows - 1
        if len(store.u64_values) >= (1 << 31):  # int32 offsets into the stream
            raise ValueError("pass too large for the resident feed (>= 2^31 keys)")
        rows = store.resolve_rows(ws)
        self._host_rows = rows
        self._key_counts = store.key_counts()
        self.transport = transport
        # over several hosts every rank holds its own host's pass, padded
        # to the sizes all-reduced over the transport
        self.per_device = plan is not None and transport is not None and transport.n_ranks > 1
        self._seq = 0  # ensure_sharded's lockstep round counter
        if self.per_device:
            L_max = transport.allreduce_max(len(rows), "res-L-size")
            N_max = transport.allreduce_max(len(store), "res-N-size")
        else:
            L_max, N_max = len(rows), len(store)

        def put(a: np.ndarray, n: int) -> torch.Tensor:
            if a.shape[0] != n:  # the lockstep pad: rows no batch reads
                a = np.concatenate([a, np.zeros((n - a.shape[0],) + a.shape[1:], a.dtype)])
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        self.rows = put(rows.astype(np.int32), L_max)
        # per-slot counts fit uint8 in CTR data: [N, S] bytes + an [N] int32
        # base instead of an [N, S+1] int32 offset matrix, rebuilt per batch
        # by a cumsum on the device
        slot_counts = np.diff(store.u64_offsets.astype(np.int64), axis=1)
        compact = bool(slot_counts.size and slot_counts.max() <= 255)
        if self.per_device:
            # one representation on every host
            compact = transport.allreduce_max(0 if compact else 1, "res-rep") == 0
        if compact:
            self.base = put(store.u64_base.astype(np.int32), N_max)
            self.counts = put(slot_counts.astype(np.uint8), N_max)
            self.off = None
        else:
            off = store.u64_base[:, None] + store.u64_offsets.astype(np.int64)
            self.base = self.counts = None
            self.off = put(off.astype(np.int32), N_max)  # [N, S+1]
        label_name = label_slot or schema.label_slot
        if label_name is not None:
            labels = store.float_slot_matrix(schema.float_slot_index(label_name), 1)[:, 0]
        else:
            labels = np.zeros(len(store), np.float32)
        self.labels = put(labels.astype(np.float32), N_max)
        self.dense = None
        if dense_slot is not None and dense_dim:
            di = schema.float_slot_index(dense_slot)
            self.dense = put(np.asarray(store.float_slot_matrix(di, dense_dim), np.float32), N_max)
        self._logkey_cols = None  # (cmatch, rank) on the device, uploaded on first use
        self.L_pad = 0
        self.U_pad = 0
        self.K_pad = 0  # the mesh's request-bucket size (ensure_sharded)
        self.block_keys: List[int] = []  # keys of each block of the last ``ensure``
        # unique-row count per index block, keyed by the block's bytes (a
        # hash collision would freeze U_pad too small)
        self._uniq_cache: Dict[bytes, int] = {}
        # (key count, most unique rows of one shard) per (rank, block bytes)
        self._mesh_cache: Dict[tuple, tuple] = {}

    def logkey_columns(self):
        """(cmatch, rank) of every record, int32 [N] each, on the device:
        uploaded once, so a metric registry's per-batch inputs are device
        slices and never a host copy."""
        if self._logkey_cols is None:
            self._logkey_cols = tuple(
                torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(self.device)
                for a in (self.store.cmatch, self.store.rank)
            )
        return self._logkey_cols

    def ensure(self, batch_indices) -> None:
        """Freeze/grow L_pad and U_pad to cover every batch of the
        partition: exact per-batch key and unique-row counts, cached per
        index block; the key counts stay in ``block_keys``, in order.
        Uncached blocks go through one native sweep (``pbx_block_stats``)
        when ``enable_native_parser`` is on and the blocks are of one
        length, else numpy."""
        blocks = [np.asarray(idx) for idx in batch_indices]
        fps = [b.tobytes() for b in blocks]
        pending, seen = [], set()
        for b, fp in zip(blocks, fps):
            if fp not in self._uniq_cache and fp not in seen:
                pending.append((fp, b))
                seen.add(fp)
        if pending:
            _, uniq = block_pad_stats(
                self._host_rows, self.store.u64_base, self._key_counts,
                [b for _, b in pending], self.n_table_rows, 1,
            )
            for (fp, _), U in zip(pending, uniq):
                self._uniq_cache[fp] = max(int(U), 1)
        self.block_keys = [int(self._key_counts[b].sum()) for b in blocks]
        max_L = max([1, *self.block_keys])
        max_U = max([1, *(self._uniq_cache[fp] for fp in fps)])
        self.L_pad = max(self.L_pad, _round_bucket(max_L, self.bucket))
        # +1 keeps a slot for the invalid tail even at the unique maximum
        self.U_pad = max(self.U_pad, _round_bucket(max_U + 1, self.bucket))


def count_pooled(rp: ResidentPass, first: int, n: int) -> None:
    """Add the keys of blocks ``first .. first + n`` of the partition
    ``rp.ensure`` saw last to :data:`pooled_keys`."""
    global pooled_keys
    pooled_keys += sum(rp.block_keys[first : first + n])


def _batch_offsets(rp: ResidentPass, idx: torch.Tensor) -> torch.Tensor:
    """[B, S+1] int32 absolute offsets into the flat row stream for a
    batch, from the full matrix or from base + uint8 counts."""
    if rp.off is not None:
        return rp.off.index_select(0, idx)
    c = rp.counts.index_select(0, idx).to(torch.int32)  # [B, S]
    cum = torch.cumsum(c, dim=1, dtype=torch.int32)
    zero = torch.zeros((cum.shape[0], 1), dtype=torch.int32, device=cum.device)
    return rp.base.index_select(0, idx)[:, None] + torch.cat([zero, cum], dim=1)


def _dedup_rows(rp: ResidentPass, cfg: TrainStepConfig, idx: torch.Tensor):
    """The dedup under both batch builders, in fixed shapes: [B] record
    indices (int64) -> ``(segments, sorted_rows, perm, real, first, seq)``,
    each [rp.L_pad].

    A ragged gather by cumsum + searchsorted lays the batch's rows out in
    slot-major flat order, the invalid tail keyed ``rp.n_table_rows`` (past
    every row) in the trash segment ``S*B``; a stable sort orders them
    (``perm``), ``real`` marks the valid ones, ``first`` each row's first
    occurrence and ``seq`` numbers those from 0 by a cumsum (int32)."""
    S, B, inf = cfg.num_slots, cfg.batch_size, rp.n_table_rows
    off_b = _batch_offsets(rp, idx)
    lens_flat = (off_b[:, 1:] - off_b[:, :-1]).T.reshape(-1)  # [S*B] slot-major
    starts_flat = off_b[:, :-1].T.reshape(-1)
    cum = torch.cumsum(lens_flat, dim=0, dtype=torch.int32)
    pos = torch.arange(rp.L_pad, dtype=torch.int32, device=idx.device)
    seg_c = torch.clamp(torch.searchsorted(cum, pos, right=True, out_int32=True), max=S * B - 1)
    within = pos - (cum.index_select(0, seg_c) - lens_flat.index_select(0, seg_c))
    src = torch.clamp(starts_flat.index_select(0, seg_c) + within, 0, rp.rows.shape[0] - 1)
    valid = pos < cum[-1]
    rows_flat = torch.where(valid, rp.rows.index_select(0, src), inf)
    segments = torch.where(valid, seg_c, S * B)  # seg_c IS slot*B + ins
    sorted_rows, perm = torch.sort(rows_flat, stable=True)
    real = sorted_rows < inf
    first = torch.cat(
        [torch.ones((1,), dtype=torch.bool, device=idx.device), sorted_rows[1:] != sorted_rows[:-1]]
    ) & real
    seq = torch.cumsum(first.to(torch.int32), dim=0, dtype=torch.int32) - 1
    return segments, sorted_rows, perm, real, first, seq


def build_device_batch(
    rp: ResidentPass, cfg: TrainStepConfig, idx: torch.Tensor
) -> Dict[str, torch.Tensor]:
    """[B] record indices on the device -> the step's batch dict, built on
    the device with shapes fixed by ``rp.L_pad`` and ``rp.U_pad``.

    The unique rows are numbered by :func:`_dedup_rows`. ``uniq_rows`` is a
    scatter of each first occurrence to its number, every other position
    going to the ``U_pad - 1`` slot with the padding row, so all writes to
    one index carry the same value; ``inverse`` is a scatter over ``perm``,
    a permutation. ``merge_order`` is ``perm`` and ``merge_offsets``
    [U_pad + 1] int32 where each unique row's keys start in it: the push
    merge's order, so the step sorts nothing a second time."""
    L_pad, U_pad = rp.L_pad, rp.U_pad
    idx = idx.long()
    segments, sorted_rows, perm, real, first, seq = _dedup_rows(rp, cfg, idx)
    segid = torch.where(real, torch.clamp(seq, max=U_pad - 1), U_pad - 1)
    # U_pad > the most unique rows of any batch, so no first occurrence
    # lands on U_pad - 1
    uniq_rows = torch.full((U_pad,), rp.pad_row, dtype=torch.int32, device=idx.device).scatter_(
        0, torch.where(first, segid, U_pad - 1).long(), torch.where(first, sorted_rows, rp.pad_row)
    )
    inverse = torch.empty((L_pad,), dtype=torch.int32, device=idx.device).scatter_(0, perm, segid)
    # perm is argsort(inverse, stable=True): it lists the keys by segid, and
    # each segid's keys in flat order; the push merge sums in that order
    bounds = torch.arange(U_pad + 1, dtype=torch.int32, device=idx.device)
    batch = {
        "uniq_rows": uniq_rows,
        "inverse": inverse,
        "segments": segments,
        "labels": rp.labels.index_select(0, idx),
        "merge_order": perm,
        "merge_offsets": torch.searchsorted(segid, bounds, out_int32=True),
    }
    if rp.dense is not None:
        batch["dense"] = rp.dense.index_select(0, idx)
    return batch


# ---- mesh (single-host) resident tier --------------------------------------


def ensure_sharded(rp: ResidentPass, batch_indices, n_devices: int) -> None:
    """Freeze/grow the mesh pads over a batch partition: the per-rank
    L_pad and the per-(rank, shard) request bucket K_pad, from the exact
    counts of every rank's block (cached per block). Uncached blocks go
    through one native ``pbx_block_stats`` sweep with the mesh's shards
    when ``enable_native_parser`` is on and the blocks are of one length,
    else numpy."""
    cap, ns = rp.ws.capacity, rp.ws.n_mesh_shards
    work, pending, seen = [], [], set()
    for idx in batch_indices:
        idx = np.asarray(idx)
        if len(idx) % n_devices:
            raise ValueError(
                f"batch of {len(idx)} records not divisible by {n_devices} devices "
                "(the host packer's contract)"
            )
        b = len(idx) // n_devices
        for d in range(n_devices):
            sl = idx[d * b : (d + 1) * b]
            fp = (d, sl.tobytes())
            work.append(fp)
            if fp not in rp._mesh_cache and fp not in seen:
                pending.append((fp, sl))
                seen.add(fp)
    if pending:
        L, bmax = block_pad_stats(
            rp._host_rows, rp.store.u64_base, rp._key_counts, [sl for _, sl in pending], cap, ns
        )
        for (fp, _), n_keys, bm in zip(pending, L, bmax):
            rp._mesh_cache[fp] = (int(n_keys), int(bm))
    max_L, max_bucket = 1, 0
    for fp in work:
        L, bm = rp._mesh_cache[fp]
        max_L, max_bucket = max(max_L, L), max(max_bucket, bm)
    L = _round_bucket(max_L, rp.bucket)
    K = _round_bucket(max_bucket + 1, rp.bucket)
    tp = rp.transport
    if rp.per_device:
        # every host enters these rounds as often as the others (the
        # prepare and stepper call sequence is alike), tagged by the
        # ResidentPass's counter
        rp._seq += 1
        L = tp.allreduce_max(L, f"res-L:{rp._seq}")
        K = tp.allreduce_max(K, f"res-K:{rp._seq}")
    rp.L_pad = max(rp.L_pad, L)
    rp.K_pad = max(rp.K_pad, K)


def build_mesh_device_batch(
    rp: ResidentPass, cfg: TrainStepConfig, idx: torch.Tensor, ns: int, cap: int
) -> Dict[str, torch.Tensor]:
    """This rank's mesh batch (``req_ranks`` [ns, K], ``inverse``,
    ``segments``, ``labels``, ``dense``) built on the card from its [b]
    record indices: ``_route_sharded`` in fixed-shape ops. Global rows are
    shard-major (shard*cap + rank), so the sort by row groups them by
    owner; a first-occurrence scan numbers each shard's unique rows; pads
    ride in slot K-1 of shard 0, whose request is the padding row."""
    L_pad, K = rp.L_pad, rp.K_pad
    idx = idx.long()
    dev = idx.device
    # rp.n_table_rows (ns * cap) keys the invalid tail, sorted last
    segments, sorted_rows, perm, real, first, uniq_seq = _dedup_rows(rp, cfg, idx)
    shard = torch.where(real, sorted_rows // cap, 0)
    # unique rows a shard: an integer scatter-add, the same in any order
    cnts = torch.zeros((ns,), dtype=torch.int32, device=dev).scatter_add_(
        0, shard.long(), first.to(torch.int32)
    )
    shard_start = torch.cumsum(cnts, dim=0, dtype=torch.int32) - cnts
    j = torch.clamp(uniq_seq - shard_start.index_select(0, shard.long()), 0, K - 2)
    bucket_sorted = torch.where(real, shard * K + j, K - 1).to(torch.int32)
    inverse = torch.empty((L_pad,), dtype=torch.int32, device=dev).scatter_(0, perm, bucket_sorted)
    # one request a first occurrence; every other position writes the
    # spare slot ns*K, cut off after
    flat_pos = torch.where(first, shard * K + j, ns * K).long()
    req = torch.full((ns * K + 1,), cap - 1, dtype=torch.int32, device=dev).scatter_(
        0, flat_pos, torch.where(real, sorted_rows % cap, cap - 1).to(torch.int32)
    )
    out = {
        "req_ranks": req[: ns * K].reshape(ns, K),
        "inverse": inverse,
        "segments": segments,
        "labels": rp.labels.index_select(0, idx),
    }
    if rp.dense is not None:
        out["dense"] = rp.dense.index_select(0, idx)
    return out


# ---- resident pv (join-phase) tier -----------------------------------------


class ResidentPvFeed:
    """The pass's ``PvPlan`` on the device, uploaded once.

    Join-phase batches are fixed once ``preprocess_instance`` has grouped
    the pass, so a dispatch's feed is a [K] slice of ``positions`` (an
    ``arange`` of batch positions, itself on the device): no per-chunk
    upload, no host sync. ``idx`` [n_b, B] int32 record indices,
    ``rank_offset`` [n_b, B, 2R+1] int32, ``ins_weight`` [n_b, B] float32
    (0 on ghosts).

    With ``mesh_plan`` (a single-host mesh) the plan must be blocked for
    ``mesh_plan.world`` devices, and only this rank's block goes up:
    ``idx`` [n_b, b], ``rank_offset`` [n_b, b, 2R+1] (its rank matrices are
    block-local already) and ``ins_weight`` [n_b, b], on the plan's device,
    beside the global ``idx`` and ``ins_weight`` (``global_idx``,
    ``global_ins_weight``, [n_b, B]: a metric registry reads the whole
    batch; a few MB a pass). On one device those are ``idx`` and
    ``ins_weight``. Over several hosts (``multi_host``) the plan is this
    host's own, built for one device, and all of it is the rank's block."""

    def __init__(self, plan, device: torch.device, mesh_plan=None, multi_host: bool = False):
        idx, ro, w = plan.idx, plan.rank_offset, plan.ins_weight
        if mesh_plan is None or multi_host:
            if plan.n_devices != 1:
                raise ValueError(f"a PvPlan blocked for {plan.n_devices} devices needs a single-host mesh_plan=")
            if mesh_plan is not None:
                device = mesh_plan.device
            mesh_plan = None
        else:
            if plan.n_devices != mesh_plan.world:
                raise ValueError(f"PvPlan built for {plan.n_devices} devices, the mesh has {mesh_plan.world} ranks")
            device = mesh_plan.device
            n_b, B = idx.shape
            b = B // mesh_plan.world
            lo, hi = mesh_plan.rank * b, (mesh_plan.rank + 1) * b
            idx, ro, w = idx[:, lo:hi], ro[:, lo:hi], w[:, lo:hi]

        def put(a: np.ndarray, dtype) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(device)

        self.n_batches = plan.n_batches
        self.idx = put(idx, np.int32)
        self.rank_offset = put(ro, np.int32)
        self.ins_weight = put(w, np.float32)
        self.global_idx, self.global_ins_weight = self.idx, self.ins_weight
        if mesh_plan is not None:
            self.global_idx = put(plan.idx, np.int32)
            self.global_ins_weight = put(plan.ins_weight, np.float32)
        self.positions = torch.arange(self.n_batches, dtype=torch.int64, device=device)


def make_resident_superstep(
    model_apply: Callable,
    dense_opt,
    cfg: TrainStepConfig,
    rp: ResidentPass,
    eval_mode: bool = False,
    *,
    plan=None,
    pv_feed: Optional[ResidentPvFeed] = None,
) -> Callable:
    """Build ``superstep(state, block) -> (state, metrics)``.

    One call runs K full train steps (``eval_mode``: eval steps) in order,
    each on a batch built on the device; every metric comes back stacked
    along a leading K axis. ``block`` is [K, B] record indices, or with a
    ``pv_feed`` [K] positions into the resident plan, whose indices, rank
    matrices and weights are one ``index_select`` each a call (ghosts are
    ordinary repeated records whose weight 0 adds no loss, no show/clk and
    no AUC, as on the host-packed pv feeds).

    Without a mesh ``plan`` the step is the classic ``make_train_step`` on
    :func:`build_device_batch`: only the batch assembly is resident. With
    one (a single-host mesh) it is the host-packed mesh feeds' per-rank
    body (``make_local_mesh_step``) on :func:`build_mesh_device_batch`:
    ``block`` holds K GLOBAL batches (B = world * b record indices, record
    ``i`` to rank ``i // b``) and this rank builds its batch from its
    block. A pv feed, and a pass over several hosts (``rp.per_device``),
    hold the rank's own [b] already."""
    if plan is None:
        step = make_train_step(model_apply, cfg, dense_opt, eval_mode=eval_mode)

        def build(idx):
            return build_device_batch(rp, cfg, idx)

        own = slice(None)
    else:
        from paddlebox_tpu_torch.train.sharded_step import make_local_mesh_step

        step = make_local_mesh_step(model_apply, dense_opt, cfg, plan, eval_mode)
        ns, cap = rp.ws.n_mesh_shards, rp.ws.capacity

        def build(idx):
            return build_mesh_device_batch(rp, cfg, idx, ns, cap)

        b = cfg.batch_size
        blk = 0 if pv_feed is not None or rp.per_device else plan.rank
        own = slice(blk * b, (blk + 1) * b)

    def superstep(state, block: torch.Tensor):
        idx = block
        if pv_feed is not None:
            idx = pv_feed.idx.index_select(0, block)
            ro = pv_feed.rank_offset.index_select(0, block)
            w = pv_feed.ins_weight.index_select(0, block)
        ms = []
        for k in range(block.shape[0]):
            batch = build(idx[k, own])
            if pv_feed is not None:
                batch["ins_weight"] = w[k]
                batch["rank_offset"] = ro[k]
            state, m = step(state, batch)
            ms.append(m)
        return state, {key: torch.stack([m[key] for m in ms]) for key in ms[0]}

    return superstep


class ResidentFeed:
    """The resident feed's pass-scoped device state, for one (store,
    working set).

    ``rp`` is its :class:`ResidentPass`; ``index`` the index partition
    uploaded last ([n, B] int32 on ``rp.device``, see
    :meth:`index_partition`); ``pv_feed`` the :class:`ResidentPvFeed` of
    the join phase's current plan (:meth:`load_pv`); ``steps`` the
    supersteps built over them, one per ``(pv, eval_mode)``, so a pass
    that alternates training and eval builds each once. A trainer keeps
    one and drops it before building the next, so two passes' arrays never
    sit on the device together."""

    def __init__(self, rp: ResidentPass):
        self.rp = rp
        self.index: Optional[torch.Tensor] = None
        self._index_host: Optional[np.ndarray] = None
        self._pv_plan = None
        self.pv_feed: Optional[ResidentPvFeed] = None
        self.steps: Dict[tuple, Callable] = {}

    def share(self) -> "ResidentFeed":
        """A holder over the same device arrays with no supersteps, for
        another trainer: a superstep closes over its trainer's model,
        optimizer and config."""
        other = ResidentFeed(self.rp)
        other.index, other._index_host = self.index, self._index_host
        other._pv_plan, other.pv_feed = self._pv_plan, self.pv_feed
        return other

    def index_partition(self, blocks: List[np.ndarray]) -> None:
        """Put the partition's record indices on the device as ``index``,
        uploaded once: a later partition that is a prefix of the uploaded
        one (a warm-up slice of the timed partition) reuses its rows."""
        host = np.stack(blocks).astype(np.int32) if blocks else np.zeros((0, 0), np.int32)
        old = self._index_host
        if old is None or len(host) > len(old) or not np.array_equal(old[: len(host)], host):
            self.index = torch.from_numpy(host).to(self.rp.device)
            self._index_host = host

    def load_pv(self, plan, mesh_plan) -> None:
        """Put the join phase's ``PvPlan`` on the device as ``pv_feed``,
        once a plan. A new plan's arrays replace the old ones, which go
        first, and so do the supersteps built over them."""
        if plan is not self._pv_plan:
            self._pv_plan = self.pv_feed = None
            self.steps = {key: ss for key, ss in self.steps.items() if not key[0]}
            self.pv_feed = ResidentPvFeed(plan, self.rp.device, mesh_plan=mesh_plan, multi_host=self.rp.per_device)
            self._pv_plan = plan
