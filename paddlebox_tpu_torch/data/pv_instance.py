"""PV (page-view) instance merging and rank_offset construction.

Port of the JAX package's ``data/pv_instance.py``, whole and pure numpy
(the reference's join-phase machinery):

- ``PreprocessInstance`` sorts records by search_id and groups each query's
  ads into one ``SlotPvInstance`` (data_set.cc:1968-2009);
- ``PostprocessInstance`` restores the flat record list for the update phase;
- ``GetRankOffset`` builds the [ins, 2*max_rank+1] matrix rank_attention
  consumes (data_feed.cc:2531-2580): col 0 is the ad's own 1-based rank (-1
  if invalid), col 2m+1/2m+2 are the rank and batch row of the pv's ad with
  rank m+1. An ad is rank-valid iff its cmatch is in ``valid_cmatch`` and
  1 <= rank <= max_rank (the reference hard-codes cmatch 222/223).

Static shapes: the reference serves join batches of N whole pvs with a
data-dependent total ad count; here ``pack_pv_batches`` packs whole pvs
into fixed-size instance batches and pads the tail with weight-0 ghost
copies of the last real ad, so every step sees one shape. Ghosts add
nothing to the loss, the metrics or the per-key show/clk counts
(``ins_weight`` reaches the train step). ``PvPlan`` is the same packing
as index arrays, the form the packer and the resident feeds consume.
The multi-device blocking (``n_devices``) and the lockstep ghost batches
(``min_batches``) are ported too, for a mesh.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator, List, Sequence, Tuple

import numpy as np

from paddlebox_tpu_torch.data.slot_record import SlotRecord

DEFAULT_VALID_CMATCH = (222, 223)


@dataclass
class PvInstance:
    """One page view: the ads served for one search_id (SlotPvInstance)."""

    search_id: int
    ads: List[SlotRecord] = field(default_factory=list)

    def merge_instance(self, rec: SlotRecord) -> None:
        self.ads.append(rec)


def merge_pv_instances(
    records: Sequence[SlotRecord], sort: bool = True
) -> List[PvInstance]:
    """Group records into pv instances by search_id (PreprocessInstance).

    ``sort=True`` mirrors the reference's stable sort by search_id so a
    query's ads land together even after a global shuffle.
    """
    if sort:
        records = sorted(records, key=lambda r: r.search_id)
    pvs: List[PvInstance] = []
    for rec in records:
        if pvs and pvs[-1].search_id == rec.search_id:
            pvs[-1].merge_instance(rec)
        else:
            pvs.append(PvInstance(search_id=rec.search_id, ads=[rec]))
    return pvs


def flatten_pv_instances(pvs: Sequence[PvInstance]) -> List[SlotRecord]:
    """Back to the flat record list (PostprocessInstance parity)."""
    out: List[SlotRecord] = []
    for pv in pvs:
        out.extend(pv.ads)
    return out


def _ad_rank(rec: SlotRecord, max_rank: int, valid_cmatch) -> int:
    if rec.cmatch in valid_cmatch and 1 <= rec.rank <= max_rank:
        return rec.rank
    return -1


def build_rank_offset(
    pvs: Sequence[PvInstance],
    ins_number: int,
    max_rank: int = 3,
    valid_cmatch: Sequence[int] = DEFAULT_VALID_CMATCH,
) -> np.ndarray:
    """[ins_number, 2*max_rank+1] int32 matrix (GetRankOffset parity).

    Ads are assumed laid out pv-contiguously in the batch, pvs in order;
    rows past the pvs' total ad count stay all -1 (ghost padding).
    """
    col = 2 * max_rank + 1
    mat = np.full((ins_number, col), -1, dtype=np.int32)
    index = 0
    for pv in pvs:
        start = index
        ranks = [_ad_rank(ad, max_rank, valid_cmatch) for ad in pv.ads]
        for j, rank in enumerate(ranks):
            mat[index, 0] = rank
            if rank > 0:
                for k, fast_rank in enumerate(ranks):
                    if fast_rank > 0:
                        m = fast_rank - 1
                        mat[index, 2 * m + 1] = fast_rank
                        mat[index, 2 * m + 2] = start + k
            index += 1
    return mat


def _iter_pv_blocks(
    pvs: Sequence[PvInstance],
    b: int,
    n_devices: int,
    drop_remainder: bool = False,
) -> Iterator[List[List[PvInstance]]]:
    """The greedy pv->block packing grid, shared by pack/count/stats so the
    three can never disagree about batch composition. Each yielded item is
    up to n_devices groups of whole pvs, each group <= b instances."""
    blocks: List[List[PvInstance]] = [[]]
    cur_ins = 0
    for pv in pvs:
        n = len(pv.ads)
        if n > b:
            raise ValueError(
                f"pv with {n} ads exceeds join block size {b} "
                f"({b * n_devices} instances / {n_devices} devices)"
            )
        if cur_ins + n > b:
            if len(blocks) == n_devices:
                yield blocks
                blocks = [[]]
            else:
                blocks.append([])
            cur_ins = 0
        blocks[-1].append(pv)
        cur_ins += n
    if any(g for g in blocks) and not drop_remainder:
        yield blocks


def first_pv_record(pvs: Sequence[PvInstance]):
    """First real ad, used as the weight-0 ghost for all-ghost batches."""
    for pv in pvs:
        if pv.ads:
            return pv.ads[0]
    return None


def pack_pv_batches(
    pvs: Sequence[PvInstance],
    batch_size: int,
    max_rank: int = 3,
    valid_cmatch: Sequence[int] = DEFAULT_VALID_CMATCH,
    drop_remainder: bool = False,
    n_devices: int = 1,
    min_batches: int = 0,
) -> Iterator[Tuple[List[SlotRecord], np.ndarray, np.ndarray]]:
    """Yield (records, rank_offset, ins_weight) join-phase batches.

    Whole pvs pack greedily into ``batch_size`` instance slots; the tail pads
    with weight-0 ghost copies of the last real ad so every batch has the
    same static shape. A pv with more ads than a block is rejected.

    With ``n_devices > 1`` the batch is packed as ``n_devices`` blocks of
    ``batch_size / n_devices`` slots, NO pv crossing a block boundary, and
    rank_offset peer rows are DEVICE-LOCAL (0..b-1 within each block) — the
    shape the mesh join step's per-device rank_attention gathers over. The
    records stream out device-major, matching the sharded packer's
    ins -> device mapping (ins // b).

    ``min_batches`` keeps multi-host meshes in lockstep (the pv analog of
    compute_thread_batch_nccl, data_set.cc:2069-2135): after the local pvs
    run out, all-ghost batches (weight 0 everywhere, rank_offset all -1)
    are emitted until ``min_batches`` have been yielded, so a host with
    fewer page views still executes every collective of the pass.
    """
    if batch_size % n_devices:
        raise ValueError(f"batch {batch_size} not divisible by {n_devices} devices")
    b = batch_size // n_devices

    def emit(blocks: List[List[PvInstance]]):
        while len(blocks) < n_devices:  # tail: some devices all-ghost
            blocks.append([])
        records: List[SlotRecord] = []
        weight = np.zeros(batch_size, dtype=np.float32)
        ros = []
        for d, group in enumerate(blocks):
            recs = flatten_pv_instances(group)
            n_real = len(recs)
            weight[d * b : d * b + n_real] = 1.0
            ghost = recs[-1] if recs else _GHOST_FALLBACK(blocks)
            while len(recs) < b:  # ghost-pad the block
                recs.append(ghost)
            records.extend(recs)
            ros.append(build_rank_offset(group, b, max_rank, valid_cmatch))
        return records, np.concatenate(ros, axis=0), weight

    def _GHOST_FALLBACK(blocks):
        for g in blocks:
            for pv in g:
                if pv.ads:
                    return pv.ads[0]
        raise ValueError("cannot ghost-pad an entirely empty pv batch")

    if min_batches and drop_remainder:
        raise ValueError("min_batches (lockstep) and drop_remainder conflict")
    emitted = 0
    for blocks in _iter_pv_blocks(pvs, b, n_devices, drop_remainder):
        yield emit(blocks)
        emitted += 1
    ghost = first_pv_record(pvs) if emitted < min_batches else None
    while emitted < min_batches:
        if ghost is None:
            raise ValueError(
                "lockstep needs at least one local record to ghost-pad "
                "with (this host holds zero page views)"
            )
        yield (
            [ghost] * batch_size,
            np.full((batch_size, 2 * max_rank + 1), -1, dtype=np.int32),
            np.zeros(batch_size, dtype=np.float32),
        )
        emitted += 1


@dataclass
class PvPlan:
    """Pass-deterministic join-phase feed plan, as arrays.

    ``pack_pv_batches``' record stream re-expressed at the index level: pv
    batch composition is fully determined once ``preprocess_instance`` has
    grouped the pass (the reference likewise fixes batch_offsets_ at
    PrepareTrain, data_set.cc:2155-2192), so the whole join phase can be
    materialized ONCE per pass as three stacked tensors and every later
    consumer — the native host packer, the device-resident feed, the
    multi-host pad lockstep — becomes vectorized array math instead of a
    per-record Python sweep.

    - ``idx`` [n_batches, B] int64: store record index per instance slot
      (ghost padding repeats a real record's index; ``ins_weight`` zeroes it)
    - ``rank_offset`` [n_batches, B, 2*max_rank+1] int32 (device-local peer
      rows when ``n_devices`` > 1, matching the mesh join step)
    - ``ins_weight`` [n_batches, B] float32 (0 on ghosts)
    """

    idx: np.ndarray
    rank_offset: np.ndarray
    ins_weight: np.ndarray
    n_devices: int

    @property
    def n_batches(self) -> int:
        return self.idx.shape[0]


def build_pv_plan(
    pvs: Sequence[PvInstance],
    batch_size: int,
    max_rank: int = 3,
    valid_cmatch: Sequence[int] = DEFAULT_VALID_CMATCH,
    n_devices: int = 1,
    min_batches: int = 0,
):
    """Materialize pack_pv_batches as a PvPlan (one pass over the pvs).

    Returns None when any record lacks a store index (``_store_idx`` is
    stamped when records materialize from a ColumnarRecords store) — such
    datasets keep the record-level pv path.
    """
    idxs, ros, wts = [], [], []
    for recs, ro, w in pack_pv_batches(
        pvs,
        batch_size,
        max_rank=max_rank,
        valid_cmatch=valid_cmatch,
        n_devices=n_devices,
        min_batches=min_batches,
    ):
        row = np.empty(len(recs), np.int64)
        for j, r in enumerate(recs):
            si = getattr(r, "_store_idx", None)
            if si is None:
                return None
            row[j] = si
        idxs.append(row)
        ros.append(ro)
        wts.append(w)
    col = 2 * max_rank + 1
    if not idxs:
        return PvPlan(
            np.zeros((0, batch_size), np.int64),
            np.zeros((0, batch_size, col), np.int32),
            np.zeros((0, batch_size), np.float32),
            n_devices,
        )
    return PvPlan(
        np.stack(idxs), np.stack(ros), np.stack(wts), n_devices
    )


def count_pv_batches(
    pvs: Sequence[PvInstance], batch_size: int, n_devices: int = 1
) -> int:
    """Number of batches pack_pv_batches will yield (no materialization).

    Multi-host join phases allreduce-max this count so every host runs the
    same number of mesh collectives (lockstep parity)."""
    if batch_size % n_devices:
        raise ValueError(f"batch {batch_size} not divisible by {n_devices} devices")
    b = batch_size // n_devices
    return sum(1 for _ in _iter_pv_blocks(pvs, b, n_devices))
