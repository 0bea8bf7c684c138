"""BoxPSDataset: one node's pass data pipeline.

Port of the JAX package's ``data/dataset.py`` for a single process:

    set_date -> set_filelist -> load_into_memory -> begin_pass
    -> batch_indices() / batches() / train -> end_pass(trained_table)

- ``load_into_memory`` reads the part files in a thread pool. With the
  flag ``enable_native_parser`` (the default) each file is parsed in one
  native call (``csrc/slot_parser.cc``) into a ``ColumnarRecords`` chunk;
  the chunks concatenate into ``store`` and a shuffle is a permutation
  ``_order`` over it. With the flag off, each line goes through
  ``parse_line`` into a ``SlotRecord`` list. A bad line raises either way
  (strict mode). Shuffle modes are "none" and "local" (the JAX package's
  permutation for the same seed and pass); every feasign feeds a fresh
  ``PassWorkingSet``.
- ``preload_into_memory`` runs that load on a thread while the current
  pass trains (``wait_preload_done`` joins it). With the flag
  ``boundary_pipeline`` the load also premerges the staged working set's
  keys and, when ``boundary_prefetch_pull`` holds and nothing can change
  the rows (no shrink threshold, no memory cap), pulls the host rows of
  its keys that the live pass does not hold.
- ``begin_pass`` finalizes the working set against the host table and
  returns the pass table for the device: a numpy array, or, after a
  carried boundary, a tensor on the carrier's device.
- ``batch_indices`` serves the store-record indices of each minibatch (the
  fast feeds); ``batches`` serves ``SlotBatch``es (the slow feed). Both
  wrap around past the tail.
- ``end_pass_async`` runs the boundary on a non-daemon worker: it writes
  the trained rows back, then decays and shrinks the host table, saves a
  delta when asked, enforces the table's memory cap (the disk tier) and
  publishes its tier gauges, in the JAX package's order;
  ``wait_end_pass`` (or the next ``begin_pass``) joins it, and
  ``end_pass`` is the two in one call. A failed end_pass re-opens the
  pass, to be retried or reverted. Handed a device tensor (the flag
  ``enable_carried_table``, no guard armed) the boundary is carried: the
  table stays on the device in a ``TableCarrier`` and the next
  ``begin_pass`` splices it (``table/carrier.py``). ``kick_writeback``
  starts the classic writeback before end_pass (flag
  ``overlap_writeback``), and end_pass then joins it.
- ``begin_pass(enable_revert=True, trainer=...)`` drains the pending
  carriers and arms a ``PassGuard``; ``revert_pass`` cancels a kicked
  writeback, restores the pass keys' host rows and the trainer's dense
  state, drops a staged next pass and re-arms the same records for a
  retrain.

The boundary's gauges are ``boundary.{dedup,premerge,prefetch_pull,splice,
pull,writeback,writeback_hidden,overlap_hidden}_s``; its fault sites are
``boundary.premerge``, ``boundary.stage_pull`` and ``boundary.writeback``.

The join phase (``current_phase`` 1): ``preprocess_instance`` groups the
pass into pvs (``data/pv_instance.py``); ``pv_plan`` serves their packing
as index arrays (cached on the pvs), ``pv_batches`` as ``SlotBatch``es
with ``rank_offset`` and ghost weights; ``postprocess_instance`` restores
the flat view, a permutation ``_order`` of the store when every record
knows its store index (the ``_store_idx`` that ``records`` stamps).

On a single-host mesh (``n_mesh_shards`` = the world size) every rank
runs the same dataset over the same files with the same seed, so its host
table, its working set (``PassWorkingSet(n_mesh_shards)``, rows laid out
[n_mesh_shards, cap, width]) and its batches are replicas.
:meth:`BoxPSDataset.replica_digest` hashes the pass's keys and its record
order; the mesh trainer all-gathers it before a pass's first step and
raises on a rank that differs (a drifted replica would route wrongly or
deadlock the collectives). That first pass binds the dataset to the
trainer's plan (``mesh_plan``): ``end_pass`` then takes a rank's shard
(``trainer.trained_table_device()``) and carries it (``table/carrier.py``:
the departing rows of every shard reach every rank's host table, so the
replicas stay bitwise alike and bitwise what the classic boundary gives
once drained); with ``need_save_delta``, a guard or a kicked writeback the
shard is all-gathered and written back the classic way. A mesh carrier's
flush is a collective: its eager flush runs on the calling thread, right
after the splice, and before a save every rank calls
:meth:`BoxPSDataset.flush_carried` (a save that reaches a pending mesh
carrier raises rather than wait for ranks that never join).

Not ported: quarantine, pipe converters, global shuffles across nodes, the
multi-host working set and carrier (ROADMAP Queue 5), the transport (``num_pv_batches``
counts the local pvs) and trace events.
"""

from __future__ import annotations

import glob
import itertools
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, Iterator, List, Optional, Sequence

import numpy as np
import torch

from paddlebox_tpu_torch import config
from paddlebox_tpu_torch.data.parser import parse_line
from paddlebox_tpu_torch.data.pv_instance import (
    PvInstance,
    build_pv_plan,
    count_pv_batches,
    flatten_pv_instances,
    merge_pv_instances,
    pack_pv_batches,
)
from paddlebox_tpu_torch.data.record_store import ColumnarRecords
from paddlebox_tpu_torch.data.slot_record import SlotBatch, SlotRecord, build_batch
from paddlebox_tpu_torch.data.slot_schema import SlotSchema
from paddlebox_tpu_torch.ops.wire_quant import fetch_rows_finish, fetch_rows_start
from paddlebox_tpu_torch.table.carrier import TableCarrier
from paddlebox_tpu_torch.table.sparse_table import (
    HostSparseTable,
    PassWorkingSet,
    WritebackCancelled,
)
from paddlebox_tpu_torch.utils.faultinject import fire
from paddlebox_tpu_torch.utils.monitor import STAT_ADD, STAT_OBSERVE, STAT_SET

config.define_flag(
    "enable_carried_table",
    1,
    "keep the trained pass table on the device across the pass boundary "
    "and splice the surviving rows into the next pass's table on the "
    "device (device to host only the departing keys, host to device only "
    "the new ones); 0 = classic full writeback and full upload",
)
config.define_flag(
    "carried_eager_flush",
    0,
    "after the carried-table splice, flush the carrier to the host store "
    "on a background thread (a full-table fetch beside the next pass): "
    "frees the device memory the lazy default holds for a whole pass. On a "
    "single-host mesh the flush is a collective, so it runs inside "
    "begin_pass on the calling thread instead (all-gathers of every shard's "
    "carried rows and a host push: about a classic boundary's writeback)",
)
config.define_flag(
    "boundary_pipeline",
    1,
    "pipelined pass boundary: the load premerges the staged pass's key "
    "chunks (and, with boundary_prefetch_pull, prefetches host rows) while "
    "the current pass trains, so begin_pass finds the dedup and the pull "
    "done; 0 = the serial boundary",
)
config.define_flag(
    "overlap_writeback",
    1,
    "kick_writeback starts the end-of-pass host writeback as soon as the "
    "trained table is there, and the end_pass worker joins it: "
    "boundary.writeback_s records only the tail it waited for; 0 = "
    "kick_writeback does nothing and the worker writes back",
)
config.define_flag(
    "boundary_prefetch_pull",
    1,
    "with boundary_pipeline: the feed stage pulls or creates the host rows "
    "of staged keys not in the live pass (only decay can change them "
    "before the boundary, and the consumer applies it bitwise). Off when "
    "shrink_threshold != 0 or a memory cap is set: either could drop a "
    "prefetched row",
)

_SHUFFLE_MODES = ("none", "local")


def _trained_to_host(arr, layout) -> Callable[[], np.ndarray]:
    """The trained table on the host, over the ``wire_dtype`` wire for a
    tensor. The copy of a tensor is queued now, on the calling thread (so
    it reads the table as it is and never waits behind later work); the
    returned function waits for it and gives the host array. The classic
    writeback of the end_pass worker and of the kick share it."""
    if isinstance(arr, torch.Tensor):
        shape = tuple(arr.shape)
        handle = fetch_rows_start(
            arr.reshape(-1, shape[-1]), layout, str(config.get_flag("wire_dtype"))
        )
        return lambda: fetch_rows_finish(handle, layout).reshape(shape)
    host = np.asarray(arr)
    return lambda: host


class _WritebackKick:
    """A writeback started by kick_writeback: its future resolves to the
    thread's wall seconds or to its failure; ``cancel`` is checked at the
    writeback's chunk boundaries (the revert path)."""

    def __init__(self, ws):
        self.ws = ws
        self.cancel = threading.Event()
        self.fut: "Future[float]" = Future()
        self.thread: Optional[threading.Thread] = None


@dataclass
class PassStats:
    """Counts of one pass's load."""

    files: int = 0
    records: int = 0  # records kept for the pass
    keys: int = 0  # unique feasigns in the working set (set at begin_pass)
    # the load's wall seconds: reading and parsing the files, the shuffle
    # (concatenation and permutation), feeding the working set its keys
    read_s: float = 0.0
    shuffle_s: float = 0.0
    keys_s: float = 0.0


def _working_set(
    store: Optional[ColumnarRecords], records: List[SlotRecord], n_mesh_shards: int = 1
) -> PassWorkingSet:
    """A fresh working set fed every feasign of the pass (MergeInsKeys
    parity), from the columnar store or else the record list."""
    ws = PassWorkingSet(n_mesh_shards=n_mesh_shards)
    if store is not None:
        ws.add_keys(store.u64_values)
    else:
        chunk = 4096
        for i in range(0, len(records), chunk):
            ws.add_keys(np.concatenate([r.u64_values for r in records[i : i + chunk]]))
    return ws


class BoxPSDataset:
    """One node's view of the pass data pipeline."""

    def __init__(
        self,
        schema: SlotSchema,
        table: HostSparseTable,
        batch_size: int,
        read_threads: int = 8,
        shuffle_mode: str = "none",
        seed: int = 0,
        n_mesh_shards: int = 1,
    ):
        if shuffle_mode not in _SHUFFLE_MODES:
            raise NotImplementedError(
                f"shuffle_mode {shuffle_mode!r}: only {_SHUFFLE_MODES} are ported (global "
                "shuffles across nodes: ROADMAP Queue 5)"
            )
        self.schema = schema
        self.table = table
        self.batch_size = batch_size
        self.read_threads = read_threads
        self.shuffle_mode = shuffle_mode
        self.seed = seed
        self.n_mesh_shards = n_mesh_shards  # the mesh's world size; 1 = one device
        # the mesh plan a mesh trainer bound at its first pass (None: one device)
        self.mesh_plan = None

        self.date: Optional[str] = None
        self.pass_id = 0
        self.current_phase = 1  # 1 join, 0 update (data_set.h:291)
        # the join phase's pvs, between preprocess_instance and
        # postprocess_instance, and their plans keyed by packing arguments
        self.pvs: List[PvInstance] = []
        self._pv_merged = False
        self._pv_max_rank = 3
        self._pv_valid_cmatch: tuple = (222, 223)
        self._pv_plan_cache = None  # (pvs, {(n_devices, min_batches): PvPlan})
        self._filelist: List[str] = []
        # pass data lives EITHER columnar (store + shuffle order, the native
        # tier) or as a SlotRecord list (the Python tier); the `records`
        # property materializes a view list of a store on demand
        self.store: Optional[ColumnarRecords] = None
        self._order: Optional[np.ndarray] = None
        self._records: List[SlotRecord] = []
        self.ws: Optional[PassWorkingSet] = None
        self.device_table = None  # numpy, or a device tensor after a splice
        self.stats = PassStats()
        self._in_pass = False
        # (store, order, records, ws, stats) loaded but not yet begun, and
        # its staged prefetch {src, keys, rows, epoch}: written by the load
        # (or preload) thread, read after wait_preload_done joins it
        self._staged = None
        self._boundary_prefetch = None
        self._guard = None  # the armed PassGuard of the open pass, if any
        self._preload_thread: Optional[threading.Thread] = None
        self._preload_exc: Optional[BaseException] = None  # handed over by the join
        self._end_pass_fut: Optional[Future] = None
        self._end_pass_thread: Optional[threading.Thread] = None
        self._end_pass_result: dict = {}
        self._wb_kick: Optional[_WritebackKick] = None
        # the newest boundary's carrier, and the carrier of the boundary
        # before the pending end_pass (its departure push is joined first)
        self._carrier: Optional[TableCarrier] = None
        self._prev_boundary_carrier: Optional[TableCarrier] = None
        self._eager_thread: Optional[threading.Thread] = None
        self._eager_flush_error: Optional[BaseException] = None
        # stage seconds hidden behind training, added on the load thread and
        # read at wait_end_pass into boundary.overlap_hidden_s
        self._stage_lock = threading.Lock()
        self._stage_hidden_s = 0.0  # guarded-by: _stage_lock
        # serializes the live-pass slots (store, order, records, ws, stats,
        # _in_pass) between a finishing preload's publish and a failed
        # end_pass worker's re-open, so the two passes never tear
        self._pass_lock = threading.RLock()

    # ---- record access ---------------------------------------------------

    @property
    def records(self) -> List[SlotRecord]:
        """The pass as SlotRecords, in shuffle order. A store-backed pass
        materializes views of its store once, on first access, each stamped
        with its store index (``_store_idx``): a pv merge and flatten of
        them stays a permutation of the store, and the pv plan indexes it."""
        if not self._records and self.store is not None and len(self.store):
            order = self._order if self._order is not None else range(len(self.store))
            recs = []
            for i in order:
                r = self.store.record(int(i))
                r._store_idx = int(i)
                recs.append(r)
            self._records = recs
        return self._records

    @records.setter
    def records(self, value) -> None:
        # an assigned list becomes the source of truth: the store would be
        # stale, so it goes
        self._records = list(value)
        self.store = None
        self._order = None

    # ---- pass config -----------------------------------------------------

    def set_date(self, date: str) -> None:
        """New day/pass id (BoxHelper::SetDate parity)."""
        self.date = date
        self.pass_id += 1

    def set_filelist(self, files: Sequence[str]) -> None:
        """The part files of the pass; glob patterns expand in sorted order."""
        expanded: List[str] = []
        for f in files:
            expanded.extend(sorted(glob.glob(f)) if any(c in f for c in "*?[") else [f])
        self._filelist = expanded

    def set_current_phase(self, phase: int) -> None:
        """1 = the join phase (pv-merged batches), 0 = the update phase."""
        self.current_phase = phase

    # ---- pv merge (join phase) ------------------------------------------

    def preprocess_instance(self, max_rank: int = 3, valid_cmatch=(222, 223)) -> int:
        """Group this pass's records into pv instances for join-phase
        training (PreprocessInstance parity, data_set.cc:1968-2009).
        Returns the pv count. Needs logkey parsing (the search ids)."""
        if not self.schema.parse_logkey:
            raise RuntimeError(
                "preprocess_instance needs search_ids: build the SlotSchema "
                "with parse_logkey=True (else every record has search_id=0 "
                "and the whole pass merges into one pv)"
            )
        self.pvs = merge_pv_instances(self.records)
        self._pv_max_rank = max_rank
        self._pv_valid_cmatch = tuple(valid_cmatch)
        self._pv_merged = True
        return len(self.pvs)

    @property
    def pv_merged(self) -> bool:
        """True between preprocess_instance and postprocess_instance."""
        return self._pv_merged

    def postprocess_instance(self) -> None:
        """Restore the flat record view for the update phase
        (PostprocessInstance parity). On a store-backed pass whose records
        all know their store index, the pv-flattened order becomes a
        permutation ``_order`` of the store, so the update phase keeps the
        columnar feeds; otherwise the flattened list becomes the pass."""
        if not self._pv_merged:
            return
        flat = flatten_pv_instances(self.pvs)
        idx = [getattr(r, "_store_idx", None) for r in flat]
        if self.store is not None and len(flat) == len(self.store) and all(i is not None for i in idx):
            self._records = flat
            self._order = np.asarray(idx, dtype=np.int64)
        else:
            self.records = flat  # the setter: the list becomes the pass
        self.pvs = []
        self._pv_merged = False
        self._pv_plan_cache = None

    def _need_pvs(self) -> None:
        if not self._pv_merged:
            raise RuntimeError("preprocess_instance first")

    def pv_plan(self, n_devices: int = 1, min_batches: int = 0):
        """The join phase's packing as index arrays (``PvPlan``), cached on
        the pvs' identity and the packing arguments, so a warm-up epoch, the
        timed epochs and an eval pass share one sweep. None when the pass is
        not store-backed (its consumers take the record-level feed)."""
        self._need_pvs()
        if self.store is None:
            return None
        c = self._pv_plan_cache
        if c is None or c[0] is not self.pvs:
            c = self._pv_plan_cache = (self.pvs, {})
        key = (n_devices, min_batches)
        if key not in c[1]:
            c[1][key] = build_pv_plan(
                self.pvs, self.batch_size, max_rank=self._pv_max_rank,
                valid_cmatch=self._pv_valid_cmatch, n_devices=n_devices,
                min_batches=min_batches,
            )
        return c[1][key]

    def num_pv_batches(self, n_devices: int = 1, global_count: bool = False) -> int:
        """Join-phase batch count. The port has no transport, so
        ``global_count`` gives the local count, as the JAX package does
        without one."""
        self._need_pvs()
        return count_pv_batches(self.pvs, self.batch_size, n_devices=n_devices)

    def pv_batches(self, n_batches: Optional[int] = None, n_devices: int = 1, min_batches: int = 0):
        """Join-phase batches: (SlotBatch with ``rank_offset``, ins_weight
        [B] float32). Whole pvs pack into ``batch_size`` instance slots,
        ghost-padded (see ``data/pv_instance.py``); the weights mask the
        ghosts out of the loss, the metrics and the show/clk counts. At
        most ``n_batches`` (no wrap-around)."""
        self._need_pvs()
        packed = pack_pv_batches(
            self.pvs, self.batch_size, max_rank=self._pv_max_rank,
            valid_cmatch=self._pv_valid_cmatch, n_devices=n_devices,
            min_batches=min_batches,
        )
        if n_batches is not None:
            packed = itertools.islice(packed, n_batches)
        for records, rank_offset, weight in packed:
            sb = build_batch(records, self.schema)
            sb.rank_offset = rank_offset
            yield sb, weight

    # ---- load ------------------------------------------------------------

    def _native_eligible(self) -> bool:
        # the native parser reads every line; line sampling needs the
        # line-by-line reader
        return bool(config.get_flag("enable_native_parser")) and (
            config.get_flag("sample_rate") >= 1.0
        )

    def _read_one(self, path: str):
        """One part file -> a ColumnarRecords chunk (native tier) or a
        SlotRecord list (Python tier). The first bad line raises; a record
        without feasigns is skipped."""
        if self._native_eligible():
            from paddlebox_tpu_torch.utils import native

            with open(path, "rb") as f:
                return native.parse_buffer_columnar(f.read(), self.schema)
        out = []
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.rstrip("\n")
                rec = parse_line(line, self.schema) if line else None
                if rec is not None:
                    out.append(rec)
        return out

    def _shuffle_records(self, records: List[SlotRecord]) -> List[SlotRecord]:
        if self.shuffle_mode == "none":
            return records
        rng = np.random.default_rng(self.seed + self.pass_id)
        order = rng.permutation(len(records))
        return [records[i] for i in order]

    def _shuffle_store(self, store: ColumnarRecords):
        """Columnar shuffle: a permutation of the store, no data moved. The
        same permutation ``_shuffle_records`` applies to a record list."""
        if self.shuffle_mode == "none":
            return store, None, []
        rng = np.random.default_rng(self.seed + self.pass_id)
        return store, rng.permutation(len(store)), []

    def _normalize_and_shuffle(self, parts: list):
        """File chunks -> (store, order, records): columnar when every part
        is columnar and one holds records, a SlotRecord list otherwise."""
        if parts and all(isinstance(p, ColumnarRecords) for p in parts):
            non_empty = [p for p in parts if len(p)]
            if non_empty:
                return self._shuffle_store(ColumnarRecords.concat(non_empty))
        records: List[SlotRecord] = []
        for p in parts:
            records.extend(p.records() if isinstance(p, ColumnarRecords) else p)
        return None, None, self._shuffle_records(records)

    def load_into_memory(self) -> None:
        """Threaded read -> shuffle -> staged pass data + working-set keys,
        then the boundary feed stage (:meth:`_stage_boundary_prefetch`).

        Loads into a staging slot, so it can run while the previous pass
        trains; ``begin_pass`` consumes it. When no pass is open the load
        is published at once, so ``memory_data_size`` and ``records`` show
        it."""
        if self._staged is not None:
            raise RuntimeError("staged pass not yet consumed by begin_pass")
        if self._preload_thread is not None and threading.current_thread() is not self._preload_thread:
            raise RuntimeError("preload in flight; wait_preload_done first")
        stats = PassStats(files=len(self._filelist))
        parts: list = []
        t0 = time.perf_counter()
        if self._filelist:
            with ThreadPoolExecutor(max_workers=max(1, self.read_threads)) as pool:
                parts = list(pool.map(self._read_one, self._filelist))
        t1 = time.perf_counter()
        store, order, records = self._normalize_and_shuffle(parts)
        t2 = time.perf_counter()
        ws = _working_set(store, records, self.n_mesh_shards)
        stats.read_s, stats.shuffle_s, stats.keys_s = t1 - t0, t2 - t1, time.perf_counter() - t2
        stats.records = len(store) if store is not None else len(records)
        self._staged = (store, order, records, ws, stats)
        try:
            self._stage_boundary_prefetch(ws)
        except BaseException:
            # a failed feed stage must not leave a staged slot that makes
            # the retried load refuse
            self.discard_staged()
            raise
        with self._pass_lock:
            # the flag read and the publish are one step against a failed
            # end_pass worker's re-open
            if not self._in_pass:
                self._publish(self._staged)

    def _stage_boundary_prefetch(self, ws: PassWorkingSet) -> None:
        """The boundary feed stage, on the load thread while the current
        pass trains: premerge the staged working set's keys and (gated)
        pull the host rows of those the live pass does not hold. Those
        rows can change before the boundary only by decay, which the
        consumer applies bitwise (``_rows_with_prefetch``)."""
        if not config.get_flag("boundary_pipeline"):
            return
        self._boundary_prefetch = None
        fire("boundary.premerge")
        t0 = time.perf_counter()
        merged = ws.premerge(int(config.get_flag("boundary_merge_threads")))
        premerge_s = time.perf_counter() - t0
        STAT_SET("boundary.premerge_s", premerge_s)
        STAT_OBSERVE("boundary.premerge_s", premerge_s)
        if self._in_pass:
            with self._stage_lock:
                self._stage_hidden_s += premerge_s
        live, table = self.ws, self.table
        if (
            not config.get_flag("boundary_prefetch_pull")
            or not self._in_pass
            or not len(merged)
            or live is None
            or not live._finalized
            or table.opt.shrink_threshold != 0
            or table.mem_cap_rows is not None
        ):
            return
        # the live pass's keys are left out: their host rows are final
        # only once its writeback or splice lands
        exclude = live.sorted_keys
        if len(exclude):
            pos = np.minimum(np.searchsorted(exclude, merged), len(exclude) - 1)
            need = merged[exclude[pos] != merged]
        else:
            need = merged
        if not len(need):
            return
        # the previous boundary's departure push may cover keys in `need`;
        # wait for it to land, leaving a failure to the end_pass worker
        carrier = self._carrier
        if carrier is not None and not carrier.flushed:
            carrier.wait_push()
        fire("boundary.stage_pull")
        t0 = time.perf_counter()
        rows, epoch = table.prefetch_rows(need)
        pull_s = time.perf_counter() - t0
        STAT_SET("boundary.prefetch_pull_s", pull_s)
        STAT_OBSERVE("boundary.prefetch_pull_s", pull_s)
        with self._stage_lock:
            self._stage_hidden_s += pull_s
        self._boundary_prefetch = {"src": merged, "keys": need, "rows": rows, "epoch": epoch}

    def discard_staged(self) -> None:
        """Drop a staged load that was not begun, and its prefetch."""
        self._staged = None
        self._boundary_prefetch = None

    def _publish(self, staged) -> None:
        with self._pass_lock:
            self.store, self._order, self._records, self.ws, self.stats = staged

    def preload_into_memory(self) -> None:
        """``load_into_memory`` on a thread, beside the current pass's
        training (PreLoadIntoMemory, data_set.cc:1576-1626)."""
        if self._preload_thread is not None:
            raise RuntimeError("preload already running")

        def run():
            try:
                self.load_into_memory()
            except BaseException as e:  # raised by wait_preload_done
                self._preload_exc = e

        self._preload_thread = threading.Thread(target=run, name="preload", daemon=True)
        self._preload_thread.start()

    def wait_preload_done(self) -> None:
        """Join the preload; raises what it raised."""
        if self._preload_thread is None:
            return
        self._preload_thread.join()
        self._preload_thread = None
        if self._preload_exc is not None:
            exc, self._preload_exc = self._preload_exc, None
            raise exc

    # ---- pass lifecycle --------------------------------------------------

    def _eager_drain(self) -> None:
        """The background carrier flush (``carried_eager_flush``). A
        failure keeps the carrier registered and is raised at the next
        boundary."""
        try:
            self.table.drain_pending()
        except Exception as e:  # raised by _raise_pending_flush_error
            self._eager_flush_error = e

    def _raise_pending_flush_error(self) -> None:
        # join the drain first, so its failure surfaces at this boundary
        t = self._eager_thread
        if t is not None:
            t.join()
        self._eager_thread = None
        err, self._eager_flush_error = self._eager_flush_error, None
        if err is not None:
            raise RuntimeError(
                "background carrier flush failed: the carried values stay owed "
                "and the next drain_pending retries them"
            ) from err

    def begin_pass(self, round_to: int = 512, enable_revert: bool = False, trainer=None):
        """Consume the staged load, finalize the working set against the
        host table, and return the pass table for the device
        (BeginFeedPass + EndFeedPass + BeginPass): a numpy [1, cap, width]
        array, or after a carried boundary the spliced tensor on the
        carrier's device. Joins a pending end_pass first.

        ``enable_revert=True`` drains the pending carriers and arms a
        PassGuard (Confirm/Revert parity, fleet_wrapper.h:319-321): the
        pass keys' pre-train rows and, with ``trainer``, its dense params
        and optimizer state are snapshotted so :meth:`revert_pass` can
        reject everything the pass publishes; end_pass confirms."""
        # a pending end_pass writes the host table; finalize reads it
        self.wait_end_pass()
        self._raise_pending_flush_error()
        if self._in_pass:
            raise RuntimeError(
                "previous pass is still open: call end_pass (or, after a failed "
                "end_pass, retry it or revert_pass) first"
            )
        if self._staged is not None:
            self._publish(self._staged)
            self._staged = None
        prefetch, self._boundary_prefetch = self._boundary_prefetch, None
        if self.ws is None:
            raise RuntimeError("load_into_memory first")
        if enable_revert:
            # the snapshot reads host rows: carried values land first (every
            # rank makes this call alike, so a mesh carrier may flush)
            self.table.drain_pending(collective=True)
        if not self.ws._finalized:
            carrier = self._carrier
            if carrier is not None and not carrier.flushed:
                self.device_table = self.ws.finalize(
                    self.table, round_to=round_to, carrier=carrier, prefetch=prefetch
                )
                if config.get_flag("carried_eager_flush") and carrier.plan is not None:
                    self.table.drain_pending(collective=True)  # its collectives stay on this thread
                elif config.get_flag("carried_eager_flush"):
                    self._eager_thread = threading.Thread(
                        target=self._eager_drain, name="carrier-flush", daemon=False
                    )
                    self._eager_thread.start()
            else:
                self.device_table = self.ws.finalize(self.table, round_to=round_to, prefetch=prefetch)
        self.stats.keys = self.ws.n_keys
        self._in_pass = True
        self._guard = None
        if enable_revert:
            from paddlebox_tpu_torch.train.rollback import PassGuard

            self._guard = PassGuard(self.table, trainer)
            self._guard.begin(self.ws.sorted_keys)
        return self.device_table

    def kick_writeback(self, trained_table) -> None:
        """Start the end-of-pass host writeback now, beside whatever runs
        before ``end_pass``; the end_pass worker then joins it, so
        ``boundary.writeback_s`` holds only the tail it waited for and the
        rest goes to ``boundary.overlap_hidden_s``. Safe under an armed
        guard: ``revert_pass`` cancels it at a chunk boundary and restores
        the rows. Does nothing when no pass is open, a kick is pending or
        the flag ``overlap_writeback`` is off."""
        if (
            trained_table is None
            or not self._in_pass
            or self.ws is None
            or not config.get_flag("overlap_writeback")
            or self._wb_kick is not None
        ):
            return
        ws, table = self.ws, self.table
        kick = _WritebackKick(ws)
        to_host = _trained_to_host(self._whole_table(trained_table), table.layout)

        def run_kick():
            t0 = time.perf_counter()
            try:
                ws.writeback(to_host(), cancel=kick.cancel)
                kick.fut.set_result(time.perf_counter() - t0)
            except BaseException as e:  # surfaced by the end_pass worker or a revert
                kick.fut.set_exception(e)

        # non-daemon: interpreter exit joins a writeback in flight
        kick.thread = threading.Thread(target=run_kick, name="writeback-kick", daemon=False)
        self._wb_kick = kick
        kick.thread.start()

    def _cancel_writeback_kick(self) -> None:
        """Stop a kicked writeback at its next chunk boundary and join it;
        the revert that follows undoes whatever landed. A failure is
        counted, not raised: the revert undoes it too."""
        kick = self._wb_kick
        if kick is None:
            return
        kick.cancel.set()
        try:
            kick.fut.result()
        except WritebackCancelled:
            STAT_ADD("data.revert_writeback_cancelled")
        except BaseException:
            STAT_ADD("data.revert_end_pass_errors")
        kick.thread.join()
        self._wb_kick = None

    def revert_pass(self) -> None:
        """Reject the open pass (Revert parity, fleet_wrapper.h:319-321):
        a kicked writeback is cancelled, every pass key's host row returns
        to its pre-pass value (undoing a partial or complete writeback),
        the trainer's dense state is restored, a staged next pass is
        dropped (the preload joined first), and the same records are
        re-armed with a fresh working set so ``begin_pass`` retrains them."""
        self._cancel_writeback_kick()
        if self._end_pass_fut is not None:
            try:
                self.wait_end_pass()
            except Exception:
                # the failed publish is what the revert undoes; count it
                STAT_ADD("data.revert_end_pass_errors")
        guard = self._guard
        if guard is None or not guard.armed:
            raise RuntimeError("no armed rollback — begin_pass(enable_revert=True) first")
        guard.revert()
        self._guard = None
        if self._preload_thread is not None:
            try:
                self.wait_preload_done()
            except Exception:
                STAT_ADD("data.revert_preload_errors")
        self.discard_staged()
        self.ws = _working_set(self.store, self._records, self.n_mesh_shards)
        if self.store is not None:
            self.store.invalidate_rows()  # its rows resolved against the old set
        self.device_table = None
        self._in_pass = False

    def end_pass(
        self,
        trained_table=None,
        need_save_delta: bool = False,
        delta_dir: Optional[str] = None,
        shrink: bool = True,
    ) -> dict:
        """EndPass parity (box_wrapper.cc:627, SaveDelta :1316):
        :meth:`end_pass_async`, then :meth:`wait_end_pass`. Returns
        {"dropped", "delta_keys", "secs"}."""
        self.end_pass_async(
            trained_table, need_save_delta=need_save_delta, delta_dir=delta_dir, shrink=shrink
        )
        return self.wait_end_pass()

    def end_pass_async(
        self,
        trained_table=None,
        need_save_delta: bool = False,
        delta_dir: Optional[str] = None,
        shrink: bool = True,
    ) -> None:
        """EndPass on a non-daemon worker, beside the next pass's load: in
        the JAX package's order it writes the trained rows back to the host
        table, decays and shrinks it, saves a delta of the touched keys to
        ``delta_dir`` when ``need_save_delta``, spills cold rows past the
        table's ``mem_cap_rows`` to its disk tier, publishes the tier
        gauges and confirms an armed PassGuard. ``wait_end_pass`` or the
        next ``begin_pass`` joins it.

        ``trained_table`` is the pass table: a numpy array on the host
        (``CTRTrainer.trained_table()``), a tensor (``CTRTrainer.
        trained_table_device()``), or None to skip the writeback. A tensor
        with ``enable_carried_table`` on, no guard armed and no kicked
        writeback is carried: kept on its device for the next begin_pass
        to splice. A tensor otherwise goes to the host over the
        ``wire_dtype`` wire, the copy queued now. A failure re-opens the
        pass, so end_pass can be retried or the pass reverted."""
        if not self._in_pass:
            raise RuntimeError("begin_pass first")
        self._raise_pending_flush_error()
        if need_save_delta and delta_dir is None:
            raise ValueError("need_save_delta requires delta_dir")
        ws, guard, table = self.ws, self._guard, self.table
        shard = self._is_shard(trained_table)
        # a kicked writeback of this working set is joined, not repeated
        kick = self._wb_kick
        if kick is not None and kick.ws is ws:
            self._wb_kick = None
        else:
            kick = None
        carrier = None
        if (
            isinstance(trained_table, torch.Tensor)
            and trained_table.dim() in (2, 3)
            and config.get_flag("enable_carried_table")
            and guard is None
            and kick is None
            # a mesh carrier flushes with collectives, which the worker's
            # save_delta must not run: the shard goes back the classic way
            and not (shard and need_save_delta)
        ):
            # the worker's decay_and_shrink notes the decay on the carrier
            carrier = TableCarrier(trained_table, ws, table.layout, plan=self.mesh_plan if shard else None)
            table.add_pending_carrier(carrier)
            # the previous boundary's carrier is superseded: its carried
            # keys live on in this one, its departures were pushed
            prev = self._carrier
            if prev is not None and not prev.flushed:
                prev.supersede()
            self._carrier = carrier
        to_host = (
            _trained_to_host(self._whole_table(trained_table), table.layout)
            if trained_table is not None and carrier is None and kick is None
            else None
        )
        # the pass state clears now, so the next load can start; a worker
        # failure restores it (under the pass lock), leaving the pass open
        saved_state = (self.store, self._order, self._records)
        self._records = []
        self.store = None
        self._order = None
        self.ws = None
        self.device_table = None
        self._in_pass = False

        prev_carrier, self._prev_boundary_carrier = self._prev_boundary_carrier, carrier

        def run():
            t_run = time.perf_counter()
            wb_s = 0.0
            try:
                fire("boundary.writeback")
                if prev_carrier is not None:
                    # the previous departure push lands before this decay
                    prev_carrier.join_push()
                t_wb = time.perf_counter()
                if kick is not None:
                    kick_secs = kick.fut.result()
                    kick.thread.join()
                    wb_s = time.perf_counter() - t_wb
                    hidden = max(0.0, kick_secs - wb_s)
                    with self._stage_lock:
                        self._stage_hidden_s += hidden
                    STAT_SET("boundary.writeback_hidden_s", hidden)
                    STAT_OBSERVE("boundary.writeback_hidden_s", hidden)
                    if prev_carrier is not None and not prev_carrier.flushed:
                        prev_carrier.supersede()
                elif to_host is not None:
                    ws.writeback(to_host())
                    if prev_carrier is not None and not prev_carrier.flushed:
                        # the full writeback covers what the carrier owed; a
                        # later splice or drain of it would write stale rows
                        prev_carrier.supersede()
                    wb_s = time.perf_counter() - t_wb
                STAT_SET("boundary.writeback_s", wb_s)
                STAT_OBSERVE("boundary.writeback_s", wb_s)
                dropped = table.decay_and_shrink() if shrink else 0
                saved = table.save_delta(delta_dir) if need_save_delta else 0
                table.maybe_spill()
                table.publish_tier_stats()
                if guard is not None and guard.armed:
                    guard.confirm()  # the pass is published
                if self._guard is guard:
                    self._guard = None
                return {"dropped": dropped, "delta_keys": saved, "secs": time.perf_counter() - t_run}
            except BaseException:
                with self._pass_lock:
                    self.store, self._order, self._records = saved_state
                    self.ws = ws
                    self._in_pass = True
                raise

        fut: Future = Future()

        def worker():
            try:
                fut.set_result(run())
            except BaseException as e:  # raised by wait_end_pass
                fut.set_exception(e)

        self._end_pass_fut = fut
        # non-daemon: interpreter exit joins a publish in flight
        self._end_pass_thread = threading.Thread(target=worker, name="end-pass", daemon=False)
        self._end_pass_thread.start()

    def _is_shard(self, trained_table) -> bool:
        """A mesh rank's shard [cap, width] of the open pass's table (raises
        when no mesh trainer bound the dataset to its plan)."""
        ws = self.ws
        if not isinstance(trained_table, torch.Tensor) or ws is None or ws.n_mesh_shards == 1:
            return False
        if trained_table.numel() == ws.n_mesh_shards * ws.capacity * self.table.layout.width:
            return False
        if trained_table.numel() != ws.capacity * self.table.layout.width:
            raise ValueError(f"a pass table of shape {tuple(trained_table.shape)} fits neither the mesh's table nor one shard")
        if self.mesh_plan is None:
            raise ValueError("a rank's table shard needs the dataset bound to the mesh plan (a mesh trainer's train_pass)")
        return True

    def _whole_table(self, trained_table):
        """``trained_table``, with a mesh rank's shard all-gathered into
        the whole [world, cap, width] table on this rank's device."""
        if self._is_shard(trained_table):
            return self.mesh_plan.all_gather(trained_table.reshape(self.ws.capacity, -1))
        return trained_table

    def wait_end_pass(self) -> dict:
        """Join a pending end_pass_async; returns its result dict (the last
        one again if it was joined already; {} if none ran). Sets
        ``boundary.overlap_hidden_s``: the worker's seconds not spent
        waiting here plus the feed stage's, which ran behind training."""
        fut = self._end_pass_fut
        if fut is not None:
            t0 = time.perf_counter()
            try:
                self._end_pass_result = fut.result()
            except BaseException:
                self._end_pass_result = {}
                raise
            finally:
                self._end_pass_fut = None
                if self._end_pass_thread is not None:
                    self._end_pass_thread.join()
                    self._end_pass_thread = None
            blocked = time.perf_counter() - t0
            hidden = max(0.0, self._end_pass_result.get("secs", 0.0) - blocked)
            with self._stage_lock:
                stage_hidden, self._stage_hidden_s = self._stage_hidden_s, 0.0
            STAT_SET("boundary.overlap_hidden_s", hidden + stage_hidden)
            STAT_OBSERVE("boundary.overlap_hidden_s", hidden + stage_hidden)
        # a stored eager-flush failure raises here too: a run's last pass
        # has no next begin_pass to raise it
        err, self._eager_flush_error = self._eager_flush_error, None
        if err is not None:
            raise RuntimeError(
                "background carrier flush failed: the carried values stay owed "
                "and the next drain_pending retries them"
            ) from err
        return self._end_pass_result

    def flush_carried(self) -> int:
        """Flush the carriers the host table is owed, after joining a
        pending end_pass; returns the keys written. On a mesh every rank
        calls it alike on its main thread (each carrier's flush is a
        collective); that is how a mesh rank drains before a save."""
        self.wait_end_pass()
        return self.table.drain_pending(collective=True)

    # ---- batch serving ---------------------------------------------------

    def memory_data_size(self) -> int:
        if self.store is not None:
            return len(self.store)
        return len(self._records)

    def num_batches(self) -> int:
        """Full minibatches in this pass (the remainder is dropped)."""
        return self.memory_data_size() // self.batch_size

    def _check_nonempty(self, n: int) -> bool:
        if self.memory_data_size() == 0:
            if n > 0:
                raise RuntimeError(f"asked for {n} batches but the pass holds 0 records")
            return False
        return True

    def replica_digest(self) -> np.ndarray:
        """int64 [3]: hashes of the pass's sorted keys and of its record
        order (the store's shuffle order, or the record list's keys in
        order), and the batch size. Ranks of one mesh must agree on it."""
        import hashlib

        def h(*arrays) -> int:
            d = hashlib.blake2b(digest_size=8)
            for a in arrays:
                d.update(np.ascontiguousarray(a).tobytes())
            return int(np.frombuffer(d.digest(), dtype=np.int64)[0])

        if self.ws is None or self.ws.sorted_keys is None:
            raise RuntimeError("begin_pass first")
        if self.store is not None:
            order = self._order if self._order is not None else np.arange(len(self.store))
            order_h = h(np.asarray(order, dtype=np.int64), self.store.u64_values)
        else:
            order_h = h(*[r.u64_values for r in self._records])
        return np.array([h(self.ws.sorted_keys), order_h, self.batch_size], dtype=np.int64)

    def batch_indices(self, n_batches: Optional[int] = None) -> Iterator[np.ndarray]:
        """Store-record indices of each minibatch, int64 [batch_size], the
        shuffle order applied; wraps around past the tail."""
        n = self.num_batches() if n_batches is None else n_batches
        if not self._check_nonempty(n):
            return
        B, N = self.batch_size, self.memory_data_size()
        for i in range(n):
            idx = np.arange(i * B, (i + 1) * B, dtype=np.int64) % N
            yield self._order[idx] if self._order is not None else idx

    def batches(self, n_batches: Optional[int] = None) -> Iterator[SlotBatch]:
        """Yield equal-size SlotBatches; wraps around if asked for more than
        the pass holds."""
        n = self.num_batches() if n_batches is None else n_batches
        if not self._check_nonempty(n):
            return
        B = self.batch_size
        recs = self.records
        for i in range(n):
            batch = [recs[(i * B + j) % len(recs)] for j in range(B)]
            yield build_batch(batch, self.schema)
