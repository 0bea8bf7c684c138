"""BoxPSDataset: one node's pass data pipeline.

Port of the JAX package's ``data/dataset.py`` for a single process:

    set_date -> set_filelist -> load_into_memory -> begin_pass
    -> batch_indices() / batches() / train -> end_pass(trained_table)

- ``load_into_memory`` reads the part files in a thread pool, each on one
  of two tiers (``_native_eligible``). The native tier (flag
  ``enable_native_parser``, a local plain file, ``parse_line``, no pipe,
  ``sample_rate`` 1) parses a file in one native call
  (``csrc/slot_parser.cc``) into a ``ColumnarRecords`` chunk; the chunks
  concatenate into ``store`` and a shuffle is a permutation ``_order``
  over it. The Python tier (a ``pipe_command`` converter, a custom
  ``line_parser`` with its optional ``begin_file(path)``, sampling, a
  ``.gz`` or ``hdfs:``/``afs:`` path) reads lines through
  ``BufferedLineFileReader`` into a ``SlotRecord`` list. Every feasign
  feeds a fresh ``PassWorkingSet``.
- Quarantine (flag ``data_quarantine``, ``data/quarantine.py``): a line
  that fails to parse, and a whole file that cannot be read (truncated
  gz, a dead converter), are captured instead of raised, counted in
  ``PassStats`` and written to a dead-letter file under
  ``quarantine_dir``; a missing file is not quarantined (the fs retry tier
  owns it). The native tier's corrupt buffer is re-parsed line by line, so
  both tiers count alike. ``begin_pass`` gates the pass on the corrupt
  fraction (``admission_report``, ``check_admission``; ``DataPoisonedError``
  unless ``admit_poisoned``); ``drop_pass_data`` abandons it. With the flag
  off the first bad line raises. Fault site: ``data.file_read``.
- Shuffle modes: "none", "local" (a permutation for the seed and pass),
  and the global modes "search_id", "ins_id" and "random": with a
  ``LocalShuffleRouter`` the datasets of several in-process nodes route
  their records (``shuffle_route``) and exchange them, then permute what
  they received; alone (``nranks`` 1, no router) a global mode is a local
  permutation, as in the JAX package. ``slots_shuffle`` runs the AUC
  runner's slot-shuffle eval (``metrics/auc_runner.py``).
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

Spans (``utils/trace.py``): ``boundary.premerge``, ``boundary.stage_pull``,
``boundary.writeback_kick``, ``boundary.end_pass_worker`` and
``data.quarantine.dead_letter``.

Over several hosts (``transport=``, a ``parallel.transport.TcpTransport``
whose rank is this dataset's ``rank`` of ``nranks``) the dataset is one
host's: it reads its stripe of the files and, in the global shuffle modes,
routes records through a ``TcpShuffleRouter``. The port runs one process
a card, so a host is one mesh rank: its transport rank is its mesh rank
and it owns mesh shard ``rank``. The pass's working set is a
``DistributedWorkingSet`` (``table/dist_ws.py``): keys are exchanged with
their owners at ``begin_pass``, which returns this host's block [1, cap,
width], and the host table holds only this host's keys. The counts every
host must agree on go over the transport: ``num_batches`` all-reduces
the batch count (the short host wraps around), ``num_pv_batches(
global_count=True)`` the join phase's, ``end_pass`` the carry decision
(``carry-gate``; a carried block is a ``MultiHostCarrier``), and the
trainer the pad shapes. ``revert_pass`` bumps ``pass_epoch`` and discards
the aborted attempt's exchange frames. A ``PassSupervisor`` over several
hosts votes on each load, poison verdict and pass over the transport; its
elastic membership installs a shrunk or grown ``ownership`` here.
"""

from __future__ import annotations

import hashlib
import itertools
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from paddlebox_tpu_torch import config
from paddlebox_tpu_torch.data.parser import parse_line
from paddlebox_tpu_torch.data.quarantine import (
    DataPoisonedError,
    QuarantineLog,
    resolve_quarantine_dir,
)
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
from paddlebox_tpu_torch.utils.fs import fs_glob, fs_read_bytes_retry
from paddlebox_tpu_torch.utils.line_reader import BufferedLineFileReader
from paddlebox_tpu_torch.utils.monitor import STAT_ADD, STAT_OBSERVE, STAT_SET
from paddlebox_tpu_torch.utils.trace import record_event

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

_SHUFFLE_MODES = ("none", "local", "search_id", "ins_id", "random")


def _ins_id_dest(ins_id: str, n_parts: int) -> int:
    # the reference hashes with xxhash; blake2b keeps the JAX package's routing
    return int.from_bytes(hashlib.blake2b(ins_id.encode(), digest_size=8).digest(), "little") % n_parts


def shuffle_route(records: Sequence[SlotRecord], n_parts: int, mode: str, seed: int) -> List[int]:
    """Destination part of each record (ShuffleData routing,
    data_set.cc:1772-1791): "search_id" keeps a query's ads on one node,
    "ins_id" spreads by an instance hash, "random" is uniform."""
    if mode == "search_id":
        return [r.search_id % n_parts for r in records]
    if mode == "ins_id":
        return [_ins_id_dest(r.ins_id, n_parts) for r in records]
    if mode == "random":
        return list(np.random.default_rng(seed).integers(0, n_parts, len(records)))
    raise ValueError(f"unknown shuffle mode {mode!r}")


def shuffle_route_store(store: ColumnarRecords, n_parts: int, mode: str, seed: int) -> np.ndarray:
    """``shuffle_route`` over a columnar store: an int64 destination array."""
    n = len(store)
    if mode == "search_id":
        return (store.search_ids % np.uint64(n_parts)).astype(np.int64)
    if mode == "ins_id":
        return np.array([_ins_id_dest(store.ins_id(i), n_parts) for i in range(n)], np.int64)
    if mode == "random":
        return np.random.default_rng(seed).integers(0, n_parts, n)
    raise ValueError(f"unknown shuffle mode {mode!r}")


class LocalShuffleRouter:
    """The shuffle exchange between ``n_nodes`` datasets of one process
    (the in-process form of ``boxps::PaddleShuffler``). A chunk is a
    ``List[SlotRecord]`` or a ``ColumnarRecords``; the dataset normalizes
    what it collects. A node collects its chunks in the order of the
    nodes that sent them, whatever order their threads exchanged in (the
    JAX package's router keeps arrival order, so its records' order
    follows the thread race)."""

    def __init__(self, n_nodes: int):
        self.n_nodes = n_nodes
        self._inboxes: List[list] = [[] for _ in range(n_nodes)]  # guarded-by: _cond
        self._cond = threading.Condition()
        self._done = 0  # guarded-by: _cond
        self._collected = 0  # guarded-by: _cond

    def exchange(self, from_node: int, parts: list) -> None:
        """Deliver this node's chunks (one per destination) and mark it
        done sending. A node that races into the next pass waits here until
        every node collected the current one, so passes never mix."""
        with self._cond:
            self._cond.wait_for(lambda: self._done < self.n_nodes)
            for dst, chunk in enumerate(parts):
                if len(chunk):
                    self._inboxes[dst].append((from_node, chunk))
            self._done += 1
            self._cond.notify_all()

    def collect(self, node: int) -> list:
        """Wait until every node exchanged, then take this node's chunks."""
        with self._cond:
            self._cond.wait_for(lambda: self._done >= self.n_nodes)
            out = [chunk for _, chunk in sorted(self._inboxes[node], key=lambda fc: fc[0])]
            self._inboxes[node] = []
            self._collected += 1
            if self._collected >= self.n_nodes:  # re-arm for the next pass
                self._done = 0
                self._collected = 0
                self._cond.notify_all()
        return out


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
    """Counts of one pass's load, alike on the native and Python tiers:
    ``lines`` every non-empty line seen (parsed + benign + bad),
    ``parsed`` the lines that gave a record, ``skipped_benign`` the lines
    the parser returned None for (a record without feasigns, a '#' cache
    line), ``bad_lines`` the quarantined parse failures, ``bad_files`` the
    part files skipped whole (unreadable, truncated, a dead converter)."""

    files: int = 0
    lines: int = 0
    records: int = 0  # records kept for the pass
    keys: int = 0  # unique feasigns in the working set (set at begin_pass)
    parsed: int = 0
    skipped_benign: int = 0
    bad_lines: int = 0
    bad_files: int = 0
    bad_by_file: Dict[str, int] = field(default_factory=dict)
    dead_letter: Optional[str] = None
    # the load's wall seconds: reading and parsing the files, the shuffle
    # (concatenation and permutation), feeding the working set its keys
    read_s: float = 0.0
    shuffle_s: float = 0.0
    keys_s: float = 0.0


def _feed_keys(ws, store: Optional[ColumnarRecords], records: List[SlotRecord]):
    """Feed a fresh working set every feasign of the pass (MergeInsKeys
    parity), from the columnar store or else the record list."""
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
        rank: int = 0,
        nranks: int = 1,
        router: Optional[LocalShuffleRouter] = None,
        transport=None,
        pipe_command: Optional[str] = None,
        line_parser: Optional[Callable[[str, SlotSchema], Optional[SlotRecord]]] = None,
        drop_remainder: bool = True,
        quarantine_dir: Optional[str] = None,
    ):
        if shuffle_mode not in _SHUFFLE_MODES:
            raise ValueError(f"shuffle_mode {shuffle_mode!r} not in {_SHUFFLE_MODES}")
        if nranks > 1 and router is None and transport is None:
            raise ValueError(
                "nranks > 1 stripes the files over several nodes: give them a "
                "LocalShuffleRouter (nodes of one process) or a transport (several hosts)"
            )
        if transport is not None and (
            getattr(transport, "n_ranks", None) != nranks or getattr(transport, "rank", None) != rank
        ):
            raise ValueError(
                f"the transport must be rank {rank} of {nranks}, as the dataset is "
                f"(got {getattr(transport, 'rank', None)} of {getattr(transport, 'n_ranks', None)})"
            )
        self.schema = schema
        self.table = table
        self.batch_size = batch_size
        self.read_threads = read_threads
        self.shuffle_mode = shuffle_mode
        self.seed = seed
        # this node's slice of the file list (rank-strided) and, with a
        # router, its place in the in-process shuffle exchange
        self.rank = rank
        self.nranks = nranks
        self.router = router
        # the host plane over several hosts (None: one host)
        self.transport = transport
        # bumped by every revert_pass: scopes the working-set exchange tags
        # so a retried pass never consumes the aborted attempt's frames
        self.pass_epoch = 0
        # the key-ownership map (parallel.membership.OwnershipMap); None =
        # the even split over every transport rank
        self.ownership = None
        # lockstep bookkeeping: the load generation (bumped by every
        # publish), the agreed batch count of (pass, generation), and the
        # carry gate's round counter
        self._load_gen = 0
        self._nb_lockstep = None
        self._carry_seq = 0
        self.pipe_command = pipe_command
        self.line_parser = line_parser or parse_line
        self.drop_remainder = drop_remainder
        # where dead-letter files land (None: the data_quarantine_dir flag,
        # then a temp dir); a PassSupervisor with a checkpoint sets
        # <checkpoint root>/quarantine
        self.quarantine_dir = quarantine_dir
        self._dead_letter_seq = 0  # written by the one load in flight
        self._loading_qlog: Optional[QuarantineLog] = None  # the load in flight's
        self._stats_lock = threading.Lock()
        self._loading_stats = PassStats()  # guarded-by: _stats_lock
        self._auc_runner = None  # the pass's AucRunner, built by slots_shuffle
        self._auc_runner_pass = None
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
        """The part files of the pass (glob patterns expand in sorted
        order); this node reads its rank-strided slice (dualbox striping,
        data_set.cc:1452-1464)."""
        expanded: List[str] = []
        for f in files:
            expanded.extend(fs_glob(f) if any(c in f for c in "*?[") else [f])
        self._filelist = expanded[self.rank :: self.nranks]

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
        """Join-phase batch count; ``global_count`` all-reduces (max) it
        over the transport, so every host runs the same number of mesh
        collectives (the pv analog of ``num_batches``'s lockstep,
        compute_thread_batch_nccl parity, data_set.cc:2069-2135). Without
        a transport spanning hosts it is the local count."""
        self._need_pvs()
        n = count_pv_batches(self.pvs, self.batch_size, n_devices=n_devices)
        if global_count and self.multi_host:
            n = self.transport.allreduce_max(n, f"pv-count:{self.pass_id}")
        return n

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

    def _native_eligible(self, path: str) -> bool:
        """The native tier takes a file when nothing needs the line-by-line
        reader: no pipe converter, the stock parser, every line kept, a
        local plain path."""
        return (
            self.pipe_command is None
            and self.line_parser is parse_line
            and config.get_flag("sample_rate") >= 1.0
            and bool(config.get_flag("enable_native_parser"))
            and not path.startswith(("hdfs:", "afs:"))
            and not path.endswith(".gz")
        )

    def _parse_lines(self, path: str, numbered_lines, qlog) -> list:
        """Parse (line_no, line) pairs with per-line quarantine: the one
        line-accounting path of the Python tier and of the native tier's
        corrupt-buffer fallback, so both count alike."""
        out = []
        n_lines = n_parsed = n_benign = 0
        for line_no, line in numbered_lines:
            if not line:
                continue
            n_lines += 1
            try:
                rec = self.line_parser(line, self.schema)
            except Exception as e:  # quarantined and counted
                if qlog is None:  # strict mode: the first bad line raises
                    raise
                qlog.quarantine_line(path, line_no, line, e)
                continue
            if rec is None:
                n_benign += 1
            else:
                n_parsed += 1
                out.append(rec)
        with self._stats_lock:
            st = self._loading_stats
            st.lines += n_lines
            st.parsed += n_parsed
            st.skipped_benign += n_benign
        return out

    def _read_one(self, path: str):
        """One part file -> a ColumnarRecords chunk (native tier) or a
        SlotRecord list (Python tier). With quarantine on, a file that
        fails as a whole (unreadable, truncated gz, a dead converter) is
        quarantined and gives an empty chunk, except a missing file: that
        is a transient fault the fs retry tier owns, and dropping it would
        starve the pass quietly."""
        qlog = self._loading_qlog
        try:
            fire("data.file_read")
            return self._read_one_inner(path, qlog)
        except FileNotFoundError:
            raise
        except Exception as e:  # quarantined and counted
            if qlog is None:
                raise
            qlog.quarantine_file(path, e)
            # an empty columnar chunk keeps a pass that could be columnar so
            if self._native_eligible(path):
                return ColumnarRecords.empty(self.schema.num_sparse, self.schema.num_float)
            return []

    def _read_one_inner(self, path: str, qlog):
        if self._native_eligible(path):
            from paddlebox_tpu_torch.utils import native

            data = fs_read_bytes_retry(path)
            nstats: dict = {}
            try:
                chunk = native.parse_buffer_columnar(data, self.schema, nstats)
            except ValueError:
                if qlog is None:
                    raise
                # the native parser rejects the whole buffer at its first
                # bad line: re-parse line by line so each bad line is
                # quarantined alone, and re-wrap columnar
                recs = self._parse_lines(
                    path, enumerate(data.decode("utf-8", errors="replace").splitlines(), 1), qlog
                )
                return ColumnarRecords.from_records(recs, self.schema)
            with self._stats_lock:
                st = self._loading_stats
                skipped = nstats.get("skipped", 0)
                st.lines += len(chunk) + skipped
                st.parsed += len(chunk)
                st.skipped_benign += skipped
            return chunk
        # a per-file seed decorrelates the sampling of part files. The JAX
        # package's expression, copied so both packages keep the same lines
        # within one process; str hashes change from process to process
        # (ROADMAP Queue 3)
        seed = hash((self.seed, self.pass_id, path)) & 0x7FFFFFFF
        begin_file = getattr(self.line_parser, "begin_file", None)
        if begin_file is not None:  # per-file parser state (cache lines)
            begin_file(path)
        reader = BufferedLineFileReader(path, converter=self.pipe_command, seed=seed)
        # lines_read counts before the reader yields: the 1-based number of
        # the line in flight
        return self._parse_lines(path, ((reader.lines_read, line) for line in reader), qlog)

    def _shuffle_records(self, records: List[SlotRecord]) -> List[SlotRecord]:
        mode = self.shuffle_mode
        if mode == "none":
            return records
        rng = np.random.default_rng(self.seed + self.pass_id)
        if mode != "local" and self.router is not None:
            dests = shuffle_route(records, self.router.n_nodes, mode, self.seed + self.pass_id)
            parts: List[List[SlotRecord]] = [[] for _ in range(self.router.n_nodes)]
            for r, d in zip(records, dests):
                parts[d].append(r)
            self.router.exchange(self.rank, parts)
            records = [
                r
                for chunk in self.router.collect(self.rank)
                for r in (chunk.records() if isinstance(chunk, ColumnarRecords) else chunk)
            ]
        elif mode != "local" and self.nranks != 1:
            raise RuntimeError("a global shuffle over several nodes needs a router")
        order = rng.permutation(len(records))
        return [records[i] for i in order]

    def _shuffle_store(self, store: ColumnarRecords):
        """Columnar shuffle: routing moves arrays between nodes; the local
        order is a permutation of the store (no data moved), the same one
        ``_shuffle_records`` applies to a record list."""
        mode = self.shuffle_mode
        if mode == "none":
            return store, None, []
        rng = np.random.default_rng(self.seed + self.pass_id)
        if mode != "local" and self.router is not None:
            n = self.router.n_nodes
            dests = shuffle_route_store(store, n, mode, self.seed + self.pass_id)
            self.router.exchange(self.rank, [store.select(np.nonzero(dests == d)[0]) for d in range(n)])
            chunks = self.router.collect(self.rank)
            cols = [c for c in chunks if isinstance(c, ColumnarRecords)]
            lists = [c for c in chunks if not isinstance(c, ColumnarRecords)]
            if lists:  # a node sent records: the pass becomes a record list
                records = [r for c in lists for r in c]
                for c in cols:
                    records.extend(c.records())
                order = rng.permutation(len(records))
                return None, None, [records[i] for i in order]
            store = (
                ColumnarRecords.concat(cols) if len(cols) > 1
                else cols[0] if cols else ColumnarRecords.empty(store.n_sparse, store.n_float)
            )
        elif mode != "local" and self.nranks != 1:
            raise RuntimeError("a global shuffle over several nodes needs a router")
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
        """Threaded read (with quarantine) -> shuffle -> staged pass data
        and working-set keys, then the boundary feed stage
        (:meth:`_stage_boundary_prefetch`).

        Loads into a staging slot, so it can run while the previous pass
        trains; ``begin_pass`` consumes it. When no pass is open the load
        is published at once, so ``memory_data_size`` and ``records`` show
        it."""
        if self._staged is not None:
            raise RuntimeError("staged pass not yet consumed by begin_pass")
        if self._preload_thread is not None and threading.current_thread() is not self._preload_thread:
            raise RuntimeError("preload in flight; wait_preload_done first")
        stats = PassStats(files=len(self._filelist))
        with self._stats_lock:
            self._loading_stats = stats
        self._loading_qlog = QuarantineLog() if config.get_flag("data_quarantine") else None
        if any(self._native_eligible(p) for p in self._filelist):
            from paddlebox_tpu_torch.utils import native

            # a native tier that cannot build raises here, never as a
            # quarantined file
            native.load()
        parts: list = []
        t0 = time.perf_counter()
        try:
            if self._filelist:
                with ThreadPoolExecutor(max_workers=max(1, self.read_threads)) as pool:
                    parts = list(pool.map(self._read_one, self._filelist))
        finally:
            qlog, self._loading_qlog = self._loading_qlog, None
        if qlog is not None:
            self._settle_quarantine(stats, qlog)
        t1 = time.perf_counter()
        store, order, records = self._normalize_and_shuffle(parts)
        t2 = time.perf_counter()
        ws = _feed_keys(self._new_working_set(), store, records)
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
        with record_event("boundary.premerge", "boundary"):
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
            # a pass over several hosts learns its owned keys only in the
            # exchange: nothing to prefetch from this host's table
            or not isinstance(ws, PassWorkingSet)
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
        with record_event("boundary.stage_pull", "boundary"):
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

    # ---- quarantine and admission ------------------------------------------

    def _settle_quarantine(self, stats: PassStats, qlog: QuarantineLog) -> None:
        """Fold the load's quarantine log into its PassStats, write the
        dead-letter file when anything was quarantined, and set the
        ``data.quarantine.*`` gauges."""
        qlog.settle(stats)
        if qlog.total:
            self._dead_letter_seq += 1
            name = f"pass-{self.date or 'na'}-{self.pass_id:04d}-r{self.rank}-{self._dead_letter_seq:03d}"
            with record_event("data.quarantine.dead_letter", "data"):
                stats.dead_letter = qlog.write(
                    resolve_quarantine_dir(self.quarantine_dir),
                    name,
                    meta={
                        "date": self.date, "pass_id": self.pass_id, "rank": self.rank,
                        "files": stats.files, "lines": stats.lines,
                    },
                )
            STAT_ADD("data.quarantine.dead_letter_files")
        STAT_SET("data.quarantine.bad_lines", stats.bad_lines)
        STAT_SET("data.quarantine.bad_files", stats.bad_files)
        if stats.bad_lines:
            STAT_ADD("data.quarantine.bad_lines_total", stats.bad_lines)
        if stats.bad_files:
            STAT_ADD("data.quarantine.bad_files_total", stats.bad_files)

    def admission_report(self) -> Dict:
        """The bounded-loss verdict for the pass about to begin (the staged
        load when one is pending, else the live one): ``poisoned`` when
        quarantine is on and a corrupt fraction passes its threshold
        (``max_bad_line_fraction``, ``max_bad_file_fraction``)."""
        st = self._staged[4] if self._staged is not None else self.stats
        max_lf = float(config.get_flag("max_bad_line_fraction"))
        max_ff = float(config.get_flag("max_bad_file_fraction"))
        lf = st.bad_lines / max(1, st.lines)
        ff = st.bad_files / max(1, st.files)
        poisoned = bool(config.get_flag("data_quarantine")) and (lf > max_lf or ff > max_ff)
        parts = []
        if lf > max_lf:
            parts.append(
                f"{st.bad_lines}/{st.lines} lines quarantined ({lf:.5f} > max_bad_line_fraction {max_lf:.5f})"
            )
        if ff > max_ff:
            parts.append(
                f"{st.bad_files}/{st.files} part files quarantined ({ff:.5f} > max_bad_file_fraction {max_ff:.5f})"
            )
        detail = ""
        if poisoned:
            detail = "pass data poisoned: " + "; ".join(parts)
            if st.dead_letter:
                detail += f"; dead-letter: {st.dead_letter}"
        return {
            "poisoned": poisoned, "detail": detail, "line_fraction": lf, "file_fraction": ff,
            "bad_lines": st.bad_lines, "bad_files": st.bad_files, "lines": st.lines,
            "files": st.files, "dead_letter": st.dead_letter,
        }

    def check_admission(self) -> Dict:
        """Raise DataPoisonedError when the pending pass is over the
        thresholds; the report otherwise."""
        rep = self.admission_report()
        if rep["poisoned"]:
            raise DataPoisonedError(rep["detail"], report=rep, dead_letter=rep["dead_letter"])
        return rep

    def drop_pass_data(self) -> None:
        """Abandon the loaded pass that was not begun (the supervisor's
        ``skip_pass``): the staged slot, the published records and the
        working set go; the table is untouched."""
        self.discard_staged()
        if not self._in_pass:
            self.store = None
            self._order = None
            self._records = []
            self.ws = None
            self.stats = PassStats()

    def _publish(self, staged) -> None:
        with self._pass_lock:
            self.store, self._order, self._records, self.ws, self.stats = staged
            # new data in memory: the lockstep batch count is agreed anew
            self._load_gen += 1

    @property
    def multi_host(self) -> bool:
        """True when a transport spans several hosts."""
        return self.transport is not None and self.transport.n_ranks > 1

    def _new_working_set(self):
        """A fresh (not finalized) working set for this pass: the
        key-exchange flavor when a transport spans hosts, else local. The
        load and revert_pass share it, so their retrains never diverge."""
        if self.multi_host:
            from paddlebox_tpu_torch.table.dist_ws import DistributedWorkingSet

            # n_mesh_shards is the GLOBAL shard count; ``ownership`` pins
            # the key routing (None: the even split over every rank)
            return DistributedWorkingSet(
                self.transport, self.n_mesh_shards, pass_id=self.pass_id,
                epoch=self.pass_epoch, ownership=self.ownership,
            )
        return PassWorkingSet(n_mesh_shards=self.n_mesh_shards)

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

    def begin_pass(self, round_to: int = 512, enable_revert: bool = False, trainer=None, admit_poisoned: bool = False):
        """Consume the staged load, finalize the working set against the
        host table, and return the pass table for the device
        (BeginFeedPass + EndFeedPass + BeginPass): a numpy [1, cap, width]
        array, or after a carried boundary the spliced tensor on the
        carrier's device. Joins a pending end_pass first.

        ``enable_revert=True`` drains the pending carriers and arms a
        PassGuard (Confirm/Revert parity, fleet_wrapper.h:319-321): the
        pass keys' pre-train rows and, with ``trainer``, its dense params
        and optimizer state are snapshotted so :meth:`revert_pass` can
        reject everything the pass publishes; end_pass confirms.

        The admission gate: a pass whose load quarantined more than the
        thresholds allow raises :class:`DataPoisonedError` before anything
        is finalized or armed, its staged data kept, unless
        ``admit_poisoned`` (the supervisor's ``degrade`` policy)."""
        # a pending end_pass writes the host table; finalize reads it
        self.wait_end_pass()
        self._raise_pending_flush_error()
        if self._in_pass:
            raise RuntimeError(
                "previous pass is still open: call end_pass (or, after a failed "
                "end_pass, retry it or revert_pass) first"
            )
        if not admit_poisoned:
            self.check_admission()
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
            if self.multi_host:
                # the rows this host's writeback touches are the pass keys
                # it owns, whichever host referenced them; the keys its own
                # records reference live on their owners' tables (a
                # snapshot of those would create them here and miss the
                # owned keys only a peer referenced)
                owned = self.ws.owned_shard_keys
                self._guard.begin(np.concatenate(owned) if owned else np.zeros(0, np.uint64))
            else:
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
                with record_event("boundary.writeback_kick", "boundary"):
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
        # a new epoch for the retrain: the aborted attempt's exchange frames
        # still in flight must never reach the retried exchange
        self.pass_epoch += 1
        if self.transport is not None:
            self.transport.discard_epochs_below(self.pass_epoch)
        self.ws = _feed_keys(self._new_working_set(), self.store, self._records)
        if self.store is not None:
            self.store.invalidate_rows()  # its rows resolved against the old set
        self.device_table = None
        self._in_pass = False
        self._auc_runner = None

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
        carry_ok = (
            isinstance(trained_table, torch.Tensor)
            and trained_table.dim() in (2, 3)
            and bool(config.get_flag("enable_carried_table"))
            and guard is None
            and kick is None
        )
        if isinstance(ws, PassWorkingSet):
            # a mesh carrier flushes with collectives, which the worker's
            # save_delta must not run: the shard goes back the classic way
            if carry_ok and not (shard and need_save_delta):
                # the worker's decay_and_shrink notes the decay on the carrier
                carrier = TableCarrier(trained_table, ws, table.layout, plan=self.mesh_plan if shard else None)
        else:
            # over several hosts the carry decision is locksteped, so every
            # host takes the same boundary: the round runs for every pass,
            # since a host that cannot carry must still answer
            from paddlebox_tpu_torch.table.carrier import MultiHostCarrier

            self._carry_seq += 1
            agree = -ws.transport.allreduce_max(-int(carry_ok), f"carry-gate:{self._carry_seq}")
            if agree:
                # this host's block: splice, departures and flush stay local
                carrier = MultiHostCarrier(
                    trained_table, ws.owned_shard_keys, table.layout, ownership_epoch=ws.ownership.epoch
                )
        if carrier is not None:
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
        self._auc_runner = None  # its pools hold this pass's records

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
                with record_event("boundary.end_pass_worker", "boundary"):
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
        if not isinstance(trained_table, torch.Tensor) or not isinstance(ws, PassWorkingSet) or ws.n_mesh_shards == 1:
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

    def num_batches(self, global_count: Optional[int] = None) -> int:
        """Minibatches in this pass: the full ones, and with
        ``drop_remainder`` off one more for a remainder (served wrapped
        around). Over several hosts the local count is all-reduced (max)
        over the transport (compute_thread_batch_nccl parity,
        data_set.cc:2069-2135), once a (pass, load): every host runs the
        same count and the short one wraps around. ``global_count``
        overrides it with a count agreed elsewhere."""
        if global_count is not None:
            return global_count
        n = self.memory_data_size()
        local = n // self.batch_size + (0 if self.drop_remainder or not n % self.batch_size else 1)
        if not self.multi_host:
            return local
        # the cache key is alike on every host (pass and load generation
        # advance in lockstep); a key on the LOCAL count would let one host
        # skip the round another enters
        key = (self.pass_id, self._load_gen)
        if self._nb_lockstep is not None and self._nb_lockstep[0] == key:
            return self._nb_lockstep[1]
        agreed = self.transport.allreduce_max(local, f"nb:{key[0]}:{key[1]}")
        self._nb_lockstep = (key, agreed)
        return agreed

    # ---- the AUC runner's slot-shuffle eval ------------------------------

    def slots_shuffle(self, slots) -> dict:
        """Replace ``slots``' feasigns in the pass's records with pooled
        candidates, for feature-importance eval (BoxPSDataset.slots_shuffle,
        python dataset.py:1191-1210 -> BoxHelper::SlotsShuffle). The
        AucRunner is built on first use in a pass over every used sparse
        slot (pool capacity ``auc_runner_pool_size``, seed seed + pass_id);
        an empty ``slots`` restores the records. A store-backed pass is
        rebuilt from the rewritten records (the shuffle order baked in),
        so the columnar feeds serve the shuffled keys; the candidates come
        from the pass's own records, so they resolve in its working set."""
        from paddlebox_tpu_torch.metrics.auc_runner import AucRunner

        if not self.records:
            raise RuntimeError("slots_shuffle needs in-memory records")
        recs = self.records  # materializes the store's view
        runner = self._auc_runner
        if runner is None or self._auc_runner_pass != self.pass_id:
            runner = AucRunner(
                self.schema,
                replaced_slots=[s.name for s in self.schema.used_sparse],
                capacity=int(config.get_flag("auc_runner_pool_size")),
                seed=self.seed + self.pass_id,
            )
            runner.observe(recs)
            self._auc_runner = runner
            self._auc_runner_pass = self.pass_id
        out = runner.slots_shuffle(recs, set(slots))
        if self.store is not None:
            self.store = ColumnarRecords.from_records(recs, self.schema)
            self._order = None
            self.store.invalidate_rows()
        return out

    @property
    def auc_runner_phase(self) -> int:
        """The AucRunner's phase (flips at every slots_shuffle), 1 without one."""
        return self._auc_runner.phase if self._auc_runner is not None else 1

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
