"""Host key -> row store and the pass-scoped device working set.

Port of the JAX package's ``table/sparse_table.py``:

- ``HostSparseTable``: the host store, sharded by key hash across
  ``n_shards``. By default it is the native C++ store
  (``csrc/host_table.cc`` through ``utils/native.py``), whose new rows are
  a pure function of (seed, key); with ``PBOX_NATIVE_TABLE=0`` it is the
  pure-Python store of lock-protected dict shards, whose new rows come
  from ``np.random.default_rng(seed)`` in pull order. Either gives the
  same bits as the JAX package's store of the same kind: pull-or-create,
  full-row push, the pass-boundary decay and shrink, and the saves. When
  the native store is asked for and cannot be built, construction raises.
  With ``spill_dir`` (native store only) cold rows go to per-shard disk
  files and come back on their next pull with the decays they missed
  (the disk tier; ``mem_cap_rows`` bounds the memory tier at pass end).
- persistence: ``save_base`` writes every key, ``save_delta`` the keys
  pushed since the last save, ``save_cache`` / ``save_with_whitelist`` a
  filtered cut; ``load`` reads a base and ``apply_delta`` a delta on top,
  catching up the decays the rows already held lived through. A save dir
  is ``meta.json`` plus ``shard-NNNNN.npz`` ({keys, values}) per shard, the
  JAX package's format, so either package loads the other's saves.
- ``PassWorkingSet``: every feasign of a batch (or a pass) is fed in with
  :meth:`~PassWorkingSet.add_keys`; :meth:`~PassWorkingSet.finalize` dedups,
  pulls the rows from a host row source and lays them out as one dense
  ``[n_mesh_shards, capacity, width]`` fp32 array, which the caller copies
  to the device in one transfer. Keys map to (mesh_shard, row) by hash, so
  the device-side pull/push is a static-shape gather/scatter.
  :meth:`~PassWorkingSet.writeback` pushes the trained rows back, in
  chunks through the native store's writer pool.
- lookup: batch keys -> dense row ids happens host-side at pack time
  (vectorized searchsorted over the sorted key table), so no hash table ever
  lives on the device.
- the device-carried boundary (``table/carrier.py``): the table registers
  the carriers it is owed (:meth:`~HostSparseTable.add_pending_carrier`),
  notes each boundary's decay on them and drains them before every save
  (:meth:`~HostSparseTable.drain_pending`; a save that would reach a
  pending mesh carrier raises, see there); ``finalize(carrier=...)``
  splices the rows of keys that stay on the device (the port's row gather
  and row writeback kernels), pushes the departing rows and uploads only
  the new ones. ``finalize(prefetch=...)`` takes the rows the dataset's
  feed stage pulled while the previous pass trained
  (:meth:`~HostSparseTable.prefetch_rows`), and ``writeback(cancel=...)``
  stops at a chunk boundary when a revert asks.

Each mesh shard reserves its last row as the padding row (zero, never
written back): batch padding targets it.

With the adaptive mesh wire engaged (``ops/wire_quant.py``),
``finalize`` publishes ``PassWorkingSet.hot_rows``, a bool a row: the
row's decayed show reaches ``ici_hot_show``. The classic finalize reads the
show column of the rows it pulled, the spliced one the host table's
``shows_peek`` (side-effect free, maybe a pass stale).

Spans (``utils/trace.py``): ``boundary.dedup``, ``boundary.pull`` and
``boundary.splice`` in ``finalize``.

Over several hosts the pass working set is ``table/dist_ws.py``'s
``DistributedWorkingSet`` (its carrier ``table/carrier.py``'s
``MultiHostCarrier``): the same layout, each host holding its own keys.
"""

from __future__ import annotations

import json
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from paddlebox_tpu_torch import config
from paddlebox_tpu_torch.table.optimizers import SparseOptimizerConfig
from paddlebox_tpu_torch.table.value_layout import ValueLayout
from paddlebox_tpu_torch.utils.faultinject import InjectedFault
from paddlebox_tpu_torch.utils.faultinject import fire as _fault_fire
from paddlebox_tpu_torch.utils.fs import atomic_write
from paddlebox_tpu_torch.utils.monitor import STAT_ADD, STAT_OBSERVE, STAT_SET
from paddlebox_tpu_torch.utils.trace import record_event

config.define_flag(
    "boundary_merge_threads", 4,
    "threads for the chunked pass-boundary key merge; <=1 falls back to "
    "the serial np.unique(np.concatenate(...))",
)
config.define_flag(
    "spill_policy", "freq",
    "victim selection for the memory->disk cap sweep (maybe_spill): 'freq' "
    "ranks rows by coldness (lowest decayed show first, the oldest "
    "last-touched epoch breaking ties), honours spill_pin_show and "
    "spill_admit_show and balances the sweep across shards; 'fifo' is the "
    "creation-order sweep (untouched rows first)",
)
config.define_flag(
    "spill_pin_show", 0.0,
    "freq policy pin threshold: rows whose decayed show is >= this are "
    "never spilled while a colder victim exists in their shard (0 disables "
    "pinning)",
)
config.define_flag(
    "spill_admit_show", 0.0,
    "freq policy admission threshold: at sweep time every row whose "
    "decayed show is under this goes to disk at once instead of holding a "
    "memory slot until the cap evicts it (0 disables admission)",
)
config.define_flag(
    "writeback_threads", 4,
    "writer-pool size for the end-of-pass host-table writeback "
    "(PassWorkingSet.writeback -> pbx_table_push_mt): each worker owns a "
    "disjoint set of shards, bitwise-equal to the serial path; <=1 is the "
    "serial path (plain table.push)",
)
config.define_flag(
    "writeback_chunk_keys", 2_000_000,
    "keys per writeback chunk: the trained rows are gathered and pushed "
    "chunk by chunk so the next chunk's gather overlaps the push in flight",
)

_HASH_MULT = np.uint64(0x9E3779B97F4A7C15)

# below this many total keys the serial merge wins (thread dispatch costs
# more than the merge itself)
_MERGE_SERIAL_FLOOR = 262_144


def merge_unique_keys(
    chunks: Sequence[np.ndarray], threads: int = 1
) -> np.ndarray:
    """Sorted-unique union of sorted-unique uint64 chunks.

    Bitwise-identical to ``np.unique(np.concatenate(chunks))``, but large
    merges run over deterministic key ranges in a thread pool: pivots are
    quantiles of a sorted strided sample of the chunks, every chunk is sliced
    at those pivots with searchsorted, each range unions its slices
    independently, and the per-range results concatenate back in ascending
    range order. A single non-empty chunk is returned as it is (no copy).
    """
    chunks = [c for c in chunks if len(c)]
    if not chunks:
        return np.zeros(0, dtype=np.uint64)
    if len(chunks) == 1:
        return chunks[0]
    total = sum(len(c) for c in chunks)
    threads = int(threads)
    if threads <= 1 or total < _MERGE_SERIAL_FLOOR:
        return np.unique(np.concatenate(chunks))
    n_ranges = min(threads, 16)
    sample = np.sort(
        np.concatenate([c[:: max(1, len(c) // 64)] for c in chunks])
    )
    pivots = sample[(np.arange(1, n_ranges) * len(sample)) // n_ranges]
    bounds = [np.searchsorted(c, pivots, side="left") for c in chunks]

    def _one_range(r: int) -> np.ndarray:
        parts = []
        for ci, c in enumerate(chunks):
            lo = int(bounds[ci][r - 1]) if r else 0
            hi = int(bounds[ci][r]) if r < n_ranges - 1 else len(c)
            if hi > lo:
                parts.append(c[lo:hi])
        if not parts:
            return np.zeros(0, dtype=np.uint64)
        return np.unique(np.concatenate(parts))

    with ThreadPoolExecutor(
        max_workers=n_ranges, thread_name_prefix="key-merge"
    ) as ex:
        ranges = [r for r in ex.map(_one_range, range(n_ranges)) if len(r)]
    if not ranges:
        return np.zeros(0, dtype=np.uint64)
    return np.concatenate(ranges)


def key_to_shard(keys: np.ndarray, n_shards: int) -> np.ndarray:
    """Mesh/host shard of each key: multiplicative hash then modulo.

    Feasigns are already hashes in production, but cheap mixing keeps
    adversarial/test keys balanced too.
    """
    with np.errstate(over="ignore"):
        mixed = keys.astype(np.uint64) * _HASH_MULT
    return (mixed >> np.uint64(33)).astype(np.int64) % n_shards


class SpillIOError(IOError):
    """Typed disk-tier failure from the spill entry points.

    The native store returns -1 (tier disabled) or -2 (IO failure) from
    ``spill_cold`` / ``compact_spill``; this carries the failing op and the
    raw code, so a caller can never read a code as a row count. Every raise
    is counted under the ``table.spill_errors`` stat.
    """

    def __init__(self, op: str, rc: int, detail: str = ""):
        msg = f"spill tier {op} failed rc={rc}"
        if detail:
            msg = f"{msg} ({detail})"
        super().__init__(msg)
        self.op = op
        self.rc = rc


class WritebackCancelled(RuntimeError):
    """A chunked writeback stopped at a chunk boundary (the revert path).

    Not an error: the chunks already pushed are a partial writeback, which
    a PassGuard revert undoes. Carries how far the writeback got."""

    def __init__(self, done_keys: int, total_keys: int):
        super().__init__(
            f"writeback cancelled at chunk boundary ({done_keys}/{total_keys} keys pushed)"
        )
        self.done_keys = done_keys
        self.total_keys = total_keys


# flag value -> native policy code (csrc/host_table.cc kSpillFifo/kSpillFreq)
_SPILL_POLICY_CODES = {"fifo": 0, "freq": 1}


class _Shard:
    """One lock-protected hash shard of the host store."""

    __slots__ = ("index", "values", "lock", "touched")

    def __init__(self, width: int):
        self.index: Dict[int, int] = {}  # guarded-by: lock
        self.values = np.zeros((0, width), dtype=np.float32)  # guarded-by: lock
        self.lock = threading.Lock()
        # keys pushed since the last delta save; a set, as in the JAX
        # package, so a delta lists its rows in the same order
        self.touched: set = set()  # guarded-by: lock


def _grown(values: np.ndarray, need: int) -> np.ndarray:
    """A shard's values with room for ``need`` rows: ``values`` itself, or a
    copy at least twice as long. The caller holds the shard's lock and
    stores the result as the shard's values."""
    cap = len(values)
    if need <= cap:
        return values
    nv = np.zeros((max(1024, cap * 2, need), values.shape[1]), dtype=np.float32)
    nv[:cap] = values
    return nv


class HostSparseTable:
    """Host sharded key -> fp32 row store (the memory and disk tiers of
    BoxPS).

    Backed by the native C++ store unless ``PBOX_NATIVE_TABLE=0``; then by
    the pure-Python store, whose new keys get rows with embed_w and the
    embedx block drawn uniform in ``[-initial_range, initial_range)`` from
    ``np.random.default_rng(seed)`` and zero counters and g2 sums: the same
    draws, in the same order, as the JAX package's Python store. The native
    store draws the same columns from (seed, key) alone.

    ``spill_dir`` enables the native store's disk tier (the Python store
    has none and raises); ``mem_cap_rows`` bounds the memory tier:
    :meth:`maybe_spill`, which the dataset calls at pass end, evicts cold
    rows to disk until the memory tier is under the cap.
    """

    def __init__(
        self,
        layout: ValueLayout,
        opt: SparseOptimizerConfig = SparseOptimizerConfig(),
        n_shards: Optional[int] = None,
        seed: int = 0,
        spill_dir: Optional[str] = None,
        mem_cap_rows: Optional[int] = None,
    ):
        if n_shards is None:
            n_shards = 1 << config.get_flag("sparse_table_shard_bits")
        self.layout = layout
        self.opt = opt
        self.n_shards = n_shards
        self.mem_cap_rows = mem_cap_rows
        self._native = None
        if os.environ.get("PBOX_NATIVE_TABLE", "1") == "0":
            if spill_dir is not None:
                raise RuntimeError(
                    "disk spill requires the native table store (PBOX_NATIVE_TABLE=0)"
                )
        else:
            from paddlebox_tpu_torch.utils import native

            n_emb = layout.embedx_dim + layout.expand_dim  # expand trails embedx
            init_cols = np.concatenate(
                [[layout.embed_w_col], np.arange(layout.embedx_col, layout.embedx_col + n_emb)]
            ).astype(np.int32)
            if spill_dir:
                os.makedirs(spill_dir, exist_ok=True)
            self._native = native.NativeHostStore(
                n_shards, layout.width, layout.SHOW, layout.CLK, seed,
                init_cols, opt.initial_range, spill_dir,
            )
        self._shards = [] if self._native else [_Shard(layout.width) for _ in range(n_shards)]
        # initial-row draws, in shard order within a pull_or_create call; the
        # draws are reproducible when one such call runs at a time
        self._rng = np.random.default_rng(seed)
        self._size = 0  # guarded-by: _size_lock
        self._size_lock = threading.Lock()
        # device-carried pass tables this store is owed (table/carrier.py);
        # every save drains them first. _maintenance_lock orders their
        # flushes against decay_and_shrink, so a carried row decays once a
        # boundary whenever a save drains it, and it orders decay_and_shrink
        # against the saves, so a save's decay-epoch stamp and its row
        # snapshots agree
        self._pending_carriers: List = []  # guarded-by: _maintenance_lock
        self._maintenance_lock = threading.Lock()
        # pass-boundary decay counter, stamped into every save's meta: a key
        # untouched since its last save still decays at later boundaries, so
        # a load catches those rows up (rate**(file_epoch - table_epoch))
        # before a later delta lands
        self.decay_epochs = 0  # guarded-by: _maintenance_lock

    def add_pending_carrier(self, carrier) -> None:
        """Register a TableCarrier whose values the host store is owed."""
        with self._maintenance_lock:
            self._pending_carriers = [c for c in self._pending_carriers if not c.flushed]
            self._pending_carriers.append(carrier)

    def drain_pending(self, collective: bool = False) -> int:
        """Flush every registered carrier (idempotent); returns the keys
        written. A flush that raises keeps the failed carrier and those not
        reached yet registered, so a later save cannot miss their rows.

        A mesh carrier's flush is a collective that every rank must join,
        so only a caller that every rank makes alike passes
        ``collective=True`` (``BoxPSDataset.flush_carried`` and the
        dataset's boundary calls). Anything else that reaches a pending
        mesh carrier (a save on one rank, or on another thread) raises
        here instead of waiting on ranks that never join."""
        with self._maintenance_lock:
            if not collective and any(c.plan is not None and not c.flushed for c in self._pending_carriers):
                raise RuntimeError(
                    "a mesh carrier is pending: its flush is a collective, so call "
                    "BoxPSDataset.flush_carried() on every rank's main thread before "
                    "saving this rank's host table"
                )
            carriers, self._pending_carriers = self._pending_carriers, []
            n = 0
            try:
                while carriers:
                    n += carriers[0].flush(self)
                    carriers.pop(0)
            finally:
                if carriers:  # failed or not reached: still owed
                    self._pending_carriers = carriers + self._pending_carriers
        return n

    @property
    def native(self) -> bool:
        return self._native is not None

    @property
    def mem_rows(self) -> int:
        if self._native:
            return self._native.mem_rows
        with self._size_lock:
            return self._size

    @property
    def disk_rows(self) -> int:
        return self._native.disk_rows if self._native else 0

    def spill_cold(self, max_mem_rows: int) -> int:
        """Evict cold rows to disk until the memory tier holds at most
        ``max_mem_rows``; returns the rows spilled.

        Victims follow the ``spill_policy`` flag: ``freq`` ranks by coldness
        with the ``spill_pin_show`` / ``spill_admit_show`` thresholds,
        ``fifo`` sweeps in creation order. Raises :class:`SpillIOError`
        (counted under ``table.spill_errors``) when the disk tier is off or
        a shard file write fails; the fault sites ``spill.io`` and
        ``spill.stage_flush`` stand for those failures.
        """
        if self._native is None:
            raise RuntimeError("spill requires the native table store")
        policy = str(config.get_flag("spill_policy"))
        code = _SPILL_POLICY_CODES.get(policy)
        if code is None:
            raise ValueError(f"unknown spill_policy {policy!r} (expected 'freq' or 'fifo')")
        op = "spill_cold"
        try:
            _fault_fire("spill.io")
            op = "stage_flush"  # the double-buffered stage writer's handoff
            _fault_fire("spill.stage_flush")
        except InjectedFault as e:
            STAT_ADD("table.spill_errors", 1)
            raise SpillIOError(op, -2, str(e)) from e
        n = self._native.spill_cold(
            max_mem_rows,
            policy=code,
            pin_show=float(config.get_flag("spill_pin_show")),
            admit_show=float(config.get_flag("spill_admit_show")),
        )
        if n < 0:
            STAT_ADD("table.spill_errors", 1)
            raise SpillIOError(
                "spill_cold", n,
                "disk tier disabled (no spill_dir)" if n == -1 else "shard spill-file write failed",
            )
        return n

    def maybe_spill(self) -> int:
        """Enforce ``mem_cap_rows`` if it is set (the pass-end hook)."""
        if self.mem_cap_rows is None or self._native is None:
            return 0
        return self.spill_cold(self.mem_cap_rows)

    def compact_spill(self) -> int:
        """Reclaim dead spill-file space (records superseded by promotes)
        in every shard; returns the live records kept. ``spill_cold``
        compacts a shard by itself once its dead records outnumber the
        live ones. Raises :class:`SpillIOError` when a shard rewrite fails
        (that shard keeps its old file)."""
        if self._native is None:
            return 0
        n = self._native.compact_spill()
        if n == -1:  # tier disabled: nothing to reclaim
            return 0
        if n < 0:
            STAT_ADD("table.spill_errors", 1)
            raise SpillIOError("compact_spill", n, "shard rewrite failed")
        return n

    def spill_stats(self) -> tuple:
        """(live_records, dead_records, file_bytes) of the disk tier."""
        if self._native is None:
            return (0, 0, 0)
        return self._native.spill_stats()

    def tier_stats(self) -> dict:
        """Tier occupancy and cumulative flow counters: the total over the
        shards of each field of ``native.TIER_STAT_FIELDS``, the largest
        shard's memory and disk rows, and the per-shard vectors under
        ``"per_shard"``. The Python store reports its memory rows only."""
        from paddlebox_tpu_torch.utils.native import TIER_STAT_FIELDS

        if self._native is not None:
            per = self._native.tier_stats()
        else:
            per = np.zeros((self.n_shards, len(TIER_STAT_FIELDS)), np.int64)
            for i, sh in enumerate(self._shards):
                with sh.lock:
                    per[i, 0] = len(sh.index)
        out = {f: int(per[:, i].sum()) for i, f in enumerate(TIER_STAT_FIELDS)}
        out["mem_rows_max_shard"] = int(per[:, 0].max()) if len(per) else 0
        out["disk_rows_max_shard"] = int(per[:, 1].max()) if len(per) else 0
        out["per_shard"] = {f: per[:, i].tolist() for i, f in enumerate(TIER_STAT_FIELDS)}
        return out

    def publish_tier_stats(self) -> dict:
        """Set :meth:`tier_stats`' totals as ``table.tier.*`` gauges (and
        the native tier's IO split as ``table.writeback.*``); returns the
        dict."""
        st = self.tier_stats()
        STAT_SET("table.tier.mem_rows", st["mem_rows"])
        STAT_SET("table.tier.disk_rows", st["disk_rows"])
        STAT_SET("table.tier.spilled_total", st["spilled_total"])
        STAT_SET("table.tier.promoted_total", st["promoted_total"])
        STAT_SET("table.tier.admitted_disk_first", st["admitted_disk_first"])
        STAT_SET("table.tier.lazy_shrunk", st["lazy_shrunk"])
        STAT_SET("table.tier.dead_records", st["dead_records"])
        STAT_SET("table.tier.spill_bytes", st["spill_bytes"])
        STAT_SET("table.tier.mem_rows_max_shard", st["mem_rows_max_shard"])
        STAT_SET("table.tier.disk_rows_max_shard", st["disk_rows_max_shard"])
        if self._native is not None:
            io = self._native.io_stats()
            STAT_SET("table.writeback.spill_gather_s", io["spill_gather_ns"] / 1e9)
            STAT_SET("table.writeback.spill_fwrite_s", io["spill_fwrite_ns"] / 1e9)
            STAT_SET("table.writeback.prepass_read_s", io["prepass_read_ns"] / 1e9)
            STAT_SET("table.writeback.stage_flushes", io["stage_flushes"])
            STAT_SET("table.writeback.stage_bytes", io["stage_bytes"])
        return st

    def __len__(self) -> int:
        if self._native is not None:
            return len(self._native)
        with self._size_lock:
            return self._size

    def keys(self) -> np.ndarray:
        """All keys currently stored (memory and disk tiers), unsorted."""
        if self._native is not None:
            parts = [self._native.shard_keys(s) for s in range(self.n_shards)]
            return np.concatenate(parts) if parts else np.zeros(0, np.uint64)
        parts = []
        for sh in self._shards:
            with sh.lock:
                parts.append(np.fromiter(sh.index.keys(), dtype=np.uint64, count=len(sh.index)))
        return np.concatenate(parts) if parts else np.zeros(0, np.uint64)

    def _init_rows(self, n: int) -> np.ndarray:
        lay = self.layout
        rows = np.zeros((n, lay.width), dtype=np.float32)
        r = self.opt.initial_range
        rows[:, lay.embed_w_col] = self._rng.uniform(-r, r, size=n)
        n_emb = lay.embedx_dim + lay.expand_dim  # expand block trails embedx
        rows[:, lay.embedx_col : lay.embedx_col + n_emb] = self._rng.uniform(
            -r, r, size=(n, n_emb)
        )
        return rows

    def pull_or_create(self, keys: np.ndarray) -> np.ndarray:
        """Rows for unique ``keys`` (creating missing ones). [n, width]."""
        if self._native is not None:
            return self._native.pull_or_create(keys)
        out = np.empty((len(keys), self.layout.width), dtype=np.float32)
        shard_ids = key_to_shard(keys, self.n_shards)
        created = 0
        for s in range(self.n_shards):
            sel = np.nonzero(shard_ids == s)[0]
            if len(sel) == 0:
                continue
            shard = self._shards[s]
            with shard.lock:
                idx = shard.index
                # .tolist() converts uint64 -> int in C, so the dict lookups
                # stay as cheap as the interpreter allows
                klist = keys[sel].tolist()
                get = idx.get
                rows = np.fromiter(
                    (get(k, -1) for k in klist), dtype=np.int64, count=len(klist)
                )
                miss = np.nonzero(rows < 0)[0]
                if len(miss):
                    base = len(idx)
                    shard.values = _grown(shard.values, base + len(miss))
                    init = self._init_rows(len(miss))
                    new_rows = base + np.arange(len(miss))
                    for mj, j in zip(new_rows, miss):
                        idx[klist[j]] = int(mj)
                    shard.values[new_rows] = init
                    rows[miss] = new_rows
                    created += len(miss)
                out[sel] = shard.values[rows]
        if created:
            with self._size_lock:
                self._size += created
        return out

    def shows_peek(self, keys: np.ndarray) -> np.ndarray:
        """Decayed show counts of ``keys``, f32 [n], without creating,
        promoting or touching anything; a key on the disk tier or absent
        reads 0."""
        if self._native is not None:
            return self._native.shows_peek(keys)
        out = np.zeros(len(keys), dtype=np.float32)
        shard_ids = key_to_shard(keys, self.n_shards)
        for s in range(self.n_shards):
            sel = np.nonzero(shard_ids == s)[0]
            if len(sel) == 0:
                continue
            shard = self._shards[s]
            with shard.lock:
                get = shard.index.get
                klist = keys[sel].tolist()
                rows = np.fromiter((get(k, -1) for k in klist), dtype=np.int64, count=len(klist))
                hit = rows >= 0
                if hit.any():
                    out[sel[hit]] = shard.values[rows[hit], self.layout.SHOW]
        return out

    def prefetch_rows(self, keys: np.ndarray) -> Tuple[np.ndarray, int]:
        """Pull or create rows for a staged next pass; returns (rows, decay
        epoch). Under the maintenance lock, so no decay or carrier drain
        lands between the pull and the stamp: the consumer then applies
        exactly ``decay_epochs - epoch`` decays to the prefetched rows
        (rows created here have show = clk = 0, on which they are no-ops)."""
        with self._maintenance_lock:
            return self.pull_or_create(keys), self.decay_epochs

    def push(self, keys: np.ndarray, rows: np.ndarray) -> None:
        """Write back full rows for ``keys`` (end-of-pass flush); a key not
        yet stored is added. Every pushed key counts as touched for the
        next delta save."""
        if self._native is not None:
            self._native.push(keys, rows)
            return
        shard_ids = key_to_shard(keys, self.n_shards)
        created = 0
        for s in range(self.n_shards):
            sel = np.nonzero(shard_ids == s)[0]
            if len(sel) == 0:
                continue
            shard = self._shards[s]
            with shard.lock:
                idx = shard.index
                klist = keys[sel].tolist()
                get = idx.get
                trows = np.fromiter(
                    (get(k, -1) for k in klist), dtype=np.int64, count=len(klist)
                )
                miss = np.nonzero(trows < 0)[0]
                if len(miss):
                    base = len(idx)
                    shard.values = _grown(shard.values, base + len(miss))
                    new_rows = base + np.arange(len(miss))
                    for mj, j in zip(new_rows, miss):
                        idx[klist[j]] = int(mj)
                    trows[miss] = new_rows
                    created += len(miss)
                shard.values[trows] = rows[sel]
                shard.touched.update(klist)
        if created:
            with self._size_lock:
                self._size += created

    def push_writeback(self, keys: np.ndarray, rows: np.ndarray, threads: int) -> None:
        """One chunk of the end-of-pass writeback: through the native
        store's pool of ``threads`` writers (bitwise-equal to :meth:`push`),
        each shard's wall seconds observed into ``table.writeback.shard_s``;
        the Python store takes :meth:`push`. A failure (the fault site
        ``table.writeback_worker``, or a writer's spill-file IO) raises
        :class:`SpillIOError`."""
        try:
            _fault_fire("table.writeback_worker")
        except InjectedFault as e:
            STAT_ADD("table.spill_errors", 1)
            raise SpillIOError("writeback_worker", -2, str(e)) from e
        if self._native is None:
            self.push(keys, rows)
            return
        try:
            shard_s = self._native.push_mt(keys, rows, threads)
        except IOError as e:
            STAT_ADD("table.spill_errors", 1)
            raise SpillIOError("writeback_push", -2, str(e)) from e
        for v in shard_s:
            STAT_OBSERVE("table.writeback.shard_s", float(v))

    def decay_and_shrink(self) -> int:
        """Pass-boundary maintenance: decay show/clk by ``show_clk_decay``,
        drop keys whose decayed show falls under ``shrink_threshold``, and
        count the boundary in ``decay_epochs``. Returns the number of keys
        dropped (pslib show_click_decay_rate + shrink threshold,
        fleet_wrapper.h:258-310).

        A pending carrier, whose rows this decay cannot reach, notes the
        decay instead and applies it at its splice or flush. Under the
        maintenance lock, so a concurrent drain lands wholly before (its
        rows decay here) or wholly after (its flush carries the decay)."""
        with self._maintenance_lock:
            live = [c for c in self._pending_carriers if not c.flushed]
            for c in live:
                c.note_decay(self.opt.show_clk_decay)
            self._pending_carriers = live
            self.decay_epochs += 1
            return self._decay_and_shrink_locked()

    def _decay_and_shrink_locked(
        self, decay: Optional[float] = None, threshold: Optional[float] = None
    ) -> int:
        lay, opt = self.layout, self.opt
        decay = opt.show_clk_decay if decay is None else decay
        threshold = opt.shrink_threshold if threshold is None else threshold
        if self._native is not None:
            return self._native.decay_and_shrink(decay, threshold)
        dropped = 0
        for shard in self._shards:
            with shard.lock:
                n = len(shard.index)
                if n == 0:
                    continue
                vals = shard.values[:n]
                vals[:, lay.SHOW] *= decay
                vals[:, lay.CLK] *= decay
                keep = vals[:, lay.SHOW] >= threshold
                if keep.all():
                    continue
                keys_arr = np.empty(n, dtype=np.uint64)
                rows_arr = np.empty(n, dtype=np.int64)
                for i, (k, r) in enumerate(shard.index.items()):
                    keys_arr[i] = k
                    rows_arr[i] = r
                order = np.argsort(rows_arr)
                keys_arr, rows_arr = keys_arr[order], rows_arr[order]
                kept = keep[rows_arr]
                new_vals = vals[rows_arr[kept]]
                dropped += int((~kept).sum())
                shard.index = {int(k): i for i, k in enumerate(keys_arr[kept])}
                shard.values = np.zeros(
                    (max(1024, len(shard.index)), lay.width), dtype=np.float32
                )
                shard.values[: len(shard.index)] = new_vals
        with self._size_lock:
            self._size -= dropped
        return dropped

    # --- persistence: base + delta publishing (SaveBase/SaveDelta parity,
    # box_wrapper.cc:1288-1331) ---

    def _snapshot_shard(self, s: int, only_touched: bool, clear_touched: bool = True):
        """(keys, values) of one shard, all of them or only the touched
        ones, with the touched set cleared under the same shard lock: a
        concurrent push lands either in this snapshot or in the next
        delta. ``clear_touched=False`` is a read-only peek."""
        if self._native is not None:
            return self._native.snapshot_shard(s, only_touched, clear_touched)
        shard = self._shards[s]
        with shard.lock:
            if only_touched:
                items = [(k, shard.index[k]) for k in shard.touched if k in shard.index]
            else:
                items = list(shard.index.items())
            keys = np.array([k for k, _ in items], dtype=np.uint64)
            vals = (
                shard.values[[r for _, r in items]]
                if items
                else np.zeros((0, self.layout.width), dtype=np.float32)
            )
            if clear_touched:
                shard.touched.clear()
        return keys, vals

    def _snapshots(self, only_touched: bool, clear_touched: bool):
        """(decay epoch, every shard's snapshot), taken under the
        maintenance lock so the stamp and the rows agree; the compression
        and the IO run outside it."""
        with self._maintenance_lock:
            return self.decay_epochs, [
                self._snapshot_shard(s, only_touched, clear_touched) for s in range(self.n_shards)
            ]

    def _write_shards(self, path: str, snaps) -> int:
        total = 0
        for s, (keys, vals) in enumerate(snaps):
            total += len(keys)
            np.savez_compressed(os.path.join(path, f"shard-{s:05d}.npz"), keys=keys, values=vals)
        return total

    def save_base(self, path: str) -> None:
        """Write every key to ``path`` (a full snapshot, kind "base"), the
        pending carriers drained first."""
        self.drain_pending()
        os.makedirs(path, exist_ok=True)
        epoch, snaps = self._snapshots(only_touched=False, clear_touched=True)
        meta = {
            "n_shards": self.n_shards,
            "width": self.layout.width,
            "embedx_dim": self.layout.embedx_dim,
            "kind": "base",
            "decay_epoch": epoch,
        }
        with atomic_write(os.path.join(path, "meta.json")) as f:
            json.dump(meta, f)
        self._write_shards(path, snaps)

    def save_delta(self, path: str, clear_touched: bool = True) -> int:
        """Write only the keys touched since the last save; returns their
        count. ``clear_touched=False`` keeps the touched set, so a caller
        can clear it (:meth:`clear_touched`) once the delta is durable and a
        crashed save retries with the same keys. The pending carriers are
        drained first."""
        self.drain_pending()
        os.makedirs(path, exist_ok=True)
        epoch, snaps = self._snapshots(only_touched=True, clear_touched=clear_touched)
        total = self._write_shards(path, snaps)
        with atomic_write(os.path.join(path, "meta.json")) as f:
            json.dump({"n_shards": self.n_shards, "kind": "delta", "decay_epoch": epoch}, f)
        return total

    def clear_touched(self) -> None:
        """Empty every shard's touched set. Pairs with
        ``save_delta(..., clear_touched=False)``; call it at a quiet point
        (no concurrent pushes)."""
        if self._native is not None:
            self._native.clear_touched()
            return
        for shard in self._shards:
            with shard.lock:
                shard.touched.clear()

    def cache_threshold(self, cache_rate: float = 0.1) -> float:
        """The show threshold whose admitted fraction is closest to
        ``cache_rate`` (get_cache_threshold parity, pslib __init__.py:411),
        over the exact show distribution, so ties cannot blow the cache up
        to the whole table."""
        if not 0.0 < cache_rate <= 1.0:
            raise ValueError(f"cache_rate must be in (0, 1], got {cache_rate}")
        shows = []
        for s in range(self.n_shards):
            if self._native is not None:
                col = self._native.shard_shows(s)
            else:
                shard = self._shards[s]
                with shard.lock:
                    col = shard.values[: len(shard.index), self.layout.SHOW].copy()
            if len(col):
                shows.append(col)
        if not shows:
            return 0.0
        allshow = np.concatenate(shows)
        uniq, counts = np.unique(allshow, return_counts=True)  # ascending
        admitted = np.cumsum(counts[::-1])[::-1] / len(allshow)  # fraction >= uniq[i]
        return float(uniq[int(np.argmin(np.abs(admitted - cache_rate)))])

    def _filtered_save(self, path: str, mask_fn, meta: dict) -> int:
        """A full snapshot filtered row by row (the cache and whitelist
        saves), the pending carriers drained first; the touched sets stay
        as they are."""
        self.drain_pending()
        os.makedirs(path, exist_ok=True)
        epoch, snaps = self._snapshots(only_touched=False, clear_touched=False)
        meta = {**meta, "decay_epoch": epoch}
        kept = []
        for keys, vals in snaps:
            keep = mask_fn(keys, vals)
            kept.append((keys[keep], vals[keep]))
        total = self._write_shards(path, kept)
        with atomic_write(os.path.join(path, "meta.json")) as f:
            json.dump({"n_shards": self.n_shards, **meta}, f)
        return total

    def save_cache(self, path: str, threshold: float) -> int:
        """Write the hot subset (show >= threshold) for serving
        (save_cache_model parity, pslib __init__.py:416); returns the key
        count."""
        return self._filtered_save(
            path,
            lambda keys, vals: vals[:, self.layout.SHOW] >= threshold,
            {"kind": "cache", "threshold": threshold},
        )

    def save_with_whitelist(self, path: str, whitelist: np.ndarray) -> int:
        """Write the whitelisted keys that exist in the table
        (save_model_with_whitelist parity, pslib __init__.py:351-384)."""
        wl = np.unique(np.asarray(whitelist, dtype=np.uint64))
        return self._filtered_save(
            path, lambda keys, vals: np.isin(keys, wl), {"kind": "whitelist"}
        )

    def load(self, path: str) -> None:
        """Load a save dir: a base starts a lineage (the table adopts its
        decay epoch); a later delta first decays the rows already held by
        ``rate**(file_epoch - table_epoch)``, the boundaries they lived
        through, then upserts its rows. The loaded keys do not count as
        touched."""
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        if meta["n_shards"] != self.n_shards:
            raise ValueError("shard count mismatch on load")
        with self._maintenance_lock:
            file_epoch = int(meta.get("decay_epoch", self.decay_epochs))
            if meta.get("kind", "base") == "base":
                self.decay_epochs = file_epoch
            elif file_epoch > self.decay_epochs:
                if len(self):
                    # a Python float, as the JAX package computes it
                    d = float(self.opt.show_clk_decay) ** (file_epoch - self.decay_epochs)
                    if d < 1.0:  # threshold 0: decay, no drops
                        self._decay_and_shrink_locked(d, 0.0)
                self.decay_epochs = file_epoch
        for s in range(self.n_shards):
            data = np.load(os.path.join(path, f"shard-{s:05d}.npz"))
            keys, vals = data["keys"], data["values"]
            if len(keys):
                self.push(keys, vals)
            if self._native is None:
                self._shards[s].touched.clear()
        if self._native is not None:
            self._native.clear_touched()

    apply_delta = load  # a delta dir has the same format; push() upserts


def _rows_with_prefetch(table: HostSparseTable, keys: np.ndarray, prefetch) -> np.ndarray:
    """Host rows for sorted unique ``keys``: prefetch hits from the staged
    pull, the rest pulled now.

    A prefetched row gets the decays the host applied since its pull
    (``decay_epochs - epoch``). Bitwise a fresh ``pull_or_create``: a row
    the prefetch created has show = clk = 0, and a row that existed was not
    written since (the feed stage left out the live pass's keys)."""
    if prefetch is None:
        return table.pull_or_create(keys)
    pf_keys, pf_rows = prefetch["keys"], prefetch["rows"]
    lay = table.layout
    out = np.empty((len(keys), lay.width), dtype=np.float32)
    if len(pf_keys):
        pos = np.minimum(np.searchsorted(pf_keys, keys), len(pf_keys) - 1)
        hit = pf_keys[pos] == keys
    else:
        hit = np.zeros(len(keys), dtype=bool)
    if hit.any():
        rows = pf_rows[pos[hit]]  # fancy index: a fresh copy
        dec = np.float32(table.opt.show_clk_decay)
        for _ in range(table.decay_epochs - prefetch["epoch"]):
            rows[:, lay.SHOW] *= dec
            rows[:, lay.CLK] *= dec
        out[hit] = rows
    miss = ~hit
    if miss.any():
        out[miss] = table.pull_or_create(keys[miss])
    return out


class PassWorkingSet:
    """The device tier: dense pass-local table built from the unique keys.

    Life cycle: add_keys (many threads) -> finalize() -> one host->device
    copy of the returned array -> steps gather and scatter rows by the ids
    that :meth:`lookup` hands the packer -> writeback(trained array).
    """

    def __init__(self, n_mesh_shards: int = 1):
        self.n_mesh_shards = n_mesh_shards
        self._key_chunks: List[np.ndarray] = []  # guarded-by: _lock
        self._lock = threading.Lock()
        self._finalized = False
        # set by finalize():
        self.sorted_keys: Optional[np.ndarray] = None  # uint64 [n]
        self.row_of_sorted: Optional[np.ndarray] = None  # int64 [n] global rows
        self.capacity = 0  # rows per mesh shard (incl. padding row)
        self.n_keys = 0
        self._table = None  # the row source finalize pulled from
        # bool [n_mesh_shards*capacity] hotness bits of the adaptive mesh
        # wire; None when it is not engaged (the packer keeps its order)
        self.hot_rows: Optional[np.ndarray] = None

    def add_keys(self, keys: np.ndarray) -> None:
        """Feed feasigns seen in loaded records (PSAgent::AddKeys parity)."""
        if self._finalized:
            raise RuntimeError("working set already finalized")
        if len(keys):
            with self._lock:
                self._key_chunks.append(np.unique(keys.astype(np.uint64)))

    def premerge(self, threads: int = 1) -> np.ndarray:
        """Merge the key chunks fed so far into one array now (the feed
        stage does it while the previous pass trains). ``finalize`` then
        merges a one-chunk list, which returns that very array: a staged
        prefetch checks that identity. ``add_keys`` after this still works
        but voids the identity, and the prefetch is dropped."""
        if self._finalized:
            raise RuntimeError("working set already finalized")
        with self._lock:
            merged = merge_unique_keys(self._key_chunks, threads)
            self._key_chunks = [merged] if len(merged) else []
        return merged

    def finalize(self, table, round_to: int = 512, carrier=None, prefetch=None):
        """Dedup keys, pull host rows, lay out [n_mesh_shards, cap, width].

        ``table`` is any row source with a ``layout`` and
        ``pull_or_create(sorted_keys) -> rows [n, width]``. Row (s, cap-1)
        of every shard is the reserved padding row. Returns a numpy array.

        With ``carrier`` (the previous pass's TableCarrier) the boundary
        goes delta-only and returns a tensor on the carrier's device: see
        :meth:`_finalize_spliced`. ``prefetch`` is the feed stage's staged
        pull ({src, keys, rows, epoch}); it is used only when ``src`` is
        the very array this finalize merges, else dropped.
        """
        t0 = time.perf_counter()
        with self._lock, record_event("boundary.dedup", "boundary"):
            all_keys = merge_unique_keys(
                self._key_chunks,
                int(config.get_flag("boundary_merge_threads")),
            )
            self._key_chunks = []
        STAT_SET("boundary.dedup_s", time.perf_counter() - t0)
        if prefetch is not None and prefetch.get("src") is not all_keys:
            prefetch = None  # keys landed after the staged premerge: stale
        self.n_keys = len(all_keys)
        ns = self.n_mesh_shards
        shard_ids = key_to_shard(all_keys, ns)
        counts = np.bincount(shard_ids, minlength=ns)
        # +1 reserves the padding row; round for a bounded family of shapes
        cap = int(counts.max()) + 1 if len(all_keys) else 1
        cap = -(-cap // round_to) * round_to
        self.capacity = cap

        # stable order: group by shard, rank within shard — vectorized
        # (rank of key i = position of i within its shard's sorted group)
        order = np.argsort(shard_ids, kind="stable")
        rank_in_shard = np.empty(len(all_keys), dtype=np.int64)
        starts = np.repeat(np.cumsum(counts) - counts, counts)
        rank_in_shard[order] = np.arange(len(all_keys), dtype=np.int64) - starts
        global_rows = shard_ids * cap + rank_in_shard

        self.sorted_keys = all_keys  # np.unique output is sorted
        self.row_of_sorted = global_rows
        self._finalized = True
        self._table = table

        if carrier is not None and not carrier.flushed and carrier.ws.n_keys:
            # the resident keys' live shows are on the device: hotness reads
            # the host tier instead
            if self._ici_adaptive():
                self._set_hot_rows(global_rows, table.shows_peek(all_keys))
            return self._finalize_spliced(table, carrier, all_keys, global_rows, ns, cap, prefetch)
        t0 = time.perf_counter()
        with record_event("boundary.pull", "boundary"):
            rows = (
                _rows_with_prefetch(table, all_keys, prefetch)
                if len(all_keys)
                else np.zeros((0, table.layout.width), dtype=np.float32)
            )
        STAT_SET("boundary.pull_s", time.perf_counter() - t0)
        if self._ici_adaptive() and len(all_keys):
            # the pulled rows' decayed show column is the exact hotness
            self._set_hot_rows(global_rows, rows[:, table.layout.SHOW])
        dev = np.zeros((ns, cap, table.layout.width), dtype=np.float32)
        dev.reshape(ns * cap, -1)[global_rows] = rows
        return dev

    @staticmethod
    def _ici_adaptive() -> bool:
        from paddlebox_tpu_torch.ops import wire_quant  # lazy: an import cycle

        return wire_quant.ici_adaptive_engaged()

    def _set_hot_rows(self, global_rows: np.ndarray, shows: np.ndarray) -> None:
        """Publish the hotness bits of the adaptive mesh wire."""
        thr = float(config.get_flag("ici_hot_show"))
        hot = np.zeros(self.n_mesh_shards * self.capacity, dtype=bool)
        hot[global_rows] = np.asarray(shows, dtype=np.float32) >= thr
        self.hot_rows = hot
        STAT_SET("wire.ici_hot_keys", int(hot.sum()))

    def _finalize_spliced(self, table, carrier, all_keys, global_rows, ns, cap, prefetch=None):
        """The delta boundary: rows of keys in both passes are spliced on
        the device from the carried table (its owed decay applied), the
        departing rows are pushed to the host on a worker, and only new
        keys pull host rows and cross the wire. Returns the [ns, cap,
        width] tensor on the carrier's device.

        The host pull of the new keys runs on a thread, beside the device
        allocation and the splice; the two row writes hit disjoint rows, so
        their order does not matter.

        A mesh carrier (``carrier.plan``) returns this rank's new shard
        [cap, width]: its surviving keys splice from its old shard (a key's
        shard is a hash of the key, the same in both passes), the departing
        rows of every shard are gathered to every rank, and every rank
        pulls every new key from its host replica (so each creates the same
        keys in the same order) but uploads only its shard's."""
        from paddlebox_tpu_torch.ops.pull_push import write_rows
        from paddlebox_tpu_torch.ops.wire_quant import send_rows

        mesh = carrier.plan
        if mesh is not None and carrier.ws.n_mesh_shards != ns:
            raise ValueError(f"a mesh carrier of {carrier.ws.n_mesh_shards} shards cannot splice into {ns}")
        old_keys = carrier.ws.sorted_keys
        # both sides sorted: positions of the intersection in each
        pos_in_old = np.minimum(np.searchsorted(old_keys, all_keys), len(old_keys) - 1)
        common = old_keys[pos_in_old] == all_keys  # mask over all_keys
        common_old = pos_in_old[common]
        in_new = np.zeros(len(old_keys), dtype=bool)
        in_new[common_old] = True
        leave_pos = np.nonzero(~in_new)[0]
        if len(leave_pos):
            # joined before any decay or durable read
            carrier.push_departures_async(table, old_keys[leave_pos], leave_pos)
        new_mask = ~common
        new_keys = all_keys[new_mask]
        W = table.layout.width
        device = carrier.dev_flat.device

        pull = {"rows": None, "err": None, "secs": 0.0}  # written by the puller only

        def _pull_new():
            t0 = time.perf_counter()
            try:
                with record_event("boundary.pull", "boundary"):
                    pull["rows"] = _rows_with_prefetch(table, new_keys, prefetch)
            except BaseException as e:  # joined and raised below
                pull["err"] = e
            pull["secs"] = time.perf_counter() - t0

        puller = None
        if len(new_keys):
            puller = threading.Thread(target=_pull_new, name="boundary-pull", daemon=True)
            puller.start()

        # the rows this process holds: all, or on a mesh its shard's
        base, n_rows = (0, ns * cap) if mesh is None else (mesh.rank * cap, cap)
        mine = (global_rows >= base) & (global_rows < base + n_rows)

        def ids(mask):
            return torch.from_numpy(np.ascontiguousarray(global_rows[mask] - base)).to(device)

        t0 = time.perf_counter()
        with record_event("boundary.splice", "boundary"):
            dev = torch.zeros((n_rows, W), dtype=torch.float32, device=device)
            if (common & mine).any():
                write_rows(dev, ids(common & mine), carrier.rows_for(pos_in_old[common & mine]))
        STAT_SET("boundary.splice_s", time.perf_counter() - t0)
        if puller is not None:
            puller.join()
            if pull["err"] is not None:
                raise pull["err"]
            STAT_SET("boundary.pull_s", pull["secs"])
            rows = pull["rows"] if mesh is None else pull["rows"][mine[new_mask]]
            if len(rows):
                up = send_rows(rows, table.layout, str(config.get_flag("wire_dtype")), device)
                write_rows(dev, ids(new_mask & mine), up)
        return dev if mesh is not None else dev.reshape(ns, cap, W)

    def lookup(self, keys: np.ndarray) -> np.ndarray:
        """Batch keys -> global row ids (int32). Keys must be in the pass."""
        if len(self.sorted_keys) == 0:
            if len(keys):
                raise KeyError(
                    f"{len(keys)} batch keys but the pass working set is empty"
                )
            return np.zeros(0, np.int32)
        pos = np.searchsorted(self.sorted_keys, keys.astype(np.uint64))
        pos = np.minimum(pos, len(self.sorted_keys) - 1)
        if not np.all(self.sorted_keys[pos] == keys):
            missing = keys[self.sorted_keys[pos] != keys]
            raise KeyError(
                f"{len(missing)} batch keys not in pass working set (e.g. {missing[:5]})"
            )
        return self.row_of_sorted[pos].astype(np.int32)

    def writeback(
        self, device_array: np.ndarray, cancel: Optional[threading.Event] = None
    ) -> None:
        """Push the trained rows of the pass's keys back to the table that
        :meth:`finalize` pulled them from (EndPass parity). ``device_array``
        is the trained table on the host, [n_mesh_shards, cap, width] or
        flat [rows, width].

        With ``writeback_threads`` > 1 and the native store, the push goes
        in chunks of ``writeback_chunk_keys`` through the writer pool, chunk
        k+1's row gather running while chunk k's push is in flight; else it
        is one ``push``. The host table ends bitwise the same either way:
        the chunks split a sorted unique key batch, so every shard sees its
        keys in the same order. ``cancel``, checked at chunk boundaries,
        stops the chunked path with :class:`WritebackCancelled` (a revert
        undoes what landed). Sets the ``table.writeback.*`` stats."""
        if self.n_keys == 0:
            return
        flat = np.asarray(device_array).reshape(-1, device_array.shape[-1])
        threads = int(config.get_flag("writeback_threads"))
        if threads <= 1 or not getattr(self._table, "native", False):
            self._table.push(self.sorted_keys, flat[self.row_of_sorted])
            return
        chunk = max(1, int(config.get_flag("writeback_chunk_keys")))
        n = len(self.sorted_keys)
        t_all = time.perf_counter()
        wait_s = busy_s = 0.0
        n_chunks = 0
        pending = None

        def _push_chunk(ck: np.ndarray, cr: np.ndarray) -> float:
            t0 = time.perf_counter()
            self._table.push_writeback(ck, cr, threads)
            return time.perf_counter() - t0

        with ThreadPoolExecutor(max_workers=1, thread_name_prefix="writeback") as ex:
            for lo in range(0, n, chunk):
                if cancel is not None and cancel.is_set():
                    # the chunk in flight finishes at executor shutdown
                    raise WritebackCancelled(lo, n)
                hi = min(n, lo + chunk)
                t0 = time.perf_counter()
                cr = np.ascontiguousarray(flat[self.row_of_sorted[lo:hi]])
                STAT_OBSERVE("table.writeback.gather_s", time.perf_counter() - t0)
                if pending is not None:
                    t0 = time.perf_counter()
                    busy_s += pending.result()
                    wait_s += time.perf_counter() - t0
                pending = ex.submit(_push_chunk, self.sorted_keys[lo:hi], cr)
                n_chunks += 1
            t0 = time.perf_counter()
            busy_s += pending.result()
            wait_s += time.perf_counter() - t0
        STAT_SET("table.writeback.threads", threads)
        STAT_SET("table.writeback.chunks", n_chunks)
        STAT_SET("table.writeback.wait_s", wait_s)
        STAT_SET("table.writeback.push_s", time.perf_counter() - t_all)
        # push busy time the one-slot pipeline hid behind row gathers
        STAT_SET("table.writeback.hidden_s", max(0.0, busy_s - wait_s))

    @property
    def padding_row(self) -> int:
        """Global row id safe for batch padding (shard 0's reserved row)."""
        return self.capacity - 1
