"""Host key -> row store and the pass-scoped device working set.

Port of the JAX package's ``table/sparse_table.py``, its memory tier:

- ``HostSparseTable``: the host store, sharded by key hash across
  ``n_shards``. By default it is the native C++ store
  (``csrc/host_table.cc`` through ``utils/native.py``), whose new rows are
  a pure function of (seed, key); with ``PBOX_NATIVE_TABLE=0`` it is the
  pure-Python store of lock-protected dict shards, whose new rows come
  from ``np.random.default_rng(seed)`` in pull order. Either gives the
  same bits as the JAX package's store of the same kind: pull-or-create,
  full-row push, and the pass-boundary decay and shrink. When the native
  store is asked for and cannot be built, construction raises.
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

Each mesh shard reserves its last row as the padding row (zero, never
written back): batch padding targets it.

The disk (spill) tier, tier stats, saves and the device-carried boundary
splice are not ported.
"""

from __future__ import annotations

import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

import numpy as np

from paddlebox_tpu_torch import config
from paddlebox_tpu_torch.table.optimizers import SparseOptimizerConfig
from paddlebox_tpu_torch.table.value_layout import ValueLayout
from paddlebox_tpu_torch.utils.monitor import STAT_OBSERVE, STAT_SET

config.define_flag(
    "boundary_merge_threads", 4,
    "threads for the chunked pass-boundary key merge; <=1 falls back to "
    "the serial np.unique(np.concatenate(...))",
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


class _Shard:
    """One lock-protected hash shard of the host store."""

    __slots__ = ("index", "values", "lock", "width")

    def __init__(self, width: int):
        self.index: Dict[int, int] = {}  # guarded-by: lock
        self.values = np.zeros((0, width), dtype=np.float32)  # guarded-by: lock
        self.lock = threading.Lock()
        self.width = width

    def _grow(self, need: int) -> None:
        cap = len(self.values)
        if need <= cap:
            return
        new_cap = max(1024, cap * 2, need)
        nv = np.zeros((new_cap, self.width), dtype=np.float32)
        nv[:cap] = self.values
        self.values = nv


class HostSparseTable:
    """Host sharded key -> fp32 row store (the mem tier of BoxPS).

    Backed by the native C++ store unless ``PBOX_NATIVE_TABLE=0``; then by
    the pure-Python store, whose new keys get rows with embed_w and the
    embedx block drawn uniform in ``[-initial_range, initial_range)`` from
    ``np.random.default_rng(seed)`` and zero counters and g2 sums: the same
    draws, in the same order, as the JAX package's Python store. The native
    store draws the same columns from (seed, key) alone.
    """

    def __init__(
        self,
        layout: ValueLayout,
        opt: SparseOptimizerConfig = SparseOptimizerConfig(),
        n_shards: Optional[int] = None,
        seed: int = 0,
        spill_dir: Optional[str] = None,
    ):
        if n_shards is None:
            n_shards = 1 << config.get_flag("sparse_table_shard_bits")
        if spill_dir is not None:
            raise NotImplementedError("the disk spill tier is not ported yet")
        self.layout = layout
        self.opt = opt
        self.n_shards = n_shards
        self._native = None
        if os.environ.get("PBOX_NATIVE_TABLE", "1") != "0":
            from paddlebox_tpu_torch.utils import native

            n_emb = layout.embedx_dim + layout.expand_dim  # expand trails embedx
            init_cols = np.concatenate(
                [[layout.embed_w_col], np.arange(layout.embedx_col, layout.embedx_col + n_emb)]
            ).astype(np.int32)
            self._native = native.NativeHostStore(
                n_shards, layout.width, layout.SHOW, layout.CLK, seed,
                init_cols, opt.initial_range,
            )
        self._shards = [] if self._native else [_Shard(layout.width) for _ in range(n_shards)]
        # initial-row draws, in shard order within a pull_or_create call; the
        # draws are reproducible when one such call runs at a time
        self._rng = np.random.default_rng(seed)
        self._size = 0  # guarded-by: _size_lock
        self._size_lock = threading.Lock()

    @property
    def native(self) -> bool:
        return self._native is not None

    def __len__(self) -> int:
        if self._native is not None:
            return len(self._native)
        return self._size

    def keys(self) -> np.ndarray:
        """All keys currently stored, unsorted."""
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
                    shard._grow(base + len(miss))
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

    def push(self, keys: np.ndarray, rows: np.ndarray) -> None:
        """Write back full rows for ``keys`` (end-of-pass flush); a key not
        yet stored is added."""
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
                    shard._grow(base + len(miss))
                    new_rows = base + np.arange(len(miss))
                    for mj, j in zip(new_rows, miss):
                        idx[klist[j]] = int(mj)
                    trows[miss] = new_rows
                    created += len(miss)
                shard.values[trows] = rows[sel]
        if created:
            with self._size_lock:
                self._size += created

    def push_writeback(self, keys: np.ndarray, rows: np.ndarray, threads: int) -> None:
        """One chunk of the end-of-pass writeback: through the native
        store's pool of ``threads`` writers (bitwise-equal to :meth:`push`),
        each shard's wall seconds observed into ``table.writeback.shard_s``;
        the Python store takes :meth:`push`."""
        if self._native is None:
            self.push(keys, rows)
            return
        for v in self._native.push_mt(keys, rows, threads):
            STAT_OBSERVE("table.writeback.shard_s", float(v))

    def decay_and_shrink(self) -> int:
        """Pass-boundary maintenance: decay show/clk by ``show_clk_decay``,
        drop keys whose decayed show falls under ``shrink_threshold``.
        Returns the number of keys dropped (pslib show_click_decay_rate +
        shrink threshold, fleet_wrapper.h:258-310)."""
        lay, opt = self.layout, self.opt
        if self._native is not None:
            return self._native.decay_and_shrink(opt.show_clk_decay, opt.shrink_threshold)
        dropped = 0
        for shard in self._shards:
            with shard.lock:
                n = len(shard.index)
                if n == 0:
                    continue
                vals = shard.values[:n]
                vals[:, lay.SHOW] *= opt.show_clk_decay
                vals[:, lay.CLK] *= opt.show_clk_decay
                keep = vals[:, lay.SHOW] >= opt.shrink_threshold
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

    def add_keys(self, keys: np.ndarray) -> None:
        """Feed feasigns seen in loaded records (PSAgent::AddKeys parity)."""
        if self._finalized:
            raise RuntimeError("working set already finalized")
        if len(keys):
            with self._lock:
                self._key_chunks.append(np.unique(keys.astype(np.uint64)))

    def finalize(self, table, round_to: int = 512) -> np.ndarray:
        """Dedup keys, pull host rows, lay out [n_mesh_shards, cap, width].

        ``table`` is any row source with a ``layout`` and
        ``pull_or_create(sorted_keys) -> rows [n, width]``. Row (s, cap-1)
        of every shard is the reserved padding row.
        """
        t0 = time.perf_counter()
        with self._lock:
            all_keys = merge_unique_keys(
                self._key_chunks,
                int(config.get_flag("boundary_merge_threads")),
            )
            self._key_chunks = []
        STAT_SET("boundary.dedup_s", time.perf_counter() - t0)
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

        t0 = time.perf_counter()
        rows = (
            table.pull_or_create(all_keys)
            if len(all_keys)
            else np.zeros((0, table.layout.width), dtype=np.float32)
        )
        STAT_SET("boundary.pull_s", time.perf_counter() - t0)
        dev = np.zeros((ns, cap, table.layout.width), dtype=np.float32)
        dev.reshape(ns * cap, -1)[global_rows] = rows
        return dev

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

    def writeback(self, device_array: np.ndarray) -> None:
        """Push the trained rows of the pass's keys back to the table that
        :meth:`finalize` pulled them from (EndPass parity). ``device_array``
        is the trained table on the host, [n_mesh_shards, cap, width] or
        flat [rows, width].

        With ``writeback_threads`` > 1 and the native store, the push goes
        in chunks of ``writeback_chunk_keys`` through the writer pool, chunk
        k+1's row gather running while chunk k's push is in flight; else it
        is one ``push``. The host table ends bitwise the same either way:
        the chunks split a sorted unique key batch, so every shard sees its
        keys in the same order. Sets the ``table.writeback.*`` stats."""
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
