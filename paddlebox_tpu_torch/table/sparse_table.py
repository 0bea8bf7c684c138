"""Pass-scoped device working set over a host row source.

Port of the serving half of the JAX package's ``table/sparse_table.py``:

- ``PassWorkingSet``: every feasign of a batch (or a pass) is fed in with
  :meth:`~PassWorkingSet.add_keys`; :meth:`~PassWorkingSet.finalize` dedups,
  pulls the rows from a host row source and lays them out as one dense
  ``[n_mesh_shards, capacity, width]`` fp32 array, which the caller copies
  to the device in one transfer. Keys map to (mesh_shard, row) by hash, so
  the device-side pull is a static-shape gather.
- lookup: batch keys -> dense row ids happens host-side at pack time
  (vectorized searchsorted over the sorted key table), so no hash table ever
  lives on the device.

Each mesh shard reserves its last row as the padding row (zero, never
written back): batch padding targets it.

``HostSparseTable``, the native store and the device-carried boundary
splice come with the training slice.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

import numpy as np

from paddlebox_tpu_torch import config
from paddlebox_tpu_torch.utils.monitor import STAT_SET

config.define_flag(
    "boundary_merge_threads", 4,
    "threads for the chunked pass-boundary key merge; <=1 falls back to "
    "the serial np.unique(np.concatenate(...))",
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


class PassWorkingSet:
    """The device tier: dense pass-local table built from the unique keys.

    Life cycle: add_keys (many threads) -> finalize() -> one host->device
    copy of the returned array -> steps gather rows by the ids that
    :meth:`lookup` hands the packer.
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

    @property
    def padding_row(self) -> int:
        """Global row id safe for batch padding (shard 0's reserved row)."""
        return self.capacity - 1
