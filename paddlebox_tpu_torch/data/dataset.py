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
- ``begin_pass`` finalizes the working set against the host table and
  returns the pass table for the device.
- ``batch_indices`` serves the store-record indices of each minibatch (the
  fast feeds); ``batches`` serves ``SlotBatch``es (the slow feed). Both
  wrap around past the tail.
- ``end_pass`` writes the trained rows back, then decays and shrinks the
  host table, saves a delta when asked, enforces the table's memory cap
  (the disk tier) and publishes its tier gauges, synchronously, in the JAX
  package's order. A failed end_pass leaves the pass open, to be retried
  or reverted.
- ``begin_pass(enable_revert=True, trainer=...)`` arms a ``PassGuard``;
  ``revert_pass`` restores the pass keys' host rows and the trainer's
  dense state and re-arms the same records for a retrain.

Not ported: quarantine, pipe converters, preload threads, global shuffles
across nodes, pv merge, the carried boundary, the overlapped writeback and
the asynchronous end pass.
"""

from __future__ import annotations

import glob
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence

import numpy as np

from paddlebox_tpu_torch import config
from paddlebox_tpu_torch.data.parser import parse_line
from paddlebox_tpu_torch.data.record_store import ColumnarRecords
from paddlebox_tpu_torch.data.slot_record import SlotBatch, SlotRecord, build_batch
from paddlebox_tpu_torch.data.slot_schema import SlotSchema
from paddlebox_tpu_torch.table.sparse_table import HostSparseTable, PassWorkingSet

_SHUFFLE_MODES = ("none", "local")


@dataclass
class PassStats:
    """Counts of one pass's load."""

    files: int = 0
    records: int = 0  # records kept for the pass
    keys: int = 0  # unique feasigns in the working set (set at begin_pass)


def _working_set(store: Optional[ColumnarRecords], records: List[SlotRecord]) -> PassWorkingSet:
    """A fresh working set fed every feasign of the pass (MergeInsKeys
    parity), from the columnar store or else the record list."""
    ws = PassWorkingSet()
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
    ):
        if shuffle_mode not in _SHUFFLE_MODES:
            raise NotImplementedError(
                f"shuffle_mode {shuffle_mode!r}: only {_SHUFFLE_MODES} are ported"
            )
        self.schema = schema
        self.table = table
        self.batch_size = batch_size
        self.read_threads = read_threads
        self.shuffle_mode = shuffle_mode
        self.seed = seed

        self.date: Optional[str] = None
        self.pass_id = 0
        self._filelist: List[str] = []
        # pass data lives EITHER columnar (store + shuffle order, the native
        # tier) or as a SlotRecord list (the Python tier); the `records`
        # property materializes a view list of a store on demand
        self.store: Optional[ColumnarRecords] = None
        self._order: Optional[np.ndarray] = None
        self._records: List[SlotRecord] = []
        self.ws: Optional[PassWorkingSet] = None
        self.device_table: Optional[np.ndarray] = None
        self.stats = PassStats()
        self._in_pass = False
        # (store, order, records, ws, stats) loaded but not yet begun
        self._staged = None
        self._guard = None  # the armed PassGuard of the open pass, if any

    # ---- record access ---------------------------------------------------

    @property
    def records(self) -> List[SlotRecord]:
        """The pass as SlotRecords, in shuffle order. A store-backed pass
        materializes views of its store once, on first access."""
        if not self._records and self.store is not None and len(self.store):
            order = self._order if self._order is not None else range(len(self.store))
            self._records = [self.store.record(int(i)) for i in order]
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
        """Threaded read -> shuffle -> staged pass data + working-set keys.

        Loads into a staging slot; ``begin_pass`` consumes it. When no pass
        is open the load is published at once, so ``memory_data_size`` and
        ``records`` show it."""
        if self._staged is not None:
            raise RuntimeError("staged pass not yet consumed by begin_pass")
        stats = PassStats(files=len(self._filelist))
        parts: list = []
        if self._filelist:
            with ThreadPoolExecutor(max_workers=max(1, self.read_threads)) as pool:
                parts = list(pool.map(self._read_one, self._filelist))
        store, order, records = self._normalize_and_shuffle(parts)
        ws = _working_set(store, records)
        stats.records = len(store) if store is not None else len(records)
        self._staged = (store, order, records, ws, stats)
        if not self._in_pass:
            self._publish(self._staged)

    def _publish(self, staged) -> None:
        self.store, self._order, self._records, self.ws, self.stats = staged

    # ---- pass lifecycle --------------------------------------------------

    def begin_pass(
        self, round_to: int = 512, enable_revert: bool = False, trainer=None
    ) -> np.ndarray:
        """Consume the staged load, finalize the working set against the
        host table, and return the pass table [1, cap, width] for the
        device (BeginFeedPass + EndFeedPass + BeginPass).

        ``enable_revert=True`` arms a PassGuard (Confirm/Revert parity,
        fleet_wrapper.h:319-321): the pass keys' pre-train rows and, with
        ``trainer``, its dense params and optimizer state are snapshotted so
        :meth:`revert_pass` can reject everything the pass publishes;
        end_pass confirms."""
        if self._in_pass:
            raise RuntimeError(
                "previous pass is still open: call end_pass (or, after a failed "
                "end_pass, retry it or revert_pass) first"
            )
        if self._staged is not None:
            self._publish(self._staged)
            self._staged = None
        if self.ws is None:
            raise RuntimeError("load_into_memory first")
        if not self.ws._finalized:
            self.device_table = self.ws.finalize(self.table, round_to=round_to)
        self.stats.keys = self.ws.n_keys
        self._in_pass = True
        self._guard = None
        if enable_revert:
            from paddlebox_tpu_torch.train.rollback import PassGuard

            self._guard = PassGuard(self.table, trainer)
            self._guard.begin(self.ws.sorted_keys)
        return self.device_table

    def revert_pass(self) -> None:
        """Reject the open pass (Revert parity, fleet_wrapper.h:319-321):
        every pass key's host row returns to its pre-pass value (undoing a
        partial or complete writeback), the trainer's dense state is
        restored, any staged next pass is dropped, and the same records are
        re-armed with a fresh working set so ``begin_pass`` retrains them."""
        guard = self._guard
        if guard is None or not guard.armed:
            raise RuntimeError("no armed rollback — begin_pass(enable_revert=True) first")
        guard.revert()
        self._guard = None
        self._staged = None
        self.ws = _working_set(self.store, self._records)
        if self.store is not None:
            self.store.invalidate_rows()  # its rows resolved against the old set
        self.device_table = None
        self._in_pass = False

    def end_pass(
        self,
        trained_table: Optional[np.ndarray] = None,
        need_save_delta: bool = False,
        delta_dir: Optional[str] = None,
        shrink: bool = True,
    ) -> dict:
        """EndPass parity (box_wrapper.cc:627, SaveDelta :1316), in the JAX
        package's order: write the trained rows back to the host table,
        decay and shrink it, save a delta of the touched keys to
        ``delta_dir`` when ``need_save_delta``, spill cold rows past the
        table's ``mem_cap_rows`` to its disk tier, publish the tier gauges,
        and confirm an armed PassGuard. ``trained_table`` is the pass table
        on the host, as ``CTRTrainer.trained_table()`` returns it; None
        skips the writeback. A failure leaves the pass open, so end_pass
        can be retried or the pass reverted. Returns {"dropped",
        "delta_keys", "secs"}."""
        if not self._in_pass:
            raise RuntimeError("begin_pass first")
        if need_save_delta and delta_dir is None:
            raise ValueError("need_save_delta requires delta_dir")
        t0 = time.perf_counter()
        table = self.table
        if trained_table is not None:
            self.ws.writeback(np.asarray(trained_table))
        dropped = table.decay_and_shrink() if shrink else 0
        saved = table.save_delta(delta_dir) if need_save_delta else 0
        table.maybe_spill()
        table.publish_tier_stats()
        if self._guard is not None:
            self._guard.confirm()  # the pass is published
            self._guard = None
        self.store = None
        self._order = None
        self._records = []
        self.ws = None
        self.device_table = None
        self._in_pass = False
        return {"dropped": dropped, "delta_keys": saved, "secs": time.perf_counter() - t0}

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
