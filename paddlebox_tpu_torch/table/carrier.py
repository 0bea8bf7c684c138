"""Device-carried pass table: the trained rows stay on the card across passes.

Port of the JAX package's ``table/carrier.py`` for one device. The classic
boundary fetches the whole trained table to the host and uploads the whole
next one, though consecutive passes share most of their keys. The carrier
uses the overlap:

- ``end_pass`` keeps the trained device table (no copy to the host);
- the next finalize splices the rows of keys that stay into the new pass
  table on the device (with the boundary's show/clk decay), fetches and
  pushes to the host store only the rows of keys that leave, and uploads
  only the rows of new keys;
- every save drains the pending carriers first
  (``HostSparseTable.drain_pending``), so what is durable holds the
  trained values.

Against the classic boundary a carried key is exempt from the boundary's
shrink while it stays carried, so the two agree bitwise only at
``shrink_threshold=0``; between a boundary and a flush the host store holds
the pre-pass rows of carried keys.

The device work goes through the port's two row kernels: a carried row is a
row gather (``pull_rows_cuda`` on a CUDA table), multiplied by the owed
decay. The carried tensor is the trainer's own table, which the step writes
in place, so the trainer copies the next pass's table rather than train on
this one (``CTRTrainer._make_state``).

On a single-host mesh (``plan``) each rank carries its own shard
[cap, width] of the pass table (the JAX package carries the whole
[ns*cap, width] array in one process). A key's owner shard is a stable
hash of the key with the same shard count in every pass, so a surviving
key stays on its rank and splices there. The host tables are replicas, so
every rank must receive every row the host is owed: the departing rows
and, at a flush, the carried ones. Each rank gathers those of its shard
(the counts of every shard are known to all from the replicated working
set), pads them to the largest count, and one ``all_gather`` puts every
shard's rows on every rank, reordered to the keys' order before the
``wire_dtype`` wire. So every rank pushes the same bytes, the same as one
device would. These collectives run on the calling thread: a mesh
carrier splices and flushes on the main thread of every rank alike, in
the dataset's boundary calls and ``BoxPSDataset.flush_carried``, never on
a background thread; a save that reaches a pending mesh carrier raises
(``HostSparseTable.drain_pending``).

The multi-host carrier (``MultiHostCarrier``) is not ported (ROADMAP
Queue 1 item 5.3).
"""

from __future__ import annotations

import threading
from concurrent.futures import Future
from typing import Optional

import numpy as np
import torch

from paddlebox_tpu_torch import config
from paddlebox_tpu_torch.ops.pull_push import gather_rows
from paddlebox_tpu_torch.ops.wire_quant import fetch_rows, fetch_rows_finish, fetch_rows_start


class TableCarrier:
    """One pass's trained device table, pending splice or flush.

    Built at ``end_pass`` (no transfer), spliced by the next finalize and
    flushed by ``flush``. It stays alive after the splice, so a save during
    the next pass can still flush what the host is owed: this table's
    values (the next pass trains its own table)."""

    def __init__(self, dev_flat: torch.Tensor, ws, layout, decay: Optional[float] = None, plan=None):
        # the single-device table, [rows, width] or [1, cap, width]; on a
        # mesh (``plan``) this rank's shard [cap, width]
        if dev_flat.dim() == 3:
            dev_flat = dev_flat.reshape(-1, dev_flat.shape[-1])
        if plan is not None and dev_flat.shape[0] != ws.capacity:
            raise ValueError(f"a mesh carrier holds one shard of {ws.capacity} rows, got {dev_flat.shape[0]}")
        self.dev_flat = dev_flat
        self.ws = ws
        self.layout = layout
        self.plan = plan
        # show/clk decay owed to the carried rows: every decay_and_shrink
        # while this carrier is pending notes one, under the table's
        # maintenance lock, so no boundary is missed or counted twice
        self._decay_accum = 1.0 if decay is None else float(decay)
        self._flushed = False
        # the in-flight departure push; the lock covers the handle only,
        # so wait_push and join_push can block on it together
        self._push_lock = threading.Lock()
        self._push_fut = None  # guarded-by: _push_lock
        self._push_thread: Optional[threading.Thread] = None  # guarded-by: _push_lock
        # ws-order positions handed back to the host already: flush must
        # not push them again (the host row is live once a key departs)
        self._departed: Optional[np.ndarray] = None

    @property
    def flushed(self) -> bool:
        return self._flushed

    def note_decay(self, rate: float) -> None:
        """Record one boundary's show/clk decay (applied at splice/flush)."""
        self._decay_accum *= float(rate)

    def supersede(self) -> None:
        """A newer full writeback (a classic end_pass or a later carrier)
        covers every value this carrier owed: join the departure push,
        release the device table and go inert."""
        self.join_push()
        self._flushed = True
        self.dev_flat = None

    def _decay_mult(self) -> Optional[np.ndarray]:
        if self._decay_accum == 1.0:
            return None
        lay = self.layout
        mult = np.ones(lay.width, dtype=np.float32)
        mult[lay.SHOW] = self._decay_accum
        mult[lay.CLK] = self._decay_accum
        return mult

    def _local_rows(self, rows: np.ndarray) -> np.ndarray:
        """Global table rows -> rows of the carried tensor (on a mesh, of
        this rank's shard)."""
        if self.plan is None:
            return rows
        return rows - self.plan.rank * self.ws.capacity

    def rows_for(self, positions: np.ndarray) -> torch.Tensor:
        """The (decayed) device rows of ws-order key positions [k] (on a
        mesh, of keys in this rank's shard): a row gather, then the fp32
        decay multiply. Stays on the device."""
        dev = self.dev_flat.device
        local = self._local_rows(self.ws.row_of_sorted[positions])
        ids = torch.from_numpy(np.ascontiguousarray(local)).to(dev)
        vals = gather_rows(self.dev_flat, ids)
        mult = self._decay_mult()
        if mult is not None:
            vals = vals * torch.from_numpy(mult).to(dev)[None, :]
        return vals

    def rows_everywhere(self, positions: np.ndarray) -> torch.Tensor:
        """The (decayed) rows of ws-order key positions of any shard, on
        this rank's device, in ``positions`` order. One device: ``rows_for``.
        A mesh: each rank gathers its shard's positions, padded with zero
        rows to the largest shard's count, and one ``all_gather`` brings
        every shard's rows here (every rank calls it alike)."""
        if self.plan is None:
            return self.rows_for(positions)
        plan, cap = self.plan, self.ws.capacity
        positions = np.asarray(positions, dtype=np.int64)
        shard = self.ws.row_of_sorted[positions] // cap
        counts = np.bincount(shard, minlength=plan.world)
        n_max = int(counts.max()) if len(positions) else 0
        dev = self.dev_flat.device
        if n_max == 0:
            return torch.zeros((0, self.layout.width), dtype=torch.float32, device=dev)
        vals = self.rows_for(positions[shard == plan.rank])
        pad = torch.zeros((n_max - vals.shape[0], vals.shape[1]), dtype=vals.dtype, device=dev)
        every = plan.all_gather(torch.cat([vals, pad]))  # [world, n_max, W]
        # shard s's rows, in positions order: its j-th position is row j
        order = np.argsort(shard, kind="stable")
        slot = np.arange(len(positions)) - np.repeat(np.cumsum(counts) - counts, counts)
        flat = np.empty(len(positions), dtype=np.int64)
        flat[order] = shard[order] * n_max + slot
        return every.reshape(-1, every.shape[-1]).index_select(0, torch.from_numpy(flat).to(dev))

    def fetch_for(self, positions: np.ndarray) -> np.ndarray:
        """Host copy (decayed) of ws-order key positions over the
        ``wire_dtype`` wire (on a mesh, of every shard's keys)."""
        return fetch_rows(self.rows_everywhere(positions), self.layout, str(config.get_flag("wire_dtype")))

    def push_departures_async(self, table, keys: np.ndarray, positions) -> None:
        """Push the departing slice on a non-daemon thread. The gather, the
        casts and the copy to the host are queued now, on this thread, so
        they read this table's values; the worker waits for the copy and
        pushes. Joined by ``flush`` and by the next end_pass before its
        decay (a push landing after a decay would undo it). On a mesh the
        rows of every shard's departing keys are gathered here first."""
        mode = str(config.get_flag("wire_dtype"))
        handle = fetch_rows_start(self.rows_everywhere(positions), self.layout, mode)
        pos = np.asarray(positions)
        self._departed = pos if self._departed is None else np.union1d(self._departed, pos)
        fut: Future = Future()

        def work():
            try:
                table.push(keys, fetch_rows_finish(handle, self.layout))
                fut.set_result(len(keys))
            except BaseException as e:  # surfaced by join_push
                fut.set_exception(e)

        th = threading.Thread(target=work, name="carrier-departures", daemon=False)
        th.start()
        with self._push_lock:
            self._push_fut = (fut, pos)
            self._push_thread = th

    def join_push(self) -> None:
        """Wait for the departure push (idempotent). A failed push
        un-departs its positions, so a later ``flush`` pushes them."""
        with self._push_lock:
            fut_pos, self._push_fut = self._push_fut, None
            th, self._push_thread = self._push_thread, None
        if fut_pos is None:
            return
        fut, pos = fut_pos
        try:
            fut.result()
        except BaseException:
            if self._departed is not None:
                self._departed = np.setdiff1d(self._departed, pos)
            raise
        finally:
            th.join()

    def wait_push(self) -> None:
        """Block until the departure push lands, leaving its handle and any
        failure to ``join_push`` (the staged prefetch must not read a
        departing key's pre-push row)."""
        with self._push_lock:
            fut_pos = self._push_fut
        if fut_pos is not None:
            fut_pos[0].exception()  # waits; a failure stays for join_push

    def flush(self, table) -> int:
        """Push every carried key's (decayed) row to the host store, in
        chunks of 2M keys. Idempotent; returns the keys written. On a mesh
        every rank flushes alike: each chunk is one all-gather."""
        self.join_push()
        if self._flushed or self.ws is None or self.ws.n_keys == 0:
            self._flushed = True
            self.dev_flat = None
            return 0
        pos = np.arange(self.ws.n_keys)
        if self._departed is not None:
            pos = np.setdiff1d(pos, self._departed, assume_unique=True)
        chunk = 2_000_000
        for lo in range(0, len(pos), chunk):
            p = pos[lo : lo + chunk]
            table.push(self.ws.sorted_keys[p], self.fetch_for(p))
        self._flushed = True
        self.dev_flat = None
        return len(pos)
