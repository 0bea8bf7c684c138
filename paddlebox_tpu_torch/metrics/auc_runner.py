"""AucRunner: slot-shuffle feature-importance evaluation.

Port of the JAX package's ``metrics/auc_runner.py``: the pools and the
replacements are numpy draws from the same seeds, so the shuffled records
are bitwise that package's.

Re-expresses the reference's AucRunner mode (BoxWrapper::InitializeAucRunner
box_wrapper.h:680-712, GetRandomReplace / RecordReplace / RecordReplaceBack
box_wrapper.cc:652-790, FeasignValuesCandidateList / FeasignValuesReplacer
data_feed.h:1075-1244, BoxHelper::SlotsShuffle box_wrapper.h:961-985):

To score how much a slot (feature) contributes, the trained model is
evaluated on the pass data with that slot's feasigns *replaced* by feasigns
drawn from other random records ("slot shuffle") — the AUC drop vs. the
unshuffled eval is the slot's importance.

Mechanics mirrored from the reference:

- **Candidate pools** (``CandidatePool``): reservoir samples of per-slot
  feasign lists collected from the pass's own records. ``pool_num`` pools
  divide the data (records are assigned round-robin like the reference's
  ``j % auc_runner_pool_div``) so candidates come from a bounded window.
- **Per-record assignment**: every record gets (pool_id, replaced_id) once
  per pass (``observe``), so each eval phase replaces a record's chosen
  slots with the *same* candidate — deterministic across slot groups, which
  keeps phase-to-phase AUC diffs attributable to the slots, not the draw.
- **replace / replace_back** (``slots_shuffle``): swapping slot s's keys in
  a record changes its length, so the flat (values, offsets) arrays are
  rebuilt per record; originals are stashed for exact restoration, matching
  FeasignValuesReplacer::replace/replace_back semantics.
- **Phase flip**: each ``slots_shuffle`` call flips the runner phase
  (BoxWrapper::FlipPhase parity, box_wrapper.h:620-622) so phase-filtered
  metrics (metrics/registry.py) separate shuffled-eval AUC from train AUC.

The per-record Python loop is the C++ thread-pool loop's analog; records are
host objects and this runs between device passes, off the device path.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Set

import numpy as np

from paddlebox_tpu_torch.data.slot_record import SlotRecord
from paddlebox_tpu_torch.data.slot_schema import SlotSchema


class CandidatePool:
    """Reservoir of per-slot feasign lists (FeasignValuesCandidateList parity).

    Each candidate is ``{slot_idx: uint64 values}`` captured from one record
    for the replaced slots. ``add_and_get`` both reservoir-inserts the
    record's own values and returns the id of the candidate the record will
    use when shuffled (AddAndGet, data_feed.h:1099-1123 — sans the
    multi-pass new/cache queues, which exist only to bound C++ reallocation).
    """

    def __init__(self, capacity: int, rng: np.random.Generator):
        self.capacity = capacity
        self._rng = rng
        self._seen = 0
        self.candidates: List[Dict[int, np.ndarray]] = []

    def __len__(self) -> int:
        return len(self.candidates)

    @property
    def full(self) -> bool:
        return len(self.candidates) == self.capacity

    def add_and_get(self, values: Dict[int, np.ndarray]) -> int:
        self._seen += 1
        if not self.full:
            self.candidates.append(values)
        else:
            # reservoir: replace a random existing candidate with prob cap/seen
            j = int(self._rng.integers(0, self._seen))
            if j < self.capacity:
                self.candidates[j] = values
        return int(self._rng.integers(0, len(self.candidates)))

    def get(self, replaced_id: int) -> Dict[int, np.ndarray]:
        return self.candidates[replaced_id]


class AucRunner:
    """Slot-shuffle eval driver over a pass's in-memory records.

    Usage (mirrors test sequence around BoxHelper::SlotsShuffle):

        runner = AucRunner(schema, replaced_slots=["s3", "s7"], capacity=1000)
        runner.observe(dataset.records)            # build pools + assignment
        runner.slots_shuffle(dataset.records, {"s3"})   # eval phase: s3 shuffled
        ... evaluate, read AUC ...
        runner.slots_shuffle(dataset.records, set())    # restore all
    """

    def __init__(
        self,
        schema: SlotSchema,
        replaced_slots: Sequence[str],
        capacity: int = 10000,
        pool_num: int = 1,
        seed: int = 0,
    ):
        self.schema = schema
        self.replaced_slot_idx: Set[int] = {
            schema.sparse_slot_index(s) for s in replaced_slots
        }
        self.pool_num = pool_num
        self._rng = np.random.default_rng(seed)
        self.pools = [CandidatePool(capacity, self._rng) for _ in range(pool_num)]
        # per-record assignment, parallel to the observed record list
        self._pool_id: Optional[np.ndarray] = None
        self._replaced_id: Optional[np.ndarray] = None
        # record_id -> {slot_idx: original values} while shuffled
        self._saved: List[Optional[Dict[int, np.ndarray]]] = []
        self.last_slots: Set[int] = set()
        self.phase = 1
        self._lock = threading.Lock()

    # ---- pass setup ------------------------------------------------------

    def observe(self, records: Sequence[SlotRecord]) -> None:
        """Build candidate pools from the pass records and fix each record's
        (pool_id, replaced_id) draw (GetRandomReplace parity,
        box_wrapper.cc:736-760)."""
        with self._lock:
            n = len(records)
            self._pool_id = np.arange(n, dtype=np.int64) % self.pool_num
            self._replaced_id = np.zeros(n, dtype=np.int64)
            self._saved = [None] * n
            self.last_slots = set()
            for i, rec in enumerate(records):
                vals = {
                    s: rec.slot_keys(s).copy() for s in self.replaced_slot_idx
                }
                self._replaced_id[i] = self.pools[self._pool_id[i]].add_and_get(vals)

    # ---- shuffle / restore ----------------------------------------------

    def _rebuild(self, rec: SlotRecord, new_vals: Dict[int, np.ndarray]) -> None:
        """Rewrite rec's flat u64 arrays with ``new_vals`` for chosen slots
        (FeasignValuesReplacer offset-fixup parity, vectorized)."""
        n_slots = len(rec.u64_offsets) - 1
        parts = []
        lens = np.empty(n_slots, dtype=np.int64)
        for s in range(n_slots):
            v = new_vals.get(s)
            if v is None:
                v = rec.slot_keys(s)
            parts.append(v)
            lens[s] = len(v)
        rec.u64_values = (
            np.concatenate(parts).astype(np.uint64, copy=False)
            if parts
            else np.zeros(0, np.uint64)
        )
        off = np.zeros(n_slots + 1, dtype=np.uint32)
        np.cumsum(lens, out=off[1:])
        rec.u64_offsets = off

    def slots_shuffle(
        self, records: Sequence[SlotRecord], slots: Set[str]
    ) -> Dict[str, int]:
        """Replace ``slots``' feasigns with pooled candidates; restores the
        previously shuffled slots first (SlotsShuffle driver parity,
        box_wrapper.h:961-985). Empty ``slots`` = restore only. Flips phase.

        Returns {"deleted": n, "added": n} feasign counts like the VLOGs.
        """
        if self._pool_id is None:
            raise RuntimeError("observe(records) must run before slots_shuffle")
        if len(records) != len(self._pool_id):
            raise ValueError("record list changed since observe()")
        slot_idx = {self.schema.sparse_slot_index(s) for s in slots}
        bad = slot_idx - self.replaced_slot_idx
        if bad:
            raise ValueError(
                f"slots {bad} were not declared in replaced_slots at init"
            )
        deleted = added = 0
        with self._lock:
            self.phase ^= 1  # FlipPhase
            for i, rec in enumerate(records):
                new_vals: Dict[int, np.ndarray] = {}
                saved = self._saved[i]
                if saved is not None:  # restore last round's slots
                    for s, orig in saved.items():
                        new_vals[s] = orig
                        deleted += int(rec.u64_offsets[s + 1] - rec.u64_offsets[s])
                        if s not in slot_idx:  # else it never materializes
                            added += len(orig)
                if slot_idx:
                    cand = self.pools[self._pool_id[i]].get(
                        int(self._replaced_id[i])
                    )
                    save: Dict[int, np.ndarray] = {}
                    for s in slot_idx:
                        cur = new_vals.get(s)
                        if cur is None:
                            save[s] = rec.slot_keys(s).copy()
                            deleted += len(save[s])
                        else:  # restored-and-reshuffled: deletion already counted
                            save[s] = cur
                        cv = cand[s]
                        new_vals[s] = cv
                        added += len(cv)
                    self._saved[i] = save
                else:
                    self._saved[i] = None
                if new_vals:
                    self._rebuild(rec, new_vals)
            self.last_slots = slot_idx
        return {"deleted": int(deleted), "added": int(added)}
