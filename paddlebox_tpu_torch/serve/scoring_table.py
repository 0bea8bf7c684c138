"""Atomic-swap scoring table: the follower's serve-side model state.

Port of the JAX package's ``serve/scoring_table.py`` host path. A serving
fleet must never answer a request from a half-applied delta:

- :class:`TableVersion` — one immutable published state: sorted keys, a
  :class:`ReplicaCache` holding the rows, the dense params (the port's
  DeepFM ``state_dict``) and the publish metadata the staleness metric
  is computed from.
- :class:`ScoringTable` — holds the currently served version behind a
  lock. :meth:`ScoringTable.commit` builds the next version completely off
  to the side and installs it with a single reference swap; scorers that
  grabbed the old version mid-request keep a complete consistent table.

Fault site ``serve.apply_delta`` fires after the next version is fully
built but before the swap. The mesh-sharded device tier
(``DeviceScoringTier``) waits for the multi-GPU slice.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Tuple

import numpy as np

from paddlebox_tpu_torch.table.replica_cache import ReplicaCache
from paddlebox_tpu_torch.utils.faultinject import fire as _fault_fire
from paddlebox_tpu_torch.utils.monitor import STAT_ADD, STAT_SET


class TableVersion:
    """One immutable served state. Never mutated after construction —
    that immutability is what makes the ScoringTable swap atomic."""

    __slots__ = (
        "date",
        "delta_idx",
        "decay_epoch",
        "published_unix",
        "keys",
        "cache",
        "rows",
        "params",
        "opt_state",
        "first_served_unix",
    )

    def __init__(
        self,
        date: Optional[str],
        delta_idx: int,
        decay_epoch: int,
        published_unix: Optional[float],
        keys: np.ndarray,
        cache: ReplicaCache,
        params=None,
        opt_state=None,
    ):
        self.date = date
        self.delta_idx = delta_idx
        self.decay_epoch = decay_epoch
        self.published_unix = published_unix
        self.keys = keys  # uint64 [n], sorted
        self.cache = cache
        # the dense params this sparse state pairs with, carried in the
        # version so the pair swaps atomically
        self.params = params
        self.opt_state = opt_state
        # materialized once (versions are immutable) so lookups are a
        # searchsorted + fancy-index, not a per-request stack
        self.rows = cache.host_array()  # f32 [n, width]
        # stamped by the server the first time a request is answered from
        # this version. Single batcher thread writes it.
        self.first_served_unix: Optional[float] = None

    @property
    def n_rows(self) -> int:
        return len(self.keys)

    def lookup_rows(self, keys: np.ndarray) -> Tuple[np.ndarray, int]:
        """Rows for uint64 ``keys``; returns (rows [n, width], miss count).

        Missing keys get the zero row: a key the published model has never
        seen scores from a cold embedding.
        """
        q = np.asarray(keys, dtype=np.uint64)
        out = np.zeros((len(q), self.cache.dim), dtype=np.float32)
        n_miss = len(q)
        if len(self.keys) and len(q):
            pos = np.searchsorted(self.keys, q)
            pos = np.minimum(pos, len(self.keys) - 1)
            hit = self.keys[pos] == q
            out[hit] = self.rows[pos[hit]]
            n_miss = int(np.count_nonzero(~hit))
        if n_miss:
            # the zero-row fallback is intentional but must never be silent
            STAT_ADD("serve.key_misses", n_miss)
        return out, n_miss


def _empty_version(width: int) -> TableVersion:
    return TableVersion(
        date=None,
        delta_idx=-1,
        decay_epoch=0,
        published_unix=None,
        keys=np.zeros(0, dtype=np.uint64),
        cache=ReplicaCache(width),
    )


class ScoringTable:
    """The follower's served table: an atomically swappable TableVersion.

    Readers call :meth:`version` once per request and use that object for
    the whole request; writers call :meth:`commit` with the complete next
    state. There is no in-place mutation path on purpose.
    """

    def __init__(self, width: int):
        self.width = width
        self._lock = threading.Lock()
        self._version: TableVersion = _empty_version(width)  # guarded-by: _lock
        self._history: List[int] = []  # guarded-by: _lock  (committed delta idxs)

    def version(self) -> TableVersion:
        with self._lock:
            return self._version

    def committed_indices(self) -> List[int]:
        """Delta indices in commit order."""
        with self._lock:
            return list(self._history)

    def commit(
        self,
        keys: np.ndarray,
        rows: np.ndarray,
        *,
        date: str,
        delta_idx: int,
        decay_epoch: int,
        published_unix: Optional[float] = None,
        params=None,
        opt_state=None,
        hotness: Optional[np.ndarray] = None,
    ) -> TableVersion:
        """Build and install the next version, all-or-nothing.

        ``keys`` must be sorted uint64 with ``rows`` aligned ([n, width]).
        ``hotness`` would opt the version into the device scoring tier,
        which is not ported yet. Everything expensive happens before the
        swap; the swap itself is one reference assignment under the lock.
        """
        if hotness is not None:
            raise NotImplementedError(
                "the device scoring tier (hotness=...) is not ported yet"
            )
        cache = ReplicaCache(self.width)
        if len(rows):
            cache.add_batch(rows)
        nxt = TableVersion(
            date=date,
            delta_idx=delta_idx,
            decay_epoch=decay_epoch,
            published_unix=published_unix,
            keys=np.asarray(keys, dtype=np.uint64),
            cache=cache,
            params=params,
            opt_state=opt_state,
        )
        _fault_fire("serve.apply_delta")  # window: built, not yet visible
        with self._lock:
            self._version = nxt
            self._history.append(delta_idx)
        cache.publish_serve_stats()
        STAT_SET("serve.version_delta_idx", delta_idx)
        STAT_ADD("serve.version_commits")
        return nxt
