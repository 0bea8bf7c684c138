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
built but before the swap.

The device scoring tier (:class:`DeviceScoringTier`, the PullSparseGPU
analog for serving): with ``hotness`` a commit keeps exact fp32 copies of
the version's hottest rows (decayed show >= ``device_tier_hot_show``, at
most ``device_tier_capacity``) on the devices, sharded by the key's hash;
lookups route the hit keys through :func:`sharded_serve_pull` in
``serve_key_bucket``-bucketed requests, and only tier misses read the
host rows. The JAX package's tier is one process over a mesh of local
devices; the port's is one process holding shard ``s`` on ``devices[s]``
(by default ``cuda:i`` for every visible card) with no process group.
The tier is built inside :meth:`ScoringTable.commit` (fault site
``serve.tier_build`` at its start) and rides the version, so it installs
under the same single swap as the host rows. There is no quiet host-only
fallback: a tier asked for on a host without a GPU raises unless the
table was given an explicit device (``"cpu"``).
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from paddlebox_tpu_torch import config
from paddlebox_tpu_torch.table.replica_cache import ReplicaCache
from paddlebox_tpu_torch.table.sparse_table import key_to_shard
from paddlebox_tpu_torch.utils.faultinject import fire as _fault_fire
from paddlebox_tpu_torch.utils.monitor import STAT_ADD, STAT_SET

TierDevices = Union[str, torch.device, Sequence[Union[str, torch.device]], None]


def tier_devices(device: TierDevices) -> List[torch.device]:
    """The tier's shard devices: one a visible card for None (raising on
    a host without one), ``[device]`` for one device, else each entry."""
    if device is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError(
                "the device scoring tier needs a GPU: none is visible. Pass device='cpu' "
                "to ScoringTable / Follower to hold the tier on the CPU, or turn "
                "device_scoring_tier off"
            )
        return [torch.device("cuda", i) for i in range(n)]
    if isinstance(device, (str, torch.device)):
        return [torch.device(device)]
    return [torch.device(d) for d in device]


class DeviceScoringTier:
    """The hot-row tier of one TableVersion, immutable after the build (as
    the version is): each shard's sorted keys stay on the host for
    routing, its rows [cap, width] (the last one a zero padding row) live
    on its device."""

    def __init__(self, devices: Sequence[torch.device], keys: np.ndarray, rows: np.ndarray):
        from paddlebox_tpu_torch.data.device_pack import _round_bucket

        self.devices = list(devices)
        self.n_shards = len(self.devices)
        self.width = int(rows.shape[1])
        keys = np.asarray(keys, dtype=np.uint64)
        owner = key_to_shard(keys, self.n_shards)
        counts = np.bincount(owner, minlength=self.n_shards)
        # +1 reserves a zero padding row a shard; rounding bounds the shapes
        cap = _round_bucket(int(counts.max()) + 1 if len(keys) else 1, int(config.get_flag("serve_row_bucket")))
        self._shard_keys: List[np.ndarray] = []
        self.tables: List[torch.Tensor] = []
        for s, dev in enumerate(self.devices):
            sel = np.nonzero(owner == s)[0]
            sk = keys[sel]
            order = np.argsort(sk)
            self._shard_keys.append(sk[order])
            block = np.zeros((cap, self.width), dtype=np.float32)
            block[: len(sk)] = rows[sel][order]
            self.tables.append(torch.from_numpy(block).to(dev))
        self.pad_rank = cap - 1
        self.n_rows = int(len(keys))
        # hit/miss tallies of this tier, for the follower's health snapshot
        self._stat_lock = threading.Lock()
        self.hits = 0  # guarded-by: _stat_lock
        self.misses = 0  # guarded-by: _stat_lock

    def mem_used_mb(self) -> float:
        return self.n_shards * (self.pad_rank + 1) * self.width * 4 / 1024.0 / 1024.0

    def route(self, keys: np.ndarray):
        """The routed request for uint64 ``keys``: (hit bool [n], req, pos,
        K) where ``req``/``pos``/``K`` are :func:`route_serve_requests`'s
        for the hit keys (req [n_shards, n_shards, K]: row ``s`` names the
        local rows shard ``s`` gathers), or (hit, None, None, 0) when
        nothing hits."""
        from paddlebox_tpu_torch.data.device_pack import route_serve_requests

        q = np.asarray(keys, dtype=np.uint64)
        hit = np.zeros(len(q), dtype=bool)
        local = np.zeros(len(q), dtype=np.int64)
        if not (len(q) and self.n_rows):
            return hit, None, None, 0
        owner = key_to_shard(q, self.n_shards)
        for s in range(self.n_shards):
            sel = np.nonzero(owner == s)[0]
            sk = self._shard_keys[s]
            if len(sel) == 0 or len(sk) == 0:
                continue
            pos = np.minimum(np.searchsorted(sk, q[sel]), len(sk) - 1)
            hit[sel] = sk[pos] == q[sel]
            local[sel] = pos
        idx = np.nonzero(hit)[0]
        if len(idx) == 0:
            return hit, None, None, 0
        req, pos, k = route_serve_requests(
            owner[idx], local[idx], self.n_shards, int(config.get_flag("serve_key_bucket")), self.pad_rank
        )
        return hit, req, pos, k

    def lookup_rows(self, keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Tier rows for uint64 ``keys``: (rows [n, width], hit bool [n]).
        A hit row is bitwise the committed version's row (exact copies, a
        pure routed gather); a miss row is zero, for the host to fill."""
        from paddlebox_tpu_torch.parallel.sharded_pullpush import sharded_serve_pull

        m = len(keys)
        out = np.zeros((m, self.width), dtype=np.float32)
        hit, req, pos, _ = self.route(keys)
        if req is not None:
            pulled = sharded_serve_pull(self.tables, torch.from_numpy(req))
            out[hit] = pulled.reshape(-1, self.width).numpy()[pos]
        n_hit = int(np.count_nonzero(hit))
        with self._stat_lock:
            self.hits += n_hit
            self.misses += m - n_hit
        return out, hit


def build_device_tier(keys: np.ndarray, rows: np.ndarray, hotness: np.ndarray, device: TierDevices = None):
    """Select the hot rows and place them on the tier's devices. Runs in
    the commit's build window: the ``serve.tier_build`` fault site fires
    first, so a crash mid-build aborts the commit before anything is
    visible. Raises on a host without a GPU unless ``device`` names one."""
    devices = tier_devices(device)
    _fault_fire("serve.tier_build")  # window: tier building, nothing visible
    hotness = np.asarray(hotness, dtype=np.float32)
    idx = np.nonzero(hotness >= float(config.get_flag("device_tier_hot_show")))[0]
    cap = int(config.get_flag("device_tier_capacity"))
    if len(idx) > cap:
        # the hottest rows win; the stable sort keeps show ties
        # deterministic, so a healed retry rebuilds the same tier
        keep = np.argsort(-hotness[idx], kind="stable")[:cap]
        idx = np.sort(idx[keep])
    tier = DeviceScoringTier(devices, keys[idx], rows[idx])
    STAT_SET("serve.device_tier_rows", tier.n_rows)
    STAT_SET("serve.device_tier_mem_mb", tier.mem_used_mb())
    STAT_ADD("serve.device_tier_builds")
    return tier


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
        "device_tier",
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
        device_tier: Optional[DeviceScoringTier] = None,
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
        # the hot tier (None: host-only serving), built by commit so it
        # installs under the same swap as the rows
        self.device_tier = device_tier
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

    def lookup_rows_tiered(self, keys: np.ndarray) -> Tuple[np.ndarray, int, int]:
        """The miss-fallback ladder: the device tier first, the host rows
        for its misses. Returns (rows [n, width], tier misses, key misses),
        the rows bitwise :meth:`lookup_rows`'s. ``serve.device_tier_misses``
        counts keys the tier did not hold (a capacity signal),
        ``serve.key_misses`` keys the version never saw (a lineage one)."""
        if self.device_tier is None:
            rows, n_key_miss = self.lookup_rows(keys)
            return rows, 0, n_key_miss
        q = np.asarray(keys, dtype=np.uint64)
        rows, hit = self.device_tier.lookup_rows(q)
        n_hit = int(np.count_nonzero(hit))
        n_tier_miss = len(q) - n_hit
        if n_hit:
            STAT_ADD("serve.device_tier_hits", n_hit)
        n_key_miss = 0
        if n_tier_miss:
            STAT_ADD("serve.device_tier_misses", n_tier_miss)
            cold = ~hit
            rows[cold], n_key_miss = self.lookup_rows(q[cold])
        return rows, n_tier_miss, n_key_miss


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

    def __init__(self, width: int, device: TierDevices = None):
        """``device``: where a commit with ``hotness`` holds its tier — a
        device, a list of them (one shard each), or None for every visible
        card (raising at such a commit on a host without one)."""
        self.width = width
        self.device = device
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
        ``hotness`` (decayed shows aligned with ``keys``) opts the version
        into the device scoring tier on the table's ``device``; None keeps
        the host-only path bitwise. Everything expensive (the cache, the
        rows, the tier) happens before the swap; the swap itself is one
        reference assignment under the lock. A failure before it (the
        ``serve.tier_build`` and ``serve.apply_delta`` fault sites sit in
        that window) leaves the previous version served.
        """
        cache = ReplicaCache(self.width)
        if len(rows):
            cache.add_batch(rows)
        tier = None
        if hotness is not None and len(keys):
            tier = build_device_tier(
                np.asarray(keys, dtype=np.uint64), np.asarray(rows, dtype=np.float32), hotness, self.device
            )
        nxt = TableVersion(
            date=date,
            delta_idx=delta_idx,
            decay_epoch=decay_epoch,
            published_unix=published_unix,
            keys=np.asarray(keys, dtype=np.uint64),
            cache=cache,
            params=params,
            opt_state=opt_state,
            device_tier=tier,
        )
        _fault_fire("serve.apply_delta")  # window: built, not yet visible
        with self._lock:
            self._version = nxt
            self._history.append(delta_idx)
        cache.publish_serve_stats()
        STAT_SET("serve.version_delta_idx", delta_idx)
        STAT_ADD("serve.version_commits")
        return nxt
