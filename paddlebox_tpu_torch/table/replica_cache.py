"""Full-replica row caches: ``ReplicaCache`` and the string-keyed
``InputTable``.

Port of the JAX package's ``table/replica_cache.py`` (GpuReplicaCache and
InputTable parity, box_wrapper.h:140-248):

- ``ReplicaCache``: fixed-dim float rows are appended one at a time
  (``add_items``, the replica-cache line parser's ``#`` lines) or in
  blocks (``add_batch``); ``host_array`` materialises them as one ``[n,
  dim]`` array, and ``to_device`` places that on a card (ToHBM), or on
  every rank of a mesh plan. The serving scoring table builds its
  versions on it.
- :func:`pull_cache_value` gathers cache rows by id inside a step. On a
  CUDA cache it launches the hand-written row gather ``pull_rows_cuda``;
  on a CPU cache it runs the plain version. Either way it answers as the
  JAX package's ``jnp.take(cache, ids.astype(int32), axis=0)``: an id in
  [-R, 0) counts from the end, any other id outside [0, R) gives a row
  of NaN.
- ``InputTable``: string key -> row of floats on the host, with the
  reserved default row 0 (key "-") returned on a miss (miss counter kept).
"""

from __future__ import annotations

import threading
from typing import Any, List

import numpy as np
import torch

from paddlebox_tpu_torch.ops.cuda_kernels import pull_rows_cuda
from paddlebox_tpu_torch.utils.device import DeviceLike, resolve_device
from paddlebox_tpu_torch.utils.monitor import STAT_GET, STAT_SET


def _place(host: np.ndarray, plan: Any, device: DeviceLike) -> torch.Tensor:
    """``host`` on ``device``, or replicated on the plan's device (every
    rank holds the whole table: the per-GPU copy loop of ToHBM)."""
    if plan is not None:
        from paddlebox_tpu_torch.parallel.mesh import put_replicated

        return put_replicated(plan, host)
    return torch.from_numpy(host).to(resolve_device(device))


class ReplicaCache:
    """GpuReplicaCache analog: append-only host rows."""

    def __init__(self, dim: int):
        self.dim = dim
        self._rows: List[np.ndarray] = []  # guarded-by: _lock
        self._lock = threading.Lock()

    def __len__(self) -> int:
        with self._lock:
            return len(self._rows)

    def add_items(self, emb) -> int:
        """Append one row; returns its id (AddItems parity, thread-safe).
        A ``[1, dim]`` input squeezes; any other shape but ``(dim,)``
        raises, both shapes named."""
        row = np.asarray(emb, dtype=np.float32)
        if row.ndim == 2 and row.shape[0] == 1:
            row = row[0]
        if row.ndim != 1:
            raise ValueError(
                f"add_items wants one row of shape ({self.dim},), got shape {row.shape} — "
                "use add_batch for [n, dim] blocks"
            )
        if row.shape[0] != self.dim:
            raise ValueError(f"row dim {row.shape[0]} != cache dim {self.dim}")
        with self._lock:
            self._rows.append(row)
            return len(self._rows) - 1

    def add_batch(self, rows) -> np.ndarray:
        """Append a ``[n, dim]`` block in one locked operation; returns the
        assigned row ids (int64 [n])."""
        block = np.asarray(rows, dtype=np.float32)
        if block.ndim != 2:
            raise ValueError(
                f"add_batch wants a [n, {self.dim}] block, got shape "
                f"{block.shape}"
            )
        if block.shape[1] != self.dim:
            raise ValueError(
                f"add_batch got dim-mismatched rows: shape {block.shape} "
                f"vs cache dim {self.dim}"
            )
        block = np.ascontiguousarray(block)
        with self._lock:
            start = len(self._rows)
            self._rows.extend(block)  # row views share the block's buffer
            return np.arange(start, start + len(block), dtype=np.int64)

    def host_array(self) -> np.ndarray:
        with self._lock:
            if not self._rows:
                return np.zeros((0, self.dim), dtype=np.float32)
            return np.stack(self._rows)

    def to_device(self, plan=None, device: DeviceLike = "cuda") -> torch.Tensor:
        """The rows as one [n, dim] f32 tensor on ``device`` (ToHBM
        parity); with a mesh ``plan``, a replica on the plan's device of
        every rank."""
        return _place(self.host_array(), plan, device)

    def mem_used_mb(self) -> float:
        with self._lock:
            return len(self._rows) * self.dim * 4 / 1024.0 / 1024.0

    def publish_serve_stats(self) -> None:
        """Export size under the serving dashboard namespace; called by the
        scoring table on every version commit."""
        with self._lock:
            n = len(self._rows)
        STAT_SET("serve.replica_rows", n)
        STAT_SET("serve.replica_mem_mb", n * self.dim * 4 / 1024.0 / 1024.0)
        # cumulative lookup misses snapshotted at each commit: the delta
        # between two commits is the miss volume the outgoing version served
        STAT_SET("serve.key_misses_at_commit", float(STAT_GET("serve.key_misses")))


def cache_row_ids(ids: torch.Tensor, n_rows: int) -> torch.Tensor:
    """The JAX package's ids as row ids, on their device: int32 as its
    ``astype`` makes them, then an id in [-R, 0) counted from the end."""
    ids = ids.reshape(-1).to(torch.int32)
    return torch.where(ids < 0, ids + n_rows, ids)


def pull_cache_value_ref(cache: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Plain version of the cache gather at row ids ``rows`` [U]: ``cache[rows]``,
    a NaN row for an id outside [0, R), as the row gather kernel gives it."""
    R = cache.shape[0]
    ok = (rows >= 0) & (rows < R)
    if R == 0:
        picked = torch.zeros((rows.shape[0], cache.shape[1]), dtype=cache.dtype, device=cache.device)
    else:
        picked = cache.index_select(0, torch.where(ok, rows, 0).long())
    nan = torch.full((), float("nan"), dtype=cache.dtype, device=cache.device)
    return torch.where(ok[:, None], picked, nan)


def pull_cache_value(cache: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Gather cache rows by id -> ``ids.shape + [dim]``: the pull_cache_value
    op (pull_box_sparse_op.h:55-73 -> GpuReplicaCache::PullCacheValue).

    On a CUDA cache this launches ``pull_rows_cuda``, on a CPU one it runs
    :func:`pull_cache_value_ref`; nothing else picks between them. The
    answer is ``jnp.take(cache, ids.astype(int32), axis=0)``'s: an id in
    [-R, 0) wraps, every other id outside [0, R) gives a NaN row. The ids
    are brought to that rule on their device, without a host sync."""
    rows = cache_row_ids(ids, cache.shape[0])
    if cache.is_cuda:
        out = pull_rows_cuda(cache, rows)
    elif cache.device.type == "cpu":
        out = pull_cache_value_ref(cache, rows)
    else:
        raise ValueError(f"no cache gather for a cache on {cache.device}")
    return out.reshape(*ids.shape, cache.shape[1])


class InputTable:
    """String-keyed side-input table with default row 0 on a miss."""

    DEFAULT_KEY = "-"

    def __init__(self, dim: int):
        self.dim = dim
        self._key_row = {}  # guarded-by: _lock
        self._rows: List[np.ndarray] = []  # guarded-by: _lock
        self._lock = threading.Lock()
        self._miss = 0  # guarded-by: _lock
        self.add_index_data(self.DEFAULT_KEY, np.zeros(dim, np.float32))

    def __len__(self) -> int:
        with self._lock:
            return len(self._key_row)

    @property
    def miss(self) -> int:
        with self._lock:
            return self._miss

    def add_index_data(self, key: str, vec) -> int:
        """Set ``key``'s row (AddIndexData parity); returns its row id. A
        key set again keeps its row id, and the last write wins."""
        row = np.asarray(vec, dtype=np.float32).reshape(-1)
        if row.shape[0] != self.dim:
            raise ValueError(f"row dim {row.shape[0]} != table dim {self.dim}")
        with self._lock:
            if key in self._key_row:
                rid = self._key_row[key]
                self._rows[rid] = row
                return rid
            rid = len(self._rows)
            self._key_row[key] = rid
            self._rows.append(row)
            return rid

    def get_index_offset(self, key: str) -> int:
        """Row id of ``key``; 0 (the default row) and miss + 1 when absent
        (GetIndexOffset parity). Called at parse or pack time, so only int
        ids reach the device."""
        with self._lock:
            rid = self._key_row.get(key)
            if rid is None:
                self._miss += 1
                return 0
            return rid

    def _host(self) -> np.ndarray:
        with self._lock:
            return np.stack(self._rows)

    def lookup_input(self, ids) -> np.ndarray:
        """Host gather of rows by id (LookupInput parity: the reference's
        is a host gather with device copies around it). Raises
        ``IndexError`` on an id outside [-n, n)."""
        return self._host()[np.asarray(ids, dtype=np.int64)]

    def to_device(self, plan=None, device: DeviceLike = "cuda") -> torch.Tensor:
        """The rows on ``device`` (or replicated over a mesh ``plan``) for
        in-step gathers through :func:`pull_cache_value`."""
        return _place(self._host(), plan, device)

    def mem_used_mb(self) -> float:
        with self._lock:
            return len(self._rows) * self.dim * 4 / 1024.0 / 1024.0
