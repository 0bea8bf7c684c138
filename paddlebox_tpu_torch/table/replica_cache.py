"""Full-replica row cache: the host part of ``ReplicaCache``.

Port of the JAX package's ``table/replica_cache.py`` host half
(GpuReplicaCache parity, box_wrapper.h:140-248): fixed-dim float rows
are appended one at a time (``add_items``, the replica-cache line
parser's ``#`` lines) or in blocks (``add_batch``); ``host_array``
materialises them as one ``[n, dim]`` array. The serving scoring table
builds its versions on it. The device replica (``to_device``), the
``pull_cache_value`` op and the string-keyed ``InputTable`` wait for a
later slice.
"""

from __future__ import annotations

import threading
from typing import List

import numpy as np

from paddlebox_tpu_torch.utils.monitor import STAT_GET, STAT_SET


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
