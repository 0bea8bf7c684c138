"""Async dense table: a host-side background dense optimizer.

Port of the JAX package's ``train/async_dense.py`` (BoxPSAsynDenseTable,
boxps_worker.cc:35-237). The step under ``dense_sync_mode="async"``
leaves params and the optimizer state as they are and returns its dense
gradients; the trainer *pulls* the current params before every batch and
*pushes* the batch's gradients after it. A background thread drains the
bounded queue, merges up to ``merge_limit`` packages (their mean) and
applies the reference's fixed Adam-like rule

    mom1 = 0.99 * mom1 + 0.01 * g
    mom2 = 0.9999 * mom2 + 0.0001 * g*g
    p   -= lr * mom1 / (sqrt(mom2) + 1e-8)

with a per-parameter lr from ``lr_map`` (GetLRMap, box_wrapper.cc:
1234-1241). The arithmetic is numpy fp32, as in the JAX package, so one
sequence of pushed gradients gives the same bits in both (a Linear's
weight is the transpose of the JAX leaf; every operation is elementwise).

The tree is the port's params dict (name -> tensor or array). An
``lr_map`` key matches a param exactly, else as a path suffix, by its
port name (``mlp.0.weight``, suffix ``0.weight``) or by its JAX path
(``mlp/0/w``, suffix ``0/w``), so one map means the same in both
packages; an exact match beats any suffix, and the first suffix in the
map's order wins.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, List, Optional

import numpy as np

from paddlebox_tpu_torch.models.convert import jax_path


def _host(x: Any) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


class AsyncDenseTable:
    """Background-thread dense optimizer with the pull/push worker API."""

    def __init__(
        self,
        params: Dict[str, Any],  # name -> initial value (tensor or array)
        base_lr: float,
        lr_map: Optional[Dict[str, float]] = None,  # name or JAX path -> lr
        merge_limit: int = 4,
        queue_cap: int = 24,  # PSBufferQueue(8 * 3)
    ):
        self._names = list(params)
        self._params = [np.array(_host(params[k]), dtype=np.float32) for k in self._names]  # guarded-by: _lock
        self._mom1 = [np.zeros_like(x) for x in self._params]  # guarded-by: _lock
        self._mom2 = [np.zeros_like(x) for x in self._params]  # guarded-by: _lock
        self.base_lr = float(base_lr)
        self.merge_limit = merge_limit

        def leaf_lr(name: str) -> float:
            m = lr_map or {}
            path = jax_path(name)
            for k in (name, path):
                if k in m:  # exact beats any suffix entry
                    return m[k]
            for k, v in m.items():
                if name.endswith("." + k) or path.endswith("/" + k):
                    return v
            return self.base_lr

        self._leaf_lr = np.array([leaf_lr(n) for n in self._names], dtype=np.float32)
        self._lock = threading.Lock()  # guards _params, _mom*, _n_updates
        self._applied = threading.Condition(self._lock)  # notified after each update
        self._queue: "queue.Queue" = queue.Queue(maxsize=queue_cap)
        self._n_updates = 0  # guarded-by: _lock
        self._closed = False
        self._thread = threading.Thread(target=self._update_loop, daemon=True)
        self._thread.start()

    # ---- worker API ------------------------------------------------------

    def pull_dense(self) -> Dict[str, np.ndarray]:
        """The current params (PullDense), copies taken under the lock."""
        with self._lock:
            leaves = [x.copy() for x in self._params]
        return dict(zip(self._names, leaves))

    def push_dense(self, gparams: Dict[str, Any]) -> None:
        """Enqueue one step's dense gradients (PushDense). A gradient on the
        card is copied to the host first. Blocks only while the queue is
        full."""
        if self._closed:
            raise RuntimeError("table finalized")
        self._queue.put([_host(gparams[k]) for k in self._names])

    @property
    def n_updates(self) -> int:
        # the lock orders this read after a concurrent _apply: a caller that
        # saw n_updates == k reads params at least that fresh
        with self._lock:
            return self._n_updates

    def wait_for_updates(self, n: int, timeout: Optional[float] = None) -> bool:
        """Block until at least ``n`` updates have been applied (False if
        ``timeout`` seconds pass first). With ``merge_limit=1`` and a wait
        for ``i + 1`` after the ``i``-th push, every batch trains on the
        params of every earlier batch: a deterministic drive."""
        with self._applied:
            return self._applied.wait_for(lambda: self._n_updates >= n, timeout)

    # ---- background optimizer -------------------------------------------

    def _update_loop(self) -> None:
        while True:
            try:
                first = self._queue.get(timeout=0.05)
            except queue.Empty:
                if self._closed:
                    return
                continue
            if first is None:  # close sentinel
                return
            batch = [first]
            # merge up to merge_limit - 1 more waiting packages (AsyncUpdate
            # merge_num = min(queue size + 1, 4))
            while len(batch) < self.merge_limit:
                try:
                    nxt = self._queue.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:
                    self._apply(batch)
                    return
                batch.append(nxt)
            self._apply(batch)

    def _apply(self, batch: List[List[np.ndarray]]) -> None:
        inv = 1.0 / len(batch)
        with self._lock:
            for i in range(len(self._params)):
                g = batch[0][i]
                for other in batch[1:]:
                    g = g + other[i]
                if len(batch) > 1:
                    g = g * inv
                m1, m2 = self._mom1[i], self._mom2[i]
                m1 *= 0.99
                m1 += 0.01 * g
                m2 *= 0.9999
                m2 += 0.0001 * g * g
                self._params[i] -= self._leaf_lr[i] * m1 / (np.sqrt(m2) + 1e-8)
            self._n_updates += 1
            self._applied.notify_all()

    # ---- lifecycle -------------------------------------------------------

    def finalize(self) -> Dict[str, np.ndarray]:
        """Drain the queue, stop the thread, return the final params
        (Finalize copies ps_ back to the root scope)."""
        if not self._closed:
            self._closed = True
            self._queue.put(None)
            self._thread.join()
            # anything that raced in behind the sentinel
            leftovers = []
            while True:
                try:
                    item = self._queue.get_nowait()
                except queue.Empty:
                    break
                if item is not None:
                    leftovers.append(item)
            for item in leftovers:
                self._apply([item])
        return self.pull_dense()
