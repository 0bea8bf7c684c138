"""Confirm/revert pass rollback (FleetWrapper::Confirm/Revert parity).

Port of the JAX package's ``train/rollback.py``. A pass mutates exactly

- the working set's keys in the host table (end_pass writeback; keys
  created by finalize get their initial rows from the store's seed, so
  restoring their pre-train rows makes a retrain reproducible), and
- the trainer's dense params and optimizer state.

``PassGuard.begin`` snapshots both right after ``begin_pass`` builds the
working set: the rows on the host, and a host copy of the trainer's
``params`` dict and optimizer state. ``revert`` pushes the rows back
(undoing any partial or complete writeback), restores the dense side onto
the trainer's device and drops the trainer's device-side caches;
``confirm`` drops the snapshot. end_pass's decay and shrink run after the
writeback, so the begin -> revert window covers everything a rejected
pass could have published.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np

from paddlebox_tpu_torch.train.dense_opt import tree_map


def _on(state: Any, device) -> Any:
    return tree_map(lambda t: t.to(device, copy=True), state)


class PassGuard:
    """Snapshot-at-begin / revert-or-confirm for one training pass."""

    def __init__(self, table, trainer: Optional[Any] = None):
        self.table = table
        self.trainer = trainer
        # the end-pass worker confirms; the main thread begins and reverts
        # only after joining that worker
        self._keys: Optional[np.ndarray] = None  # synchronized-by: end-pass join handoff (wait_end_pass)
        self._vals: Optional[np.ndarray] = None  # synchronized-by: end-pass join handoff (wait_end_pass)
        # (params, optimizer state) on the host
        self._dense: Optional[tuple] = None  # synchronized-by: end-pass join handoff (wait_end_pass)

    @property
    def armed(self) -> bool:
        return self._keys is not None

    def begin(self, pass_keys: np.ndarray) -> None:
        """Snapshot the pre-train rows of this pass's keys (call right after
        the working set is finalized) and the trainer's dense state."""
        self._keys = np.asarray(pass_keys, dtype=np.uint64).copy()
        self._vals = self.table.pull_or_create(self._keys).copy()
        tr = self.trainer
        if tr is not None and tr.params is not None:
            self._dense = (
                {k: v.to("cpu", copy=True) for k, v in tr.params.items()},
                _on(tr.opt_state, "cpu"),
            )

    def confirm(self) -> None:
        """Accept the pass: drop the snapshot (Confirm parity)."""
        self._keys = self._vals = self._dense = None

    def revert(self) -> None:
        """Restore every pass key's pre-pass row and the dense state
        (Revert parity). Safe after zero, partial, or full writeback."""
        if self._keys is None:
            raise RuntimeError("no armed snapshot — begin() a pass first")
        if len(self._keys):
            self.table.push(self._keys, self._vals)
        tr = self.trainer
        if self._dense is not None and tr is not None:
            params, opt_state = self._dense
            tr.params = {k: v.to(tr.device, copy=True) for k, v in params.items()}
            tr.opt_state = _on(opt_state, tr.device)
            tr.drop_device_state()  # the pass state on the device is stale now
        self.confirm()
