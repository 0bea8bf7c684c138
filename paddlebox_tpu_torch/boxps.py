"""BoxWrapper façade: the reference's singleton surface in one object.

Port of the JAX package's ``boxps.py``. For users of the reference,
``core.BoxWrapper`` is the center of the world (box_wrapper.h:362-774,
box_helper_py.cc:40-140): the sparse model, the pass and phase machinery,
the metric registry and model publishing. The port keeps those in
``table``, ``metrics``, ``data`` and ``train``; this façade puts them
back behind the familiar names:

    box = BoxWrapper(embedx_dim=16, device="cuda")     # SetInstance
    ds = box.make_dataset(schema, batch_size=4096)     # BoxPSDataset
    box.init_metric("join_auc", phase=1)               # init_metric
    trainer = CTRTrainer(model, cfg, box=box, metric_registry=box.metrics)
    ... ds.begin_pass() / trainer.train_pass(ds) / ds.end_pass(...) ...
    box.set_test_mode()                                # the next pass evaluates
    box.save_base("ckpt", date)                        # SaveBase
    box.get_metric_msg("join_auc")

Everything delegates; no behaviour lives here.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

from paddlebox_tpu_torch.metrics.registry import MetricRegistry
from paddlebox_tpu_torch.table.optimizers import SparseOptimizerConfig
from paddlebox_tpu_torch.table.sparse_table import HostSparseTable
from paddlebox_tpu_torch.table.value_layout import FeatureType, ValueLayout
from paddlebox_tpu_torch.train.checkpoint import CheckpointManager
from paddlebox_tpu_torch.utils.device import DeviceLike


class BoxWrapper:
    """One process's sparse model, phases, metrics and publishing."""

    def __init__(
        self,
        embedx_dim: int = 8,
        expand_embed_dim: int = 0,
        feature_type: FeatureType = FeatureType.PLAIN,
        pull_embedx_scale: float = 1.0,
        sparse_opt: Optional[SparseOptimizerConfig] = None,
        n_host_shards: int = 64,
        seed: int = 0,
        device: DeviceLike = "cuda",
    ):
        """``device`` is the metric registry's (default "cuda"; raises on a
        host without a GPU unless "cpu")."""
        self.layout = ValueLayout(
            embedx_dim=embedx_dim, expand_embed_dim=expand_embed_dim, feature_type=feature_type
        )
        self.pull_embedx_scale = pull_embedx_scale
        self.sparse_opt = sparse_opt or SparseOptimizerConfig()
        self.table = HostSparseTable(self.layout, self.sparse_opt, n_shards=n_host_shards, seed=seed)
        self.metrics = MetricRegistry(device=device)
        # the two-phase join/update machinery (box_wrapper.h:620-622)
        self.phase = 1
        self.phase_num = 2
        self.test_mode = False
        self._ckpt: Optional[CheckpointManager] = None

    # ---- phase machinery -------------------------------------------------

    def flip_phase(self) -> int:
        """FlipPhase: 1 (join) <-> 0 (update)."""
        self.phase ^= 1
        return self.phase

    def set_test_mode(self, on: bool = True) -> None:
        """SetTestMode (box_wrapper.cc:623): a ``CTRTrainer`` built with
        ``box=`` this wrapper runs its next train_pass calls as forward and
        metrics only (no sparse push, no dense update) until cleared."""
        self.test_mode = on

    # ---- dataset ---------------------------------------------------------

    def make_dataset(self, schema, batch_size: int, **kw):
        """A ``BoxPSDataset`` bound to this wrapper's table."""
        from paddlebox_tpu_torch.data.dataset import BoxPSDataset

        return BoxPSDataset(schema, self.table, batch_size=batch_size, **kw)

    # ---- metrics (init_metric / get_metric_msg, box_helper_py.cc:87-97) ----

    def init_metric(self, name: str, **kw) -> None:
        self.metrics.init_metric(name=name, **kw)

    def get_metric_msg(self, name: str) -> str:
        return self.metrics.get_metric_msg(name)

    def get_metric(self, name: str) -> Dict[str, float]:
        return self.metrics.get_metric(name)

    # ---- model publishing (SaveBase / SaveDelta / load) --------------------

    def checkpoint_manager(self, root: str) -> CheckpointManager:
        if self._ckpt is None or self._ckpt.root != root:
            self._ckpt = CheckpointManager(root)
        return self._ckpt

    def save_base(self, root: str, date: str, trainer=None) -> str:
        return self.checkpoint_manager(root).save_base(date, self.table, trainer)

    def save_delta(self, root: str, date: str, trainer=None) -> str:
        return self.checkpoint_manager(root).save_delta(date, self.table, trainer)

    def load_model(self, root: str, trainer=None):
        """Day-level resume: the newest base and its deltas into the table,
        the dense state into ``trainer``."""
        return self.checkpoint_manager(root).resume(self.table, trainer)

    def save_cache_model(self, root: str, date: str, cache_rate: float = 0.1) -> int:
        """The hot-key serving cache (save_cache_model, pslib
        __init__.py:386-425): the show threshold that admits ``cache_rate``
        of the keys, those keys written under <date>/cache/; returns their
        count. Call between passes: a push between the threshold scan and
        the save shifts the cut."""
        thr = self.table.cache_threshold(cache_rate)
        return self.table.save_cache(os.path.join(root, date, "cache"), thr)

    def save_model_with_whitelist(self, root: str, date: str, whitelist) -> int:
        """A snapshot of the whitelisted keys (save_model_with_whitelist,
        pslib __init__.py:351-384) under <date>/whitelist/."""
        return self.table.save_with_whitelist(os.path.join(root, date, "whitelist"), whitelist)
