"""Named metric registry with phase / cmatch / rank / mask filtering.

Port of the JAX package's ``metrics/registry.py`` (the reference's
MetricMsg hierarchy, box_wrapper.h:281-361; InitMetric/GetMetricMsg
dispatch, box_wrapper.cc:1111-1172; the pybind surface,
box_helper_py.cc:87-97):

- ``MetricMsg``               label/pred AUC metric with a phase filter
  (workers feed only the metrics of the current join/update phase,
  boxps_worker.cc:413)
- ``CmatchRankMetricMsg``     filters on (cmatch, rank) pairs;
  ``ignore_rank`` makes it cmatch-only
- ``MultiTaskMetricMsg``      the cmatch-group filter (rank-blind)
- ``MaskMetricMsg``           counts samples where an output mask var != 0
- ``CmatchRankMaskMetricMsg`` both filters

Every metric owns an ``AucState`` (``metrics/auc.py``) on an explicit
device. ``add_data`` builds the sample mask with tensor ops on that device
and adds the batch with one integer scatter: nothing is read back to the
host, and numpy inputs are copied to the device first.
``get_metric_msg`` computes the stat block on the host and resets, the
reference's compute-and-reset contract.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import torch

from paddlebox_tpu_torch import config
from paddlebox_tpu_torch.metrics.auc import AucState, auc_compute, auc_init, auc_update
from paddlebox_tpu_torch.utils.device import DeviceLike, resolve_device

_METHODS = ("auc", "multi_task_auc", "cmatch_rank_auc", "mask_auc")


def parse_cmatch_rank_group(group: str) -> List[Tuple[int, int]]:
    """Parse "401:0,401:1" (or "401_0" / bare "401") into (cmatch, rank)
    pairs; bare cmatch entries get rank -1 = any."""
    pairs: List[Tuple[int, int]] = []
    for item in group.split(","):
        item = item.strip()
        if not item:
            continue
        for sep in (":", "_"):
            if sep in item:
                c, r = item.split(sep, 1)
                pairs.append((int(c), int(r)))
                break
        else:
            pairs.append((int(item), -1))
    return pairs


class MetricMsg:
    """Base metric: label/pred AUC with phase filtering."""

    method = "auc"

    def __init__(
        self,
        name: str,
        label_var: str = "labels",
        pred_var: str = "preds",
        phase: int = -1,
        bucket_size: Optional[int] = None,
        device: DeviceLike = "cuda",
    ):
        self.name = name
        self.label_var = label_var
        self.pred_var = pred_var
        self.phase = phase  # -1 = every phase
        self.bucket_size = bucket_size or config.get_flag("auc_num_buckets")
        self.device = resolve_device(device)
        self.state: AucState = auc_init(self.bucket_size, device=self.device)
        # serializes the read-modify-write on state for concurrent feeders
        self._state_lock = threading.Lock()

    def _var(self, outputs: Dict, name: str) -> torch.Tensor:
        try:
            x = outputs[name]
        except KeyError:
            raise KeyError(
                f"metric {self.name!r} needs output var {name!r} but the batch does "
                "not carry it: cmatch/rank need logkey parsing on the schema "
                "(parse_logkey), mask vars must be returned by the step"
            ) from None
        return torch.as_tensor(x, device=self.device).reshape(-1)

    # -- filtering ---------------------------------------------------------

    def metric_phase(self) -> int:
        return self.phase

    def sample_mask(self, outputs: Dict) -> Optional[torch.Tensor]:
        """None = count everything. Subclasses narrow it."""
        return None

    # -- accumulation ------------------------------------------------------

    def add_data(self, outputs: Dict, phase: int = -1) -> bool:
        """Accumulate one batch if the phase matches; returns whether it
        counted. ``outputs`` maps var names to tensors or numpy arrays;
        each flattens to [N]."""
        if self.phase >= 0 and phase >= 0 and phase != self.phase:
            return False
        preds = self._var(outputs, self.pred_var)
        labels = self._var(outputs, self.label_var).to(torch.float32)
        mask = self.sample_mask(outputs)
        if mask is None:
            mask = torch.ones(preds.shape, dtype=torch.int32, device=self.device)
        if "ins_weight" in outputs:
            # ghost-padded instances (pv join batches) never count
            mask = mask * (self._var(outputs, "ins_weight") > 0).to(torch.int32)
        with self._state_lock:
            self.state = auc_update(self.state, preds, labels, mask)
        return True

    # -- readout -----------------------------------------------------------

    def get_metric(self) -> Dict[str, float]:
        """Compute the stat block and reset (GetMetricMsg contract)."""
        with self._state_lock:
            state, self.state = self.state, auc_init(self.bucket_size, device=self.device)
        return auc_compute(state)

    def get_metric_msg(self) -> str:
        """The reference's log line format (box_wrapper.cc:1141-1160)."""
        m = self.get_metric()
        return (
            f"{self.name}: AUC={m['auc']:.6f} BUCKET_ERROR={m['bucket_error']:.6f} "
            f"MAE={m['mae']:.6f} RMSE={m['rmse']:.6f} "
            f"Actual CTR={m['actual_ctr']:.6f} Predicted CTR={m['predicted_ctr']:.6f} "
            f"COPC={m['copc']:.6f} INS_NUM={m['ins_num']:.0f}"
        )

    def reset(self) -> None:
        with self._state_lock:
            self.state = auc_init(self.bucket_size, device=self.device)


class MaskMetricMsg(MetricMsg):
    """Counts samples where ``mask_var`` != 0 (box_wrapper.h mask variant)."""

    def __init__(self, name: str, mask_var: str, **kw):
        super().__init__(name, **kw)
        if not mask_var:
            raise ValueError(f"metric {name!r}: mask_auc needs a mask_var")
        self.mask_var = mask_var

    def sample_mask(self, outputs):
        return (self._var(outputs, self.mask_var) != 0).to(torch.int32)


class CmatchRankMetricMsg(MetricMsg):
    """Counts samples matching any (cmatch, rank) pair; ``ignore_rank``
    matches on cmatch alone (CmatchRankMetricMsg parity)."""

    def __init__(
        self,
        name: str,
        cmatch_rank_group: str,
        ignore_rank: bool = False,
        cmatch_var: str = "cmatch",
        rank_var: str = "rank",
        **kw,
    ):
        super().__init__(name, **kw)
        self.cmatch_var = cmatch_var
        self.rank_var = rank_var
        self.ignore_rank = ignore_rank
        self.pairs = parse_cmatch_rank_group(cmatch_rank_group)
        if not self.pairs:
            raise ValueError(f"empty cmatch_rank group for metric {name!r}")
        # the pairs on the device once: add_data stays device work
        self._cs = torch.tensor([c for c, _ in self.pairs], device=self.device)
        self._rs = torch.tensor([r for _, r in self.pairs], device=self.device)

    def sample_mask(self, outputs):
        cmatch = self._var(outputs, self.cmatch_var)
        hit = cmatch[:, None] == self._cs[None, :]
        if not self.ignore_rank:
            rank = self._var(outputs, self.rank_var)
            hit = hit & ((rank[:, None] == self._rs[None, :]) | (self._rs[None, :] < 0))
        return torch.any(hit, dim=1).to(torch.int32)


class MultiTaskMetricMsg(CmatchRankMetricMsg):
    """cmatch-group filter: the reference's MultiTaskMetricMsg is exactly the
    rank-blind cmatch membership test."""

    def __init__(self, name: str, cmatch_group: str, cmatch_var: str = "cmatch", **kw):
        super().__init__(name, cmatch_group, ignore_rank=True, cmatch_var=cmatch_var, **kw)


class CmatchRankMaskMetricMsg(CmatchRankMetricMsg):
    """(cmatch, rank) filter AND an output mask var (the reference's
    combined variant)."""

    def __init__(self, name: str, cmatch_rank_group: str, mask_var: str, **kw):
        super().__init__(name, cmatch_rank_group, **kw)
        if not mask_var:
            raise ValueError(f"metric {name!r}: combined variant needs a mask_var")
        self.mask_var = mask_var

    def sample_mask(self, outputs):
        return super().sample_mask(outputs) * (self._var(outputs, self.mask_var) != 0).to(torch.int32)


class MetricRegistry:
    """Name-keyed metric table (BoxWrapper metric_name_list_ parity).

    ``init_metric`` mirrors the pybind surface (box_helper_py.cc:87-97):
    ``method`` selects the variant, empty group/mask strings the base.
    Every metric's state lives on ``device`` (default "cuda", which raises
    on a host without a GPU)."""

    def __init__(self, device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        self._metrics: Dict[str, MetricMsg] = {}
        self._lock = threading.Lock()

    def init_metric(
        self,
        name: str,
        method: str = "auc",
        label_var: str = "labels",
        pred_var: str = "preds",
        cmatch_rank_var: str = "cmatch",
        mask_var: str = "",
        phase: int = -1,
        cmatch_rank_group: str = "",
        ignore_rank: bool = False,
        bucket_size: Optional[int] = None,
    ) -> MetricMsg:
        if method not in _METHODS:
            raise ValueError(f"unknown metric method {method!r}")
        kw = dict(
            label_var=label_var, pred_var=pred_var, phase=phase, bucket_size=bucket_size,
            device=self.device,
        )
        m: MetricMsg
        if method == "multi_task_auc":
            m = MultiTaskMetricMsg(name, cmatch_rank_group, cmatch_var=cmatch_rank_var, **kw)
        elif cmatch_rank_group and mask_var:
            m = CmatchRankMaskMetricMsg(
                name, cmatch_rank_group, mask_var, ignore_rank=ignore_rank,
                cmatch_var=cmatch_rank_var, **kw,
            )
        elif method == "cmatch_rank_auc" or cmatch_rank_group:
            m = CmatchRankMetricMsg(
                name, cmatch_rank_group, ignore_rank=ignore_rank, cmatch_var=cmatch_rank_var, **kw
            )
        elif method == "mask_auc" or mask_var:
            m = MaskMetricMsg(name, mask_var, **kw)
        else:
            m = MetricMsg(name, **kw)
        with self._lock:
            self._metrics[name] = m
        return m

    def names(self) -> List[str]:
        with self._lock:
            return list(self._metrics)

    def __getitem__(self, name: str) -> MetricMsg:
        with self._lock:
            return self._metrics[name]

    def add_all(self, outputs: Dict, phase: int = -1) -> int:
        """Feed one batch's outputs to every phase-matching metric
        (AddAucMonitor parity, boxps_worker.cc:408-418). Returns how many
        metrics counted the batch."""
        with self._lock:
            metrics = list(self._metrics.values())
        return sum(1 for m in metrics if m.add_data(outputs, phase))

    def get_metric_msg(self, name: str) -> str:
        return self[name].get_metric_msg()

    def get_metric(self, name: str) -> Dict[str, float]:
        return self[name].get_metric()
