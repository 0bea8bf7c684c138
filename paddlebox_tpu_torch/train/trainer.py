"""Pass-loop trainer: the BoxPSTrainer/BoxPSWorker analog on one device.

Port of the JAX package's ``train/trainer.py``, its classic path: one
``CTRTrainer`` owns the training step and walks a ``BoxPSDataset`` pass by
pass, building, packing and copying each batch on the host, then stepping
on the device:

    trainer = CTRTrainer(model, cfg, device="cuda")
    dataset.load_into_memory(); dataset.begin_pass()
    metrics = trainer.train_pass(dataset)
    dataset.end_pass(trainer.trained_table())

Dense params and the optimizer state persist across passes on the device;
the sparse working-set table is rebuilt per pass.

Not ported: meshes, the resident superstep, the columnar fast feed, the
pv/join phase, async dense, dumps, eval mode and checkpoints.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch.func import functional_call

from paddlebox_tpu_torch.data.dataset import BoxPSDataset
from paddlebox_tpu_torch.data.device_pack import pack_batch
from paddlebox_tpu_torch.metrics.auc import AucState, auc_compute, auc_init
from paddlebox_tpu_torch.train.dense_opt import Adam, AdamState
from paddlebox_tpu_torch.train.train_step import TrainState, TrainStepConfig, make_train_step
from paddlebox_tpu_torch.utils.device import DeviceLike, resolve_device

# cap on dispatched-but-unfinished steps: deep enough to hide the host's
# next batch behind the device step, shallow enough that work cannot pile up
MAX_INFLIGHT_STEPS = 4

_PROFILE_KEYS = ("build_batch_s", "pack_batch_s", "h2d_s", "step_s", "host_metrics_s")


def _clone_opt_state(st: AdamState) -> AdamState:
    return AdamState(
        count=st.count.clone(),
        mu={k: v.clone() for k, v in st.mu.items()},
        nu={k: v.clone() for k, v in st.nu.items()},
    )


class CTRTrainer:
    def __init__(
        self,
        model: torch.nn.Module,
        cfg: TrainStepConfig,
        dense_opt: Optional[Adam] = None,
        device: DeviceLike = "cuda",
    ):
        """``model(slot_feats, dense) -> logits`` (e.g. ``models.DeepFM``)
        moves to ``device``; its current weights are the initial params.
        ``dense_opt`` defaults to ``Adam(1e-3)``. ``device`` defaults to
        "cuda" and raises on a host without a GPU."""
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.cfg = cfg
        self.dense_opt = dense_opt or Adam(1e-3)
        self.params: Optional[Dict[str, torch.Tensor]] = None
        self.opt_state: Optional[AdamState] = None
        self._state: Optional[TrainState] = None
        self._state_ws = None

        def model_apply(params, slot_feats, dense):
            return functional_call(self.model, params, (slot_feats, dense))

        self._step = make_train_step(model_apply, cfg, self.dense_opt)

    # ---- dense param lifecycle ------------------------------------------

    def init_params(self) -> None:
        """Params from the model's current weights; a fresh optimizer state."""
        self.params = {
            k: v.detach().clone().to(self.device) for k, v in self.model.state_dict().items()
        }
        self.opt_state = self.dense_opt.init(self.params)

    # ---- pass loop -------------------------------------------------------

    def _make_state(self, dev_table: np.ndarray, ws_key=None) -> TrainState:
        # later train_pass calls within one pass (same working set) must see
        # the rows the earlier calls trained: rebuild only when it changes
        if self._state is not None and ws_key is not None and self._state_ws is ws_key:
            return self._state
        self._state_ws = ws_key
        if self.params is None:
            self.init_params()
        # the step updates the table in place: copy, so the dataset's host
        # array stays the pass-open table. Params and optimizer state are
        # copies too, so a failed pass leaves self.params as they were.
        table = torch.from_numpy(dev_table.reshape(-1, dev_table.shape[-1]))
        return TrainState(
            table=table.to(self.device, copy=True),
            params={k: v.clone() for k, v in self.params.items()},
            opt_state=_clone_opt_state(self.opt_state),
            auc=auc_init(self.cfg.auc_buckets, device=self.device),
            step=torch.zeros((), dtype=torch.int32, device=self.device),
        )

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _slow_feed_iter(self, dataset: BoxPSDataset, n_batches, prof):
        """Build, pack and copy each batch on the host. With ``prof`` each
        stage's host seconds accumulate there (the copy synchronised)."""
        it = iter(dataset.batches(n_batches))
        while True:
            t0 = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                return
            t1 = time.perf_counter()
            db = pack_batch(batch, dataset.ws, dataset.schema)
            t2 = time.perf_counter()
            feed = {k: torch.from_numpy(v).to(self.device) for k, v in db.as_dict().items()}
            if prof is not None:
                self._sync()
                prof["build_batch_s"] += t1 - t0
                prof["pack_batch_s"] += t2 - t1
                prof["h2d_s"] += time.perf_counter() - t2
            yield feed

    def _classic_stepper(self, iterator, holder, prof):
        """Per-batch dispatch over the host-packed feed. Yields (i, metrics).

        At most ``MAX_INFLIGHT_STEPS`` steps are in flight: past that the
        oldest step's loss is read back, which waits for its step. With
        ``prof`` every step waits for its loss."""
        inflight: deque = deque()
        for i, feed in enumerate(iterator):
            t0 = time.perf_counter()
            holder["state"], m = self._step(holder["state"], feed)
            if prof is not None:
                float(m["loss"])
                prof["step_s"] += time.perf_counter() - t0
            else:
                inflight.append(m["loss"])
                if len(inflight) > MAX_INFLIGHT_STEPS:
                    float(inflight.popleft())
            yield i, m

    def train_pass(
        self,
        dataset: BoxPSDataset,
        n_batches: Optional[int] = None,
        on_batch: Optional[Callable[[int, Dict], None]] = None,
        profile: bool = False,
    ) -> Dict[str, float]:
        """Train every minibatch of the current pass; returns pass metrics.

        Call between ``dataset.begin_pass()`` and ``dataset.end_pass(...)``.
        ``profile=True`` adds ``out["profile"]``: host seconds in
        build_batch, pack_batch, the host->device copy, the step up to its
        loss read-back, and the host-side metrics — every stage waits for
        the device, so nothing overlaps."""
        if dataset.device_table is None:
            raise RuntimeError("dataset.begin_pass() first")
        state = self._make_state(dataset.device_table, ws_key=dataset.ws)
        prof = dict.fromkeys(_PROFILE_KEYS, 0.0) if profile else None
        # AUC buckets accumulate across train_pass calls within one pass:
        # this call reports the delta
        auc0 = AucState(pos=state.auc.pos.cpu().clone(), neg=state.auc.neg.cpu().clone())
        losses = []
        skip_flags = []
        holder = {"state": state}
        stepper = self._classic_stepper(
            self._slow_feed_iter(dataset, n_batches, prof), holder, prof
        )
        try:
            for i, m in stepper:
                t0 = time.perf_counter()
                if "nan_skipped" in m:
                    skip_flags.append(m["nan_skipped"])
                if on_batch is not None:
                    on_batch(i, m)
                losses.append(m["loss"])
                if prof is not None:
                    prof["host_metrics_s"] += time.perf_counter() - t0
        except BaseException:
            # the table was updated in place up to the failing step; keep
            # the last returned state so a retry sees what was trained
            self._state = holder["state"]
            raise
        state = holder["state"]
        self.params = state.params
        self.opt_state = state.opt_state
        self._state = state

        cum = AucState(pos=state.auc.pos.cpu(), neg=state.auc.neg.cpu())
        out = auc_compute(AucState(pos=cum.pos - auc0.pos, neg=cum.neg - auc0.neg))
        cum_out = auc_compute(cum)
        out["auc_cumulative"] = cum_out["auc"]
        out["saturated"] = cum_out["saturated"]
        if losses and skip_flags:
            lv = torch.stack(losses).cpu()
            bad = torch.stack(skip_flags).cpu() > 0
            kept = max(int((~bad).sum()), 1)
            out["loss"] = float(torch.where(bad, 0.0, lv).sum()) / kept
            out["nan_batches"] = float(bad.sum())
        else:
            out["loss"] = float(torch.stack(losses).mean()) if losses else float("nan")
            out["nan_batches"] = 0.0
        out["batches"] = float(len(losses))
        if prof is not None:
            out["profile"] = prof
        return out

    def trained_table(self) -> np.ndarray:
        """The pass's trained table on the host, [rows, width], for
        ``dataset.end_pass``."""
        if self._state is None:
            raise RuntimeError("no trained pass")
        return self._state.table.to("cpu", copy=True).numpy()
