"""The per-batch step — eval mode (forward + metrics) of the train step.

Port of the JAX package's ``train/train_step.py`` eval path (SetTestMode,
box_wrapper.cc:623): per batch

    pull rows → take(inverse) → seqpool+CVM → model forward → AUC accumulate

with no sparse push and no dense update; table, params and opt_state return
as they came. Everything is static-shape: the host packer
(data/device_pack.py) prepared row ids / segment ids / padding. The
backward, the sparse push and the dense optimizer come with the training
slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from paddlebox_tpu_torch.metrics.auc import AucState, auc_update
from paddlebox_tpu_torch.ops.pull_push import pull_sparse_rows
from paddlebox_tpu_torch.ops.seqpool_cvm import fused_seqpool_cvm
from paddlebox_tpu_torch.table.optimizers import SparseOptimizerConfig
from paddlebox_tpu_torch.table.value_layout import ValueLayout


class TrainState(NamedTuple):
    table: torch.Tensor  # [rows, width] pass working-set
    params: Any  # dense model params (the model's state_dict)
    opt_state: Any  # dense optimizer state (unused in eval mode)
    auc: AucState
    step: torch.Tensor  # int32 scalar


@dataclass(frozen=True)
class TrainStepConfig:
    num_slots: int
    batch_size: int
    layout: ValueLayout
    sparse_opt: SparseOptimizerConfig = SparseOptimizerConfig()
    use_cvm: bool = True
    clk_filter: bool = False
    pull_scale: float = 1.0
    auc_buckets: int = 100_000
    axis_name: Optional[str] = None  # set on a mesh; None = single device
    slot_lr: Optional[tuple] = None  # per-slot lr multipliers, len num_slots
    model_takes_rank_offset: bool = False
    use_expand: bool = False
    # dense sync mode: "step" | "kstep" | "async" (BoxPSWorker sync_mode_)
    dense_sync_mode: str = "step"
    param_sync_step: int = 16  # K for "kstep"
    check_nan: bool = False
    # AdjustInsWeight parity: (nid_slot_index, threshold, ratio)
    adjust_ins_weight: Optional[tuple] = None

    def __post_init__(self):
        if self.adjust_ins_weight is not None:
            nid, thr, ratio = self.adjust_ins_weight
            if not (0 <= nid < self.num_slots) or thr <= 0 or ratio < 0:
                raise ValueError(
                    f"adjust_ins_weight=(nid_slot, threshold>0, ratio>=0), "
                    f"got {self.adjust_ins_weight!r} with {self.num_slots} slots"
                )
        if self.dense_sync_mode not in ("step", "kstep", "async"):
            raise ValueError(
                f"dense_sync_mode {self.dense_sync_mode!r} not in "
                "('step', 'kstep', 'async')"
            )
        if self.dense_sync_mode == "kstep" and self.param_sync_step < 1:
            raise ValueError("param_sync_step must be >= 1 for kstep")


def local_forward(
    model_apply: Callable,
    cfg: TrainStepConfig,
    params: Any,
    flat: torch.Tensor,  # [L, PW] pulled records per flat key
    segments: torch.Tensor,  # [L]
    labels: torch.Tensor,  # [b]
    dense: Optional[torch.Tensor],
):
    """Forward body: seqpool+CVM -> model -> BCE. Returns (loss, preds)."""
    slot_feats = fused_seqpool_cvm(
        flat,
        segments,
        num_slots=cfg.num_slots,
        batch_size=cfg.batch_size,
        use_cvm=cfg.use_cvm,
        clk_filter=cfg.clk_filter,
    )
    logits = model_apply(params, slot_feats, dense)
    loss = F.binary_cross_entropy_with_logits(logits, labels)
    return loss, torch.sigmoid(logits)


def make_train_step(
    model_apply: Callable, cfg: TrainStepConfig, eval_mode: bool = True
) -> Callable:
    """Build ``step(state, batch_dict) -> (state, metrics)``.

    ``model_apply(params, slot_feats, dense) -> logits``. ``batch_dict``
    fields are tensors on the table's device: uniq_rows [U], inverse [L],
    segments [L], labels [B], optional dense [B, Dd]. See
    data/device_pack.py. Only ``eval_mode=True`` exists so far: forward +
    AUC, with table/params/opt_state returned as they came.
    """
    if not eval_mode:
        raise NotImplementedError(
            "the training step (backward, sparse push, dense optimizer) "
            "is not ported yet; only eval_mode=True"
        )
    if cfg.use_expand or cfg.model_takes_rank_offset or cfg.axis_name is not None:
        raise NotImplementedError(
            "use_expand, model_takes_rank_offset and axis_name are not ported yet"
        )
    lay, opt = cfg.layout, cfg.sparse_opt

    @torch.no_grad()
    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        pulled_u = pull_sparse_rows(
            state.table, batch["uniq_rows"], lay, opt.embedx_threshold, cfg.pull_scale
        )  # [U, PW]
        flat = pulled_u.index_select(0, batch["inverse"].long())  # [L, PW]
        labels = batch["labels"]
        loss, preds = local_forward(
            model_apply, cfg, state.params, flat, batch["segments"], labels,
            batch.get("dense"),
        )
        new_auc = auc_update(state.auc, preds, labels)
        step_no = state.step + 1
        metrics = {"loss": loss, "step": step_no, "preds": preds, "labels": labels}
        return (
            TrainState(
                table=state.table,
                params=state.params,
                opt_state=state.opt_state,
                auc=new_auc,
                step=step_no,
            ),
            metrics,
        )

    return step
