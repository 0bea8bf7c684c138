"""The per-batch step: the whole pipeline of one batch on one device.

Port of the JAX package's ``train/train_step.py`` (BoxPSWorker::TrainFiles
boxps_worker.cc:420-466: pull_box_sparse -> fused_seqpool_cvm -> dense ops
-> push_box_sparse -> dense sync -> AUC):

    pull rows -> take(inverse) -> seqpool+CVM -> model fwd/bwd ->
    sparse AdaGrad push -> dense optimizer -> AUC accumulate

The eval path (SetTestMode, box_wrapper.cc:623) runs forward + metrics and
returns table, params and opt_state as they came. Everything is
static-shape: the host packer (data/device_pack.py) prepared row ids,
segment ids and padding.

Every reduction on the training path has a fixed order, so a step gives
the same bits on every run on the card: the per-row gradient merge is a
stable sort by row then a lengths-based ``segment_reduce``, the seqpool is
one too, the no-dedup push is a sorted ``index_put_(accumulate=True)``, and
the gradient with respect to the pulled records is taken at ``flat`` (a
leaf), so the ``index_select`` by ``inverse`` never runs backward through
float atomics. The push writes ``state.table`` in place where the JAX
package donates it; params and the optimizer state are replaced, not
mutated.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from paddlebox_tpu_torch.metrics.auc import AucState, auc_update
from paddlebox_tpu_torch.ops.pull_push import (
    pull_sparse_rows,
    pull_sparse_rows_extended,
    push_sparse_rows,
)
from paddlebox_tpu_torch.ops.seqpool_cvm import fused_seqpool_cvm, segment_sum, sum_pool
from paddlebox_tpu_torch.table.optimizers import SparseOptimizerConfig
from paddlebox_tpu_torch.table.value_layout import ValueLayout
from paddlebox_tpu_torch.train.dense_opt import Adam, tree_map
from paddlebox_tpu_torch.utils.trace import span_with_backward


class TrainState(NamedTuple):
    table: torch.Tensor  # [rows, width] pass working-set (a mesh rank's shard)
    params: Any  # dense model params (the model's state_dict)
    opt_state: Any  # dense optimizer state (train/dense_opt: AdamState, MultiStepsState)
    auc: AucState
    step: torch.Tensor  # int32 scalar
    # steps dispatched, counted on the host: the mesh's kstep cadence,
    # which must not read ``step`` back from the card
    host_step: int = 0


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
    ins_weight: Optional[torch.Tensor] = None,  # [b] per-instance loss weight
    loss_denom: Optional[torch.Tensor] = None,  # weighted-loss denominator
    rank_offset: Optional[torch.Tensor] = None,  # [b, 2R+1] join-phase pv matrix
):
    """Forward body: seqpool+CVM -> model -> BCE. Returns (loss, preds).
    The seqpool runs under the span ``seqpool``, its backward under
    ``seqpool.bwd``.

    With ``ins_weight`` the loss is the weighted sum over ``loss_denom``
    (default: the weight sum, at least 1), else the mean. With
    ``cfg.model_takes_rank_offset`` the model is called as
    ``model_apply(params, slot_feats, dense, rank_offset)``. With
    ``cfg.use_expand`` the trailing ``expand_dim`` columns of ``flat`` are
    the expand embeddings: they are sum-pooled by (slot, instance), the pad
    segments dropped, and reach the model as its last positional argument,
    [b, S, E]."""
    extra = (rank_offset,) if cfg.model_takes_rank_offset else ()
    if cfg.use_expand:
        E = cfg.layout.expand_dim
        pooled = sum_pool(flat[:, -E:], segments, cfg.num_slots, cfg.batch_size)  # [S, b, E]
        extra = extra + (pooled.permute(1, 0, 2),)
        flat = flat[:, :-E]
    slot_feats = span_with_backward(
        "seqpool",
        lambda records: fused_seqpool_cvm(
            records,
            segments,
            num_slots=cfg.num_slots,
            batch_size=cfg.batch_size,
            use_cvm=cfg.use_cvm,
            clk_filter=cfg.clk_filter,
        ),
        flat,
    )
    logits = model_apply(params, slot_feats, dense, *extra)
    if ins_weight is None:
        loss = F.binary_cross_entropy_with_logits(logits, labels)
    else:
        loss_vec = F.binary_cross_entropy_with_logits(logits, labels, reduction="none")
        denom = loss_denom if loss_denom is not None else torch.clamp(ins_weight.sum(), min=1.0)
        loss = torch.sum(loss_vec * ins_weight) / denom
    return loss, torch.sigmoid(logits)


def local_forward_backward(
    model_apply: Callable,
    cfg: TrainStepConfig,
    params: Dict[str, torch.Tensor],
    flat: torch.Tensor,  # [L, PW] pulled records per flat key
    segments: torch.Tensor,
    labels: torch.Tensor,
    dense: Optional[torch.Tensor],
    ins_weight: Optional[torch.Tensor] = None,
    loss_denom: Optional[torch.Tensor] = None,
    rank_offset: Optional[torch.Tensor] = None,
):
    """Forward + backward: (loss, preds, grads by param name, grad of flat).

    ``flat`` enters as a leaf, as JAX takes ``gflat`` with respect to it,
    so the gather that built it stays out of the backward graph; the rank
    tower's gradient reaches it through ``slot_feats``. ``rank_offset``
    stays out of the gradient. A param the forward did not use (a
    RankDeepFM's ``rank_param`` without a rank matrix) gets a zero
    gradient, as ``jax.grad`` gives it."""
    names = list(params)
    with torch.enable_grad():
        p = {k: params[k].detach().requires_grad_(True) for k in names}
        flat_leaf = flat.detach().requires_grad_(True)
        loss, preds = local_forward(
            model_apply, cfg, p, flat_leaf, segments, labels, dense,
            ins_weight=ins_weight, loss_denom=loss_denom, rank_offset=rank_offset,
        )
        grads = torch.autograd.grad(loss, [p[k] for k in names] + [flat_leaf], allow_unused=True)
    gparams = {
        k: g if g is not None else torch.zeros_like(p[k]) for k, g in zip(names, grads[:-1])
    }
    return loss.detach(), preds.detach(), gparams, grads[-1]


def scale_and_merge_grads(
    cfg: TrainStepConfig,
    gflat: torch.Tensor,  # [L, PW]
    segments: torch.Tensor,  # [L]
    inverse: torch.Tensor,  # [L] flat key -> merge position
    labels: torch.Tensor,  # [b]
    num_segments: int,
    ins_weight: Optional[torch.Tensor] = None,  # [b] ghosts -> 0 show/clk
    grad_div: float = 1.0,
):
    """Push-side merge: slot-lr scale, pad mask, per-position sums.

    Returns (merged grads, show counts, clk counts), each [num_segments, ...].
    ``grad_div`` rescales a rank's local-mean grads to the global mean on a
    mesh (a tensor divisor: a scalar one may multiply by its reciprocal)."""
    S, b = cfg.num_slots, cfg.batch_size
    if grad_div != 1.0:
        gflat = torch.div(gflat, torch.full((), grad_div, dtype=gflat.dtype, device=gflat.device))
    if cfg.slot_lr is not None:
        slot_of_key = torch.clamp(segments // b, max=S - 1).long()
        lr_tab = torch.tensor(cfg.slot_lr, dtype=torch.float32, device=gflat.device)
        gflat = gflat * lr_tab[slot_of_key][:, None]
    pad_mask = (segments < S * b).to(torch.float32)  # [L] 0 on pad keys
    ins_of_key = (segments % b).long()
    valid = pad_mask if ins_weight is None else pad_mask * ins_weight[ins_of_key]
    gflat = gflat * pad_mask[:, None]
    # one segment reduction for grads + show + clk (PushMergeCopy parity)
    ext = torch.cat(
        [gflat, valid[:, None], (labels[ins_of_key] * valid)[:, None]], dim=1
    )
    summed = segment_sum(ext, inverse, num_segments)
    return summed[:, :-2], summed[:, -2], summed[:, -1]


def adjusted_loss_weight(
    cfg: TrainStepConfig,
    flat: torch.Tensor,  # [L, PW] pulled records (col 0 = show)
    segments: torch.Tensor,  # [L]
    ins_weight: Optional[torch.Tensor],  # [b] or None
    b: int,
):
    """(loss_weight [b], loss_denom) for AdjustInsWeight
    (downpour_worker.cc:271-340): instances whose nid slot's show is under
    the threshold get w = max(w, log(e + (T - nid_show) / T * ratio)); the
    denominator stays the real-instance count."""
    nid, thr, ratio = cfg.adjust_ins_weight
    S = cfg.num_slots
    slot_of_key = segments // b
    ins_of_key = (segments % b).long()
    is_nid = (slot_of_key == nid) & (segments < S * b)
    neg_inf = torch.full((), float("-inf"), dtype=flat.dtype, device=flat.device)
    nid_show = torch.full((b,), float("-inf"), dtype=flat.dtype, device=flat.device)
    # max is order-free: scatter_reduce gives the same bits in any order
    nid_show = nid_show.scatter_reduce(
        0, ins_of_key, torch.where(is_nid, flat[:, 0], neg_inf), reduce="amax"
    )
    base = ins_weight if ins_weight is not None else torch.ones((b,), dtype=torch.float32, device=flat.device)
    adj = torch.log(torch.e + (thr - nid_show) / thr * ratio)
    loss_w = torch.where((nid_show >= 0) & (nid_show < thr), torch.maximum(base, adj), base)
    # weight-0 ghosts stay exactly zero
    loss_w = torch.where(base > 0, loss_w, base)
    denom = (
        torch.full((), float(b), dtype=torch.float32, device=flat.device)
        if ins_weight is None
        else torch.clamp(ins_weight.sum(), min=1.0)
    )
    return loss_w, denom


def check_expand(cfg: TrainStepConfig) -> None:
    """``use_expand`` needs a layout with an expand block."""
    if cfg.use_expand and cfg.layout.expand_dim == 0:
        raise ValueError(
            "use_expand needs a layout with an expand block (ValueLayout(expand_embed_dim > 0), "
            "not SHARE_EMBEDDING)"
        )


def make_train_step(
    model_apply: Callable,
    cfg: TrainStepConfig,
    dense_opt: Optional[Adam] = None,
    eval_mode: bool = False,
) -> Callable:
    """Build ``step(state, batch_dict) -> (state, metrics)``.

    ``model_apply(params, slot_feats, dense) -> logits``, or with
    ``cfg.model_takes_rank_offset`` ``model_apply(params, slot_feats,
    dense, rank_offset)`` (the join phase's ``models.RankDeepFM``).
    ``batch_dict`` fields are tensors on the table's device: uniq_rows [U],
    inverse [L], segments [L], labels [B], optional dense [B, Dd],
    ins_weight [B] and rank_offset [B, 2R+1]. See data/device_pack.py.

    ``eval_mode`` is forward + AUC, with table, params and opt_state
    returned as they came. Training updates the table in place. Dense sync
    "step" and "kstep" are the same local update on one device and need
    ``dense_opt``; under "async" the host's ``AsyncDenseTable`` owns the
    dense optimizer: the step returns params and opt_state as they came
    and its dense gradients as ``metrics["gparams"]`` (an eval step never
    does). With ``cfg.use_expand`` the step pulls with the extended pull
    (pull_box_extended_sparse): the pulled records carry the expand block
    as trailing columns, the model gets the pooled expand embeddings as its
    last argument, and the push trains the expand block with its own g2.
    A mesh's step is :func:`~paddlebox_tpu_torch.train.sharded_step.
    make_sharded_train_step`: a ``cfg.axis_name`` here raises.
    """
    if cfg.axis_name is not None:
        raise ValueError(
            f"cfg.axis_name={cfg.axis_name!r} names a mesh axis: a mesh's step is "
            "train/sharded_step.py's make_sharded_train_step"
        )
    check_expand(cfg)
    lay, opt = cfg.layout, cfg.sparse_opt

    def pull(table: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
        """[U, PW] records, or [U, PW + E] with the expand block."""
        if cfg.use_expand:
            rec, exp = pull_sparse_rows_extended(table, rows, lay, opt.embedx_threshold, cfg.pull_scale)
            return torch.cat([rec, exp], dim=1)
        return pull_sparse_rows(table, rows, lay, opt.embedx_threshold, cfg.pull_scale)

    if eval_mode:

        @torch.no_grad()
        def eval_step(state: TrainState, batch: Dict[str, torch.Tensor]):
            pulled_u = pull(state.table, batch["uniq_rows"])  # [U, PW(+E)]
            flat = pulled_u.index_select(0, batch["inverse"].long())  # [L, PW(+E)]
            labels = batch["labels"]
            # the instance weights weigh the loss and mask the AUC, as in
            # training; AdjustInsWeight is a training-only rule
            ins_weight = batch.get("ins_weight")
            loss, preds = local_forward(
                model_apply, cfg, state.params, flat, batch["segments"], labels,
                batch.get("dense"), ins_weight=ins_weight, rank_offset=batch.get("rank_offset"),
            )
            auc_mask = None if ins_weight is None else (ins_weight > 0)
            new_auc = auc_update(state.auc, preds, labels, auc_mask)
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

        return eval_step

    is_async = cfg.dense_sync_mode == "async"
    if dense_opt is None and not is_async:
        raise ValueError("the training step needs a dense optimizer (train/dense_opt.py)")
    B = cfg.batch_size

    @torch.no_grad()
    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        uniq_rows = batch["uniq_rows"]
        inverse = batch["inverse"]
        segments = batch["segments"]
        labels = batch["labels"]
        dense = batch.get("dense")
        ins_weight = batch.get("ins_weight")
        U = uniq_rows.shape[0]

        pulled_u = pull(state.table, uniq_rows)  # [U, PW(+E)]
        flat = pulled_u.index_select(0, inverse.long())  # [L, PW(+E)]

        loss_w, loss_denom = ins_weight, None
        if cfg.adjust_ins_weight is not None:
            loss_w, loss_denom = adjusted_loss_weight(cfg, flat, segments, ins_weight, B)
        loss, preds, gparams, gflat = local_forward_backward(
            model_apply, cfg, state.params, flat, segments, labels, dense,
            ins_weight=loss_w, loss_denom=loss_denom, rank_offset=batch.get("rank_offset"),
        )
        finite = None
        zero = torch.zeros((), dtype=torch.float32, device=flat.device)
        if cfg.check_nan:
            gsum = loss + torch.sum(gflat)
            for g in gparams.values():
                gsum = gsum + torch.sum(g)
            finite = torch.isfinite(gsum)
            # where, not multiply: NaN * 0 is still NaN
            gflat = torch.where(finite, gflat, zero)

        # sparse push: slot-lr scaling at flat resolution, then grads merge
        # per unique row (PushMergeCopy parity)
        guniq, show_counts, clk_counts = scale_and_merge_grads(
            cfg, gflat, segments, inverse, labels, num_segments=U, ins_weight=ins_weight
        )
        if finite is not None:
            # a zeroed push is an exact identity on the table; where, not
            # multiply: a NaN label rides into clk through the merge
            show_counts = torch.where(finite, show_counts, zero)
            clk_counts = torch.where(finite, clk_counts, zero)
        push_sparse_rows(state.table, uniq_rows, guniq, show_counts, clk_counts, lay, opt)

        if is_async:
            # the host's AsyncDenseTable owns the dense optimizer: the
            # gradients go back to it through the metrics
            new_params, new_opt_state = state.params, state.opt_state
        else:
            # "step" and "kstep" are one local update on one device
            updates, new_opt_state = dense_opt.update(gparams, state.opt_state)
            new_params = {k: p + updates[k] for k, p in state.params.items()}
        if finite is not None and not is_async:
            # skipped batch: dense params and optimizer moments stay put
            new_params = {k: torch.where(finite, v, state.params[k]) for k, v in new_params.items()}
            new_opt_state = tree_map(
                lambda new, old: torch.where(finite, new, old), new_opt_state, state.opt_state
            )

        auc_mask = None if ins_weight is None else (ins_weight > 0)
        if finite is not None:
            fin_mask = finite.expand(labels.shape)
            auc_mask = fin_mask if auc_mask is None else (auc_mask & fin_mask)
        new_auc = auc_update(state.auc, preds, labels, auc_mask)
        # a skipped batch never happened: the step counter stays
        step_inc = (
            torch.ones((), dtype=torch.int32, device=flat.device)
            if finite is None
            else finite.to(torch.int32)
        )
        metrics = {
            "loss": loss,
            "step": state.step + step_inc,
            "preds": preds,
            "labels": labels,
        }
        if finite is not None:
            metrics["nan_skipped"] = (~finite).to(torch.int32)
        if is_async:
            metrics["gparams"] = gparams
        return (
            TrainState(
                table=state.table,
                params=new_params,
                opt_state=new_opt_state,
                auc=new_auc,
                step=state.step + step_inc,
            ),
            metrics,
        )

    return step
