"""The mesh train step: data-parallel batch, sharded table, replicated dense.

Port of the JAX package's ``train/sharded_step.py`` (BoxPSWorker::TrainFiles
boxps_worker.cc:420-466 over many GPUs with SyncParam :359-398 and
PullSparseGPU/PushSparseGPU). JAX compiles one ``shard_map`` program that
runs the per-device body on every device; the port is SPMD, so every rank
of the process group runs :func:`make_local_mesh_step`'s body on its own
card:

  pull its request buckets over ``all_to_all`` ─┐
  seqpool+CVM -> model forward/backward        │ collectives of the
  push grads over ``all_to_all`` to the owners ─┤ plan (parallel/mesh.py)
  dense grads and loss all-reduced ─────────────┘
  AUC into the rank's own bucket tables (summed at read time, auc_psum)

A rank's state: ``table`` its shard [cap, width], ``params`` and
``opt_state`` replicated (kstep: the rank's replica; ZeRO-1: its moment
chunk), ``auc`` its own tables, ``step`` the replicated counter. A rank's
batch: ``req_ranks`` [n, K], ``inverse`` / ``segments`` [L], ``labels``
[b] and optionally ``dense`` [b, Dd], ``ins_weight`` [b] and, in the join
phase, ``rank_offset`` [b, 2R+1] (the model's input with
``cfg.model_takes_rank_offset``), block ``[rank]`` of
``pack_batch_sharded`` / ``pack_sharded`` and the pv plan.

The numerics follow JAX's branch by branch: weighted or adjusted batches
normalize by the global weight sum (``loss_denom``, an all-reduce) with
``grad_div`` 1 and psum the dense grads and the loss; others pmean them
with ``grad_div`` = world. ``check_nan`` all-reduces the ranks'
non-finiteness, so one poisoned rank skips the batch on every rank
(``torch.where`` selects the pre-step dense state; the step counter does
not advance). kstep keeps local dense replicas (a weighted batch's grads
rescaled to the local mean) and averages the params every
``param_sync_step`` steps, by a host counter every rank advances alike
(``TrainState.host_step``), never by reading ``step`` back; with
``check_nan`` the counter may not advance, so the average is then
computed every step and selected on the card. Eval mode pulls and runs
the forward only: table, params and optimizer state come back as they
came. Under ``dense_sync_mode="async"`` the step leaves params and
optimizer state as they came and returns the globally reduced dense
gradients as ``metrics["gparams"]`` (the same on every rank); the
trainer pushes them to the one ``AsyncDenseTable`` (rank 0's) and
broadcasts its params before the next step. With ``cfg.use_expand`` the
pull and the push carry the expand block over the same ``all_to_all``
(``extended=True``; the quantised wires send it as its own section), as
the JAX package's ``extended=cfg.use_expand`` does.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch

from paddlebox_tpu_torch.fleet.zero import Zero1Optimizer
from paddlebox_tpu_torch.metrics.auc import AucState, auc_update
from paddlebox_tpu_torch.parallel.mesh import MeshPlan, put_replicated, put_sharded
from paddlebox_tpu_torch.parallel.sharded_pullpush import sharded_pull, sharded_push
from paddlebox_tpu_torch.train.dense_opt import tree_map
from paddlebox_tpu_torch.train.train_step import (
    TrainState,
    TrainStepConfig,
    adjusted_loss_weight,
    check_expand,
    local_forward,
    local_forward_backward,
    scale_and_merge_grads,
)


def _flat(tensors: List[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def _split(flat: torch.Tensor, like: List[torch.Tensor]) -> List[torch.Tensor]:
    out, off = [], 0
    for t in like:
        n = t.numel()
        out.append(flat[off : off + n].reshape(t.shape))
        off += n
    return out


def _psum_dict(plan: MeshPlan, tree: Dict[str, torch.Tensor], extra: Optional[torch.Tensor] = None):
    """psum of a dict of tensors (and one more scalar) in ONE all-reduce:
    the same elementwise sums as one collective a tensor."""
    keys = list(tree)
    parts = [tree[k] for k in keys] + ([extra.reshape(1)] if extra is not None else [])
    summed = _split(plan.all_reduce(_flat(parts)), parts)
    out = dict(zip(keys, summed[: len(keys)]))
    return out, (summed[-1].reshape(()) if extra is not None else None)


def _div(x: torch.Tensor, n: float) -> torch.Tensor:
    return torch.div(x, torch.full((), n, dtype=x.dtype, device=x.device))


def _where_state(finite: torch.Tensor, new: Any, old: Any) -> Any:
    return tree_map(lambda a, b: torch.where(finite, a, b), new, old)


def _check_mesh_cfg(cfg: TrainStepConfig, dense_opt, plan: MeshPlan) -> None:
    if cfg.axis_name not in (None, plan.axis):
        raise ValueError(
            f"cfg.axis_name {cfg.axis_name!r} != mesh axis {plan.axis!r}; the sharded "
            "step always runs its collectives over the plan's axis"
        )
    check_expand(cfg)
    if isinstance(dense_opt, Zero1Optimizer):
        if cfg.dense_sync_mode == "async":
            raise ValueError(
                "dense_sync_mode='async' hands the dense optimizer to the host "
                "AsyncDenseTable: ZeRO state sharding has nothing to shard"
            )
        if cfg.dense_sync_mode == "kstep":
            raise ValueError(
                "ZeRO state sharding needs identical (replicated) grads each step; "
                "kstep's local grads would diverge the chunks"
            )
        dense_opt.check_axis(plan.axis, plan.world)


def init_sharded_train_state(
    plan: MeshPlan,
    table: Any,  # [n, cap, width] (numpy or tensor), or this rank's [cap, width]
    params: Dict[str, torch.Tensor],
    dense_opt,
    auc_buckets: int = 100_000,
    opt_state: Any = None,  # carried between passes; None = fresh
    local_dense: bool = False,  # kstep: per-rank dense replicas
) -> TrainState:
    """This rank's mesh state: its table block (a copy), copies of the
    params and optimizer state on its card, zero AUC tables, step 0.

    With a :class:`Zero1Optimizer` the optimizer state is this rank's
    chunk: of ``opt_state`` when given (stacked, every leaf [n, ...], or
    this rank's own), else of a fresh ``init_stacked``."""
    dev = plan.device
    table = put_sharded(plan, table) if len(table.shape) == 3 else put_replicated(plan, table)
    params = put_replicated(plan, params)
    if isinstance(dense_opt, Zero1Optimizer):
        if local_dense:
            raise ValueError("ZeRO sharding and kstep local replicas conflict")
        dense_opt.check_axis(plan.axis, plan.world)
        st = opt_state if opt_state is not None else dense_opt.init_stacked(params)
        if Zero1Optimizer.is_stacked(st):  # stacked: this rank's chunk
            st = Zero1Optimizer.local_state(st, plan.rank)
        opt = st
    else:
        opt = opt_state if opt_state is not None else dense_opt.init(params)
    opt = tree_map(lambda t: put_replicated(plan, t), opt)
    return TrainState(
        table=table,
        params=params,
        opt_state=opt,
        auc=AucState(
            pos=torch.zeros((auc_buckets,), dtype=torch.int32, device=dev),
            neg=torch.zeros((auc_buckets,), dtype=torch.int32, device=dev),
        ),
        step=torch.zeros((), dtype=torch.int32, device=dev),
    )


def make_local_mesh_step(
    model_apply: Callable,
    dense_opt,
    cfg: TrainStepConfig,
    plan: MeshPlan,
    eval_mode: bool = False,
) -> Callable:
    """This rank's mesh step ``step(state, batch) -> (state, metrics)``.

    The host-packed feeds call it with a block of ``pack_sharded``; the
    resident mesh superstep with a batch it built on the card. Training
    updates the table shard in place."""
    _check_mesh_cfg(cfg, dense_opt, plan)
    is_zero = isinstance(dense_opt, Zero1Optimizer)
    kstep = cfg.dense_sync_mode == "kstep"
    is_async = cfg.dense_sync_mode == "async"
    lay, opt = cfg.layout, cfg.sparse_opt
    b = cfg.batch_size
    world = float(plan.world)

    def pulled_flat(state: TrainState, batch: Dict[str, torch.Tensor]):
        pulled = sharded_pull(
            plan, state.table, batch["req_ranks"], lay, opt.embedx_threshold, cfg.pull_scale,
            extended=cfg.use_expand,
        )  # [n*K, PW(+E)]
        return pulled.index_select(0, batch["inverse"].long())  # [L, PW(+E)]

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        flat = pulled_flat(state, batch)
        labels = batch["labels"]
        ins_weight = batch.get("ins_weight")
        loss_denom = None
        if ins_weight is not None:
            loss_denom = torch.clamp(plan.all_reduce(ins_weight.sum()), min=1.0)
        loss, preds = local_forward(
            model_apply, cfg, state.params, flat, batch["segments"], labels, batch.get("dense"),
            ins_weight=ins_weight, loss_denom=loss_denom, rank_offset=batch.get("rank_offset"),
        )
        loss = plan.all_reduce(loss)
        if ins_weight is None:
            loss = _div(loss, world)
        auc_mask = None if ins_weight is None else (ins_weight > 0)
        step_no = state.step + 1
        return (
            state._replace(auc=auc_update(state.auc, preds, labels, auc_mask), step=step_no),
            {"loss": loss, "step": step_no, "preds": preds, "labels": labels},
        )

    if eval_mode:
        return eval_step

    @torch.no_grad()
    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        req_ranks, inverse = batch["req_ranks"], batch["inverse"]
        segments, labels = batch["segments"], batch["labels"]
        dense, ins_weight = batch.get("dense"), batch.get("ins_weight")
        n, K = req_ranks.shape
        dev = labels.device
        flat = pulled_flat(state, batch)

        # weighted batches normalize by the GLOBAL weight sum, so their
        # local grads are already at the global scale (grad_div 1) and the
        # dense reduction is a psum; the shared table needs that even in
        # kstep, where only the dense update goes local
        adjust = cfg.adjust_ins_weight is not None
        weighted = ins_weight is not None or adjust
        if weighted:
            local_denom = (
                torch.full((), float(b), dtype=torch.float32, device=dev)
                if ins_weight is None
                else ins_weight.sum()
            )
            loss_denom = torch.clamp(plan.all_reduce(local_denom), min=1.0)
            grad_div = 1.0
        else:
            loss_denom = None
            grad_div = world
        loss_w = ins_weight
        if adjust:
            loss_w, _ = adjusted_loss_weight(cfg, flat, segments, ins_weight, b)
        loss, preds, gparams, gflat = local_forward_backward(
            model_apply, cfg, state.params, flat, segments, labels, dense,
            ins_weight=loss_w, loss_denom=loss_denom, rank_offset=batch.get("rank_offset"),
        )
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        finite = None
        if cfg.check_nan:
            gsum = loss + torch.sum(gflat)
            for g in gparams.values():
                gsum = gsum + torch.sum(g)
            # the table is shared: one poisoned rank skips the batch on all
            finite = plan.all_reduce((~torch.isfinite(gsum)).to(torch.int32)) == 0
            gflat = torch.where(finite, gflat, zero)  # where: NaN * 0 is NaN

        gbucket, show_bucket, clk_bucket = scale_and_merge_grads(
            cfg, gflat, segments, inverse, labels, num_segments=n * K,
            ins_weight=ins_weight, grad_div=grad_div,
        )
        if finite is not None:
            show_bucket = torch.where(finite, show_bucket, zero)
            clk_bucket = torch.where(finite, clk_bucket, zero)
        sharded_push(plan, state.table, req_ranks, gbucket, show_bucket, clk_bucket, lay, opt)

        if kstep:
            # LocalSGD: the dense update takes the LOCAL grads; weighted
            # grads came out against the global denominator, so rescale
            # them to this rank's local weighted mean
            if weighted:
                local_w = (
                    torch.full((), float(b), dtype=torch.float32, device=dev)
                    if ins_weight is None
                    else torch.clamp(ins_weight.sum(), min=1.0)
                )
                gparams = {k: g * (loss_denom / local_w) for k, g in gparams.items()}
                loss = plan.all_reduce(loss)
            else:
                loss = _div(plan.all_reduce(loss), world)
        else:
            gparams, loss = _psum_dict(plan, gparams, loss)
            if not weighted:
                gparams = {k: _div(g, world) for k, g in gparams.items()}
                loss = _div(loss, world)
        if is_async:
            # the host AsyncDenseTable owns the dense optimizer: the reduced
            # grads ride back in metrics, the dense side stays as it came
            new_params, new_opt_state = state.params, state.opt_state
        elif is_zero:
            # this rank updates its chunk; all_gather rebuilds the update
            updates, new_opt_state = dense_opt.update_local(plan, gparams, state.opt_state)
            new_params = {k: p + updates[k] for k, p in state.params.items()}
        else:
            updates, new_opt_state = dense_opt.update(gparams, state.opt_state)
            new_params = {k: p + updates[k] for k, p in state.params.items()}
        step_inc = (
            torch.ones((), dtype=torch.int32, device=dev) if finite is None else finite.to(torch.int32)
        )
        host_step = state.host_step + 1
        if kstep:
            # average the replicas every param_sync_step steps (SyncParam)
            if finite is None:
                if host_step % cfg.param_sync_step == 0:
                    avg, _ = _psum_dict(plan, new_params)
                    new_params = {k: _div(v, world) for k, v in avg.items()}
            else:
                # a skipped batch does not advance ``step``: the cadence
                # lives on the card
                avg, _ = _psum_dict(plan, new_params)
                now = (state.step + 1) % cfg.param_sync_step == 0
                new_params = {k: torch.where(now, _div(avg[k], world), v) for k, v in new_params.items()}
        if finite is not None:
            # a skipped batch leaves the dense side as it was
            new_params = {k: torch.where(finite, v, state.params[k]) for k, v in new_params.items()}
            new_opt_state = _where_state(finite, new_opt_state, state.opt_state)

        auc_mask = None if ins_weight is None else (ins_weight > 0)
        if finite is not None:
            fin_mask = finite.expand(labels.shape)
            auc_mask = fin_mask if auc_mask is None else (auc_mask & fin_mask)
        new_auc = auc_update(state.auc, preds, labels, auc_mask)
        metrics = {"loss": loss, "step": state.step + step_inc, "preds": preds, "labels": labels}
        if finite is not None:
            metrics["nan_skipped"] = (~finite).to(torch.int32)
        if is_async:
            metrics["gparams"] = gparams  # globally reduced, the same on every rank
        return (
            TrainState(
                table=state.table,
                params=new_params,
                opt_state=new_opt_state,
                auc=new_auc,
                step=state.step + step_inc,
                host_step=host_step,
            ),
            metrics,
        )

    return step


def make_sharded_train_step(
    model_apply: Callable,
    dense_opt,
    cfg: TrainStepConfig,
    plan: MeshPlan,
    eval_mode: bool = False,
) -> Callable:
    """``step(state, batch) -> (state, metrics)`` on the mesh, run by every
    rank (SPMD: the per-rank body of :func:`make_local_mesh_step`).

    ``cfg.batch_size`` is the PER-RANK batch. ``eval_mode`` (SetTestMode,
    box_wrapper.cc:623) pulls over the mesh and runs the forward and the
    AUC only: table, params and opt_state come back as they came."""
    return make_local_mesh_step(model_apply, dense_opt, cfg, plan, eval_mode)


def kstep_sync_params(state: TrainState, plan: MeshPlan) -> TrainState:
    """Average the ranks' dense replicas of a kstep state (the pass-end
    SyncParam, boxps_worker.cc:459-461): one all-reduce."""
    avg, _ = _psum_dict(plan, state.params)
    return state._replace(params={k: _div(v, float(plan.world)) for k, v in avg.items()})
