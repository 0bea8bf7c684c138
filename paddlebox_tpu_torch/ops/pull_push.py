"""Device-side sparse pull/push over the pass working-set table.

Port of the JAX package's ``ops/pull_push.py`` (PullSparseCase/
PushSparseGradCase, box_wrapper_impl.h:25-253, kernels in box_wrapper.cu):
keys were already remapped host-side to dense row ids, so

- pull = gather rows + embedx activity gating + scale   (static shapes)
- push = gather old rows + sparse-AdaGrad column math + one write back

On a CUDA table the gather is the hand-written kernel
:func:`~paddlebox_tpu_torch.ops.cuda_kernels.pull_rows_cuda` and the
writeback :func:`~paddlebox_tpu_torch.ops.cuda_kernels.write_rows_cuda`; on
a CPU table both are their plain versions. The push updates the table in
place (the JAX package donates it to the step). The table row layout is
``ValueLayout``: ``[show, clk, extras..., embed_w, embedx[D], embed_g2,
embedx_g2]``.
"""

from __future__ import annotations

from typing import Union

import torch

from paddlebox_tpu_torch import config
from paddlebox_tpu_torch.ops.cuda_kernels import (
    pull_rows_cuda,
    pull_rows_ref,
    write_rows_cuda,
    write_rows_ref,
)
from paddlebox_tpu_torch.table.optimizers import SparseOptimizerConfig
from paddlebox_tpu_torch.table.value_layout import FeatureType, ValueLayout


def gather_rows(table: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Row gather: the CUDA kernel on a GPU table, the plain version on a
    CPU one. Nothing else picks between them."""
    if table.is_cuda:
        return pull_rows_cuda(table, rows)
    if table.device.type != "cpu":
        raise ValueError(f"no row gather for a table on {table.device}")
    return pull_rows_ref(table, rows)


def write_rows(table: torch.Tensor, rows: torch.Tensor, new_rows: torch.Tensor) -> torch.Tensor:
    """Row writeback in place: the CUDA kernel on a GPU table, the plain
    version on a CPU one. Nothing else picks between them."""
    if table.is_cuda:
        return write_rows_cuda(table, rows, new_rows)
    if table.device.type != "cpu":
        raise ValueError(f"no row writeback for a table on {table.device}")
    return write_rows_ref(table, rows, new_rows)


def embedx_active_mask(
    layout: ValueLayout, show: torch.Tensor, embedx_threshold: float
) -> torch.Tensor:
    """Activation mask for the embedx block, from the key's show count.

    Row-level threshold gate (the closed lib's ``embedding_size > 0``
    signal, box_wrapper.cu:54-63) — or, for FeatureType.VARIABLE, the
    graded per-column unlock (column j needs show >= threshold *
    2^quarter(j)): cold keys expose a short vector, hot keys the full one.
    Returns [U, D] for VARIABLE layouts, [U, 1] otherwise.
    """
    if layout.feature_type is FeatureType.VARIABLE:
        D = layout.embedx_dim
        quarter = torch.arange(D, dtype=torch.int32, device=show.device) * 4 // max(D, 1)
        need = embedx_threshold * torch.exp2(quarter.to(torch.float32))
        return show[:, None] >= need[None, :]
    return (show >= embedx_threshold)[:, None]


def _pull_gated(table: torch.Tensor, rows: torch.Tensor, layout: ValueLayout, embedx_threshold: float, scale):
    """(gathered rows [U, width], pull records [U, pull_width]): the gather,
    the embedx gate and the scale that both pulls share."""
    picked = gather_rows(table, rows)  # [U, width]
    cvm_block = picked[:, : layout.cvm_offset]
    embedx = picked[:, layout.embedx_col : layout.embedx_col + layout.embedx_dim]
    active = embedx_active_mask(layout, picked[:, layout.SHOW], embedx_threshold)
    embedx = torch.where(active, embedx * scale, torch.zeros((), dtype=embedx.dtype, device=embedx.device))
    return picked, torch.cat([cvm_block, embedx], dim=1)


def pull_sparse_rows(
    table: torch.Tensor,  # [rows, width] f32
    rows: torch.Tensor,  # int32 [U] (deduped, padded with the padding row)
    layout: ValueLayout,
    embedx_threshold: float,
    scale: float = 1.0,
) -> torch.Tensor:
    """Gather pull records [U, pull_width] = [show, clk, .., embed_w, embedx].

    embedx columns are zeroed per ``embedx_active_mask``: for keys whose
    show count has not reached the activation threshold or, on VARIABLE
    layouts, per column as the graded dims unlock.
    """
    return _pull_gated(table, rows, layout, embedx_threshold, scale)[1]


def pull_sparse_rows_extended(
    table: torch.Tensor,  # [rows, width] f32
    rows: torch.Tensor,  # int32 [U]
    layout: ValueLayout,
    embedx_threshold: float,
    scale: float = 1.0,
):
    """(pull records [U, pull_width], expand embeddings [U, expand_dim]):
    pull_box_extended_sparse (pull_box_extended_sparse_op.h:26-95). The
    embedx block is gated as in :func:`pull_sparse_rows`; the expand block
    is gated by row (an independent second embedding)."""
    if layout.expand_dim == 0:
        raise ValueError("layout has no expand block (expand_embed_dim == 0)")
    picked, pulled = _pull_gated(table, rows, layout, embedx_threshold, scale)
    row_active = (picked[:, layout.SHOW] >= embedx_threshold)[:, None]
    expand = picked[:, layout.expand_col : layout.expand_col + layout.expand_dim]
    zero = torch.zeros((), dtype=picked.dtype, device=picked.device)
    return pulled, torch.where(row_active, expand * scale, zero)


def push_sparse_rows(
    table: torch.Tensor,  # [rows, width] f32, updated in place
    rows: torch.Tensor,  # int32 [U] deduped rows (padding row allowed)
    grads: torch.Tensor,  # [U, pull_width] d(loss)/d(pull record)
    show_counts: torch.Tensor,  # f32 [U] occurrences of the key in this batch
    clk_counts: torch.Tensor,  # f32 [U] summed clicks over those occurrences
    layout: ValueLayout,
    opt: SparseOptimizerConfig,
    lr_scale: Union[torch.Tensor, float] = 1.0,  # scalar or [U] slot-lr multiplier
) -> torch.Tensor:
    """Apply sparse AdaGrad + counter updates to ``table`` in place; returns
    it.

    With deduplicated rows (the flag ``enable_pullpush_dedup_keys``, which
    the packer reads too) the rows are unique except for padding
    row repeats, whose contents are identical, so the push writes the
    updated rows back. Without dedup a key may occur several times; each
    occurrence's delta is added in row order (sequential-push semantics),
    through ``index_put_(accumulate=True)``, which sorts the indices and
    sums each run of duplicates in order: the same bits on every run, no
    float atomics.
    """
    old = gather_rows(table, rows)  # [U, width]
    new_rows = sparse_update_rows(
        old, grads, show_counts, clk_counts, layout, opt, lr_scale
    )
    if config.get_flag("enable_pullpush_dedup_keys"):
        return write_rows(table, rows, new_rows)
    return table.index_put_((rows.long(),), new_rows - old, accumulate=True)


def sparse_update_rows(
    old: torch.Tensor,  # [U, width] current rows
    grads: torch.Tensor,  # [U, pull_width] or [U, pull_width + expand_dim]
    show_counts: torch.Tensor,  # f32 [U]
    clk_counts: torch.Tensor,  # f32 [U]
    layout: ValueLayout,
    opt: SparseOptimizerConfig,
    lr_scale: Union[torch.Tensor, float] = 1.0,
) -> torch.Tensor:
    """Row-wise sparse optimizer math -> the updated rows [U, width].

    Rows with all-zero records are identities (g2 += 0, step 0, counters
    += 0). ``grads`` in the extended form (pull_width + expand_dim) carries
    expand-embedding grads, updated with their own AdaGrad g2 scalar.
    """
    co, D = layout.cvm_offset, layout.embedx_dim
    with_expand = grads.shape[1] == layout.extended_push_width and layout.expand_dim > 0
    zero = torch.zeros((), dtype=old.dtype, device=old.device)

    show = old[:, layout.SHOW] + show_counts
    clk = old[:, layout.CLK] + clk_counts

    # embed_w (+ any conv/pcoc extras: cols 2..cvm_offset) scalar AdaGrad;
    # the show/clk columns of the pull record get no update (counters are
    # statistics, not weights)
    w_grad = grads[:, 2:co]  # [U, co-2] (embed_w last)
    g2_e = old[:, layout.embed_g2_col] + torch.sum(w_grad * w_grad, dim=1)
    scale_e = torch.sqrt(opt.initial_g2sum / (opt.initial_g2sum + g2_e))
    step_e = (opt.embed_lr * lr_scale * scale_e)[:, None] * w_grad
    new_w = torch.clamp(old[:, 2:co] - step_e, -opt.weight_bounds, opt.weight_bounds)

    # embedx AdaGrad with one shared g2 scalar (mean energy). The mask must
    # match the pull's (VARIABLE graded dims included): a locked dim's grad
    # is nonzero even though the model saw a zero
    x_grad = grads[:, co : co + D]
    x_active = embedx_active_mask(layout, old[:, layout.SHOW], opt.embedx_threshold)
    x_grad = torch.where(x_active, x_grad, zero)
    g2_x = old[:, layout.embedx_g2_col] + torch.mean(x_grad * x_grad, dim=1)
    scale_x = torch.sqrt(opt.initial_g2sum / (opt.initial_g2sum + g2_x))
    new_x = old[:, co : co + D] - (opt.embedx_lr * lr_scale * scale_x)[:, None] * x_grad
    new_x = torch.clamp(new_x, -opt.weight_bounds, opt.weight_bounds)

    cols = [show[:, None], clk[:, None], new_w, new_x]
    if layout.expand_dim:
        E = layout.expand_dim
        ec = layout.expand_col
        if with_expand:
            # expand is row-level gated (an independent second embedding)
            row_active = (old[:, layout.SHOW] >= opt.embedx_threshold)[:, None]
            e_grad = torch.where(row_active, grads[:, co + D : co + D + E], zero)
        else:  # plain push on an expand-capable layout: expand untouched
            e_grad = torch.zeros((old.shape[0], E), dtype=old.dtype, device=old.device)
        g2_p = old[:, layout.expand_g2_col] + torch.mean(e_grad * e_grad, dim=1)
        scale_p = torch.sqrt(opt.initial_g2sum / (opt.initial_g2sum + g2_p))
        new_p = old[:, ec : ec + E] - (opt.embedx_lr * lr_scale * scale_p)[:, None] * e_grad
        cols.append(torch.clamp(new_p, -opt.weight_bounds, opt.weight_bounds))
        cols += [g2_e[:, None], g2_x[:, None], g2_p[:, None]]
    else:
        cols += [g2_e[:, None], g2_x[:, None]]
    return torch.cat(cols, dim=1)
