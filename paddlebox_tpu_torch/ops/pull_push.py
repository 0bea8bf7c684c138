"""Device-side sparse pull over the pass working-set table.

Port of the JAX package's ``ops/pull_push.py`` pull half (PullSparseCase,
box_wrapper_impl.h:25-253, PullCopy in box_wrapper.cu): keys were already
remapped host-side to dense row ids, so

- pull = gather rows + embedx activity gating + scale   (static shapes)

On a CUDA table the gather is the hand-written kernel
:func:`~paddlebox_tpu_torch.ops.cuda_kernels.pull_rows_cuda`; on a CPU table
it is the plain version. The table row layout is ``ValueLayout``:
``[show, clk, extras..., embed_w, embedx[D], embed_g2, embedx_g2]``.

The push half (sparse AdaGrad and the row writeback) comes with training.
"""

from __future__ import annotations

import torch

from paddlebox_tpu_torch.ops.cuda_kernels import pull_rows_cuda, pull_rows_ref
from paddlebox_tpu_torch.table.value_layout import FeatureType, ValueLayout


def _gather_rows(table: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Row gather: the CUDA kernel on a GPU table, the plain version on a
    CPU one. Nothing else picks between them."""
    if table.is_cuda:
        return pull_rows_cuda(table, rows)
    if table.device.type != "cpu":
        raise ValueError(f"no row gather for a table on {table.device}")
    return pull_rows_ref(table, rows)


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
    picked = _gather_rows(table, rows)  # [U, width]
    cvm_block = picked[:, : layout.cvm_offset]
    embedx = picked[:, layout.embedx_col : layout.embedx_col + layout.embedx_dim]
    active = embedx_active_mask(layout, picked[:, layout.SHOW], embedx_threshold)
    embedx = torch.where(active, embedx * scale, torch.zeros((), dtype=embedx.dtype, device=embedx.device))
    return torch.cat([cvm_block, embedx], dim=1)
