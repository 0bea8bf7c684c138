"""Fused sequence-pool + CVM over ragged slot batches.

Port of the JAX package's ``ops/seqpool_cvm.py`` main-path variant
(fused_seqpool_cvm_op.cu parity): per (slot, instance) sum-pool of the
pulled key records, then the CVM transform on the leading show/click
columns:

    out[0] = log(show_sum + 1)
    out[1] = log(clk_sum + 1) - log(show_sum + 1)        (join phase, use_cvm)
    out[2:] passthrough
  or, update phase (use_cvm=False): strip the first two columns.

Options mirrored: pad_value, need_filter (drop keys failing
(show-clk)*show_coeff + clk*clk_coeff >= threshold), clk_filter (join with
show only), quant_ratio (round(v*q)/q).

The ragged pooling is a segment sum over host-precomputed segment ids
(slot * batch + ins). The packer emits them non-decreasing, with pads at
the tail as the trash segment ``num_slots * batch_size``, so the sum is a
lengths-based ``torch.segment_reduce``: each output row is summed in key
order by one thread, with no atomics, and gives the same bits on every run.
The JAX package leaves this op to XLA; it is plain PyTorch here too.
"""

from __future__ import annotations

from typing import Optional

import torch


def cvm_transform(pooled: torch.Tensor, use_cvm: bool = True) -> torch.Tensor:
    """CVM on pooled records [..., width]: show/clk -> log CTR features."""
    show = pooled[..., 0:1]
    clk = pooled[..., 1:2]
    log_show = torch.log(show + 1.0)
    log_clk = torch.log(clk + 1.0)
    if use_cvm:
        return torch.cat([log_show, log_clk - log_show, pooled[..., 2:]], dim=-1)
    return pooled[..., 2:]


def segment_lengths(segments: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Key counts of segments 0..num_segments for non-decreasing ``segments``
    whose values lie in [0, num_segments]; [num_segments + 1] int64."""
    bounds = torch.arange(num_segments + 1, dtype=segments.dtype, device=segments.device)
    starts = torch.searchsorted(segments, bounds)
    ends = torch.cat([starts[1:], starts.new_full((1,), segments.shape[0])])
    return ends - starts


def segment_sum(data: torch.Tensor, ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """``out[s] = sum(data[ids == s])`` [num_segments, ...], in a fixed order.

    A stable sort by id, then a lengths-based ``segment_reduce`` that sums
    each segment in key order: no float atomics, the same bits every run.
    ``ids`` lie in [0, num_segments), so the lengths sum to the row count
    and ``unsafe=True`` skips the check of that (a read-back to the host)."""
    order = torch.argsort(ids, stable=True)
    lengths = segment_lengths(ids[order], num_segments)[:num_segments]
    return torch.segment_reduce(data[order], "sum", lengths=lengths, axis=0, unsafe=True)


def _seqpool(
    records: torch.Tensor,
    segments: torch.Tensor,
    num_slots: int,
    batch_size: int,
    pad_value: float,
    need_filter: bool,
    show_coeff: float,
    clk_coeff: float,
    threshold: float,
    quant_ratio: Optional[int],
    cvm_cols: int = 2,
) -> torch.Tensor:
    """Filter/quant at key level, then segment-sum.
    Returns [num_slots, batch, width]."""
    vals = records
    zero = torch.zeros((), dtype=vals.dtype, device=vals.device)
    if need_filter:
        score = (vals[:, 0] - vals[:, 1]) * show_coeff + vals[:, 1] * clk_coeff
        keep = score >= threshold
        vals = torch.where(keep[:, None], vals, zero)
    if quant_ratio:
        q = float(quant_ratio)
        head = vals[:, :cvm_cols]
        tail = torch.round(vals[:, cvm_cols:] * q) / q
        vals = torch.cat([head, tail], dim=1)

    num_segments = num_slots * batch_size
    lengths = segment_lengths(segments, num_segments)
    # the lengths are counts and sum to the key count by construction:
    # unsafe=True skips segment_reduce's check of that, which reads two
    # values back to the host
    pooled = torch.segment_reduce(vals, "sum", lengths=lengths, axis=0, unsafe=True)
    pooled = pooled[:num_segments].reshape(num_slots, batch_size, -1)
    if pad_value != 0.0:
        # slots with zero keys for an instance pool to pad_value, not 0
        empty = (lengths[:num_segments] == 0).reshape(num_slots, batch_size)
        pad = torch.full((), pad_value, dtype=pooled.dtype, device=pooled.device)
        pooled = torch.where(empty[..., None], pad, pooled)
    return pooled


def fused_seqpool_cvm(
    records: torch.Tensor,  # [L, width] pulled per-key records (flat, padded)
    segments: torch.Tensor,  # int32 [L] = slot * batch + ins; pads -> num_segments
    num_slots: int,
    batch_size: int,
    use_cvm: bool = True,
    pad_value: float = 0.0,
    need_filter: bool = False,
    show_coeff: float = 0.2,
    clk_coeff: float = 1.0,
    threshold: float = 0.96,
    quant_ratio: Optional[int] = None,
    clk_filter: bool = False,
) -> torch.Tensor:
    """-> [batch, num_slots, out_width] pooled + CVM'd slot features.

    ``segments`` must be non-decreasing, as the packer emits them. It may
    hold the value ``num_slots * batch_size`` for padded entries; those rows
    fall into a trash segment that is dropped.
    """
    pooled = _seqpool(
        records, segments, num_slots, batch_size, pad_value,
        need_filter, show_coeff, clk_coeff, threshold, quant_ratio,
    )
    out = cvm_transform(pooled, use_cvm=use_cvm)
    if use_cvm and clk_filter:
        # join with show only: drop the click column (col 1)
        out = torch.cat([out[..., 0:1], out[..., 2:]], dim=-1)
    return out.permute(1, 0, 2)  # -> [batch, slots, width]
