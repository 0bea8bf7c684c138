"""Fused sequence-pool + CVM over ragged slot batches.

Port of the JAX package's ``ops/seqpool_cvm.py`` (the fused_seqpool_cvm
op family, fused_seqpool_cvm_op.cu and its variants): per (slot,
instance) sum-pool of the pulled key records, then the CVM transform on
the leading show/click columns:

    out[0] = log(show_sum + 1)
    out[1] = log(clk_sum + 1) - log(show_sum + 1)        (join phase, use_cvm)
    out[2:] passthrough
  or, update phase (use_cvm=False): strip the first two columns.

Options mirrored: pad_value, need_filter (drop keys failing
(show-clk)*show_coeff + clk*clk_coeff >= threshold), clk_filter (join with
show only), quant_ratio (round(v*q)/q). The variants: a threshold a slot
(``fused_seqpool_cvm_with_diff_thres``), the CONV layout's CVM
(``cvm_with_conv_transform``, ``fused_seqpool_cvm_with_conv``) and the
PCOC layout's (``cvm_with_pcoc_transform``, ``fused_seqpool_cvm_with_pcoc``).
The main path's ``fused_seqpool_cvm`` takes the packer's sorted segments;
the variants take segments in any order and sort them stably first, so
each segment still sums its keys in their order.

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


def cvm_with_conv_transform(
    pooled: torch.Tensor, use_cvm: bool = True, show_filter: bool = False
) -> torch.Tensor:
    """CVM for CONV layouts [show, clk, conv, ...] (FusedCVMWithConvKernel,
    fused_seqpool_cvm_with_conv_op.cu:55-110):
    ``[log(show+1), log(clk+1), log(conv+1) - log(clk+1), rest]``;
    ``show_filter`` drops the show column; without ``use_cvm`` the three
    counters are stripped."""
    if not use_cvm:
        return pooled[..., 3:]
    log_show = torch.log(pooled[..., 0:1] + 1.0)
    log_clk = torch.log(pooled[..., 1:2] + 1.0)
    log_conv = torch.log(pooled[..., 2:3] + 1.0)
    cols = [log_show, log_clk, log_conv - log_clk, pooled[..., 3:]]
    if show_filter:
        cols = cols[1:]
    return torch.cat(cols, dim=-1)


def cvm_with_pcoc_transform(
    pooled: torch.Tensor, pclk_num: int = 3, use_cvm: bool = True
) -> torch.Tensor:
    """CVM for PCOC layouts [show, clk, join_show, join_clk, pclk * p, ...]
    (FusedCVMWithPCOCKernelWithCVM, fused_seqpool_cvm_with_pcoc_op.cu:120-155):
    ``[log(show+1), log(clk+1) - log(show+1), log(pclk+1) - log(join_show+1),
    log(pclk+1) - log(join_clk+1), rest]``; without ``use_cvm`` the 4 + p
    counters are stripped."""
    cvm_in = 4 + pclk_num
    if not use_cvm:
        return pooled[..., cvm_in:]
    log_show = torch.log(pooled[..., 0:1] + 1.0)
    log_clk = torch.log(pooled[..., 1:2] + 1.0)
    log_jshow = torch.log(pooled[..., 2:3] + 1.0)
    log_jclk = torch.log(pooled[..., 3:4] + 1.0)
    log_pclk = torch.log(pooled[..., 4:cvm_in] + 1.0)
    return torch.cat(
        [log_show, log_clk - log_show, log_pclk - log_jshow, log_pclk - log_jclk, pooled[..., cvm_in:]],
        dim=-1,
    )


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
    threshold,  # float, or a per-slot [num_slots] vector (the diff_thres variant)
    quant_ratio: Optional[int],
    cvm_cols: int = 2,
    presorted: bool = True,
) -> torch.Tensor:
    """Filter/quant at key level, then segment-sum.
    Returns [num_slots, batch, width]. With ``presorted`` False the keys
    are first sorted stably by segment."""
    vals = records
    zero = torch.zeros((), dtype=vals.dtype, device=vals.device)
    if need_filter:
        score = (vals[:, 0] - vals[:, 1]) * show_coeff + vals[:, 1] * clk_coeff
        thr = torch.as_tensor(threshold, dtype=torch.float32, device=vals.device)
        if thr.dim() == 1:  # the key's slot's threshold
            slot_of_key = torch.clamp(segments // batch_size, max=num_slots - 1).long()
            thr = thr[slot_of_key]
        keep = score >= thr
        vals = torch.where(keep[:, None], vals, zero)
    if quant_ratio:
        q = float(quant_ratio)
        head = vals[:, :cvm_cols]
        tail = torch.round(vals[:, cvm_cols:] * q) / q
        vals = torch.cat([head, tail], dim=1)
    if not presorted:
        order = torch.argsort(segments, stable=True)
        vals, segments = vals[order], segments[order]

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


def sum_pool(
    records: torch.Tensor, segments: torch.Tensor, num_slots: int, batch_size: int
) -> torch.Tensor:
    """Plain sum-pool by (slot, instance) -> [num_slots, batch, width]; the
    trash segment of the pads is dropped. ``segments`` non-decreasing."""
    return _seqpool(records, segments, num_slots, batch_size, 0.0, False, 0.0, 0.0, 0.0, None)


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


def fused_seqpool_cvm_with_diff_thres(
    records: torch.Tensor,
    segments: torch.Tensor,  # int32 [L], any order
    num_slots: int,
    batch_size: int,
    threshold_vec,  # [num_slots] per-slot filter thresholds
    use_cvm: bool = True,
    pad_value: float = 0.0,
    show_coeff: float = 0.2,
    clk_coeff: float = 1.0,
    quant_ratio: Optional[int] = None,
    clk_filter: bool = False,
) -> torch.Tensor:
    """Per-slot-threshold variant (fused_seqpool_cvm_with_diff_thres_op.cu):
    :func:`fused_seqpool_cvm` with the key filter on, each key held to its
    slot's threshold -> [batch, num_slots, out_width]."""
    pooled = _seqpool(
        records, segments, num_slots, batch_size, pad_value,
        True, show_coeff, clk_coeff, threshold_vec, quant_ratio, presorted=False,
    )
    out = cvm_transform(pooled, use_cvm=use_cvm)
    if use_cvm and clk_filter:
        out = torch.cat([out[..., 0:1], out[..., 2:]], dim=-1)
    return out.permute(1, 0, 2)


def fused_seqpool_cvm_with_conv(
    records: torch.Tensor,  # [L, width] CONV layout: [show, clk, conv, embedx...]
    segments: torch.Tensor,  # int32 [L], any order
    num_slots: int,
    batch_size: int,
    use_cvm: bool = True,
    pad_value: float = 0.0,
    show_filter: bool = False,
) -> torch.Tensor:
    """CONV (q-value) variant -> [batch, num_slots, out_width]
    (fused_seqpool_cvm_with_conv_op.cu; cvm_offset 4, box_wrapper.h:526)."""
    pooled = _seqpool(
        records, segments, num_slots, batch_size, pad_value,
        False, 0.0, 0.0, 0.0, None, cvm_cols=3, presorted=False,
    )
    out = cvm_with_conv_transform(pooled, use_cvm=use_cvm, show_filter=show_filter)
    return out.permute(1, 0, 2)


def fused_seqpool_cvm_with_pcoc(
    records: torch.Tensor,  # [L, width] PCOC layout (4 + pclk_num counters)
    segments: torch.Tensor,  # int32 [L], any order
    num_slots: int,
    batch_size: int,
    pclk_num: int = 3,
    use_cvm: bool = True,
    pad_value: float = 0.0,
    quant_ratio: Optional[int] = None,
) -> torch.Tensor:
    """PCOC variant -> [batch, num_slots, out_width]
    (fused_seqpool_cvm_with_pcoc_op.cu; box_wrapper.h:524)."""
    pooled = _seqpool(
        records, segments, num_slots, batch_size, pad_value,
        False, 0.0, 0.0, 0.0, quant_ratio, cvm_cols=4 + pclk_num, presorted=False,
    )
    out = cvm_with_pcoc_transform(pooled, pclk_num=pclk_num, use_cvm=use_cvm)
    return out.permute(1, 0, 2)
