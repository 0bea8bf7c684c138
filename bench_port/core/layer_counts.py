"""Least work of DLRM's cross network and of the multi-hot seqpool, from
their shapes, for their roofline shares.

The cross: ``layers`` low-rank layers over a [batch, dim] fp32 ``x``,
forward and backward. Its operations are 6 a weight a sample (two
products a layer, each run forward, for the input's gradient and for the
weight's); its least bytes, a layer, ``x_0``, ``x_l`` and ``x_{l+1}``
once each in fp32, the output's and the input's gradients once each, and
the layer's fp32 weights and bias once. The seqpool: forward, every
pooled key's record read and every (sample, slot) pooled row written;
backward, the pooled rows' gradients read and every key's record gradient
written; ``width`` fp32 columns each.
"""

from __future__ import annotations

from bench_port.core.peaks import BF16_FLOPS
from bench_port.core.roofline import least_s

F32 = 4


def cross_flops(batch: int, dim: int, rank: int, layers: int) -> int:
    return 6 * batch * layers * 2 * dim * rank


def cross_bytes(batch: int, dim: int, rank: int, layers: int) -> int:
    return layers * (5 * batch * dim + 2 * dim * rank + dim) * F32


def cross_least_s(batch: int, dim: int, rank: int, layers: int) -> float:
    return least_s(cross_bytes(batch, dim, rank, layers), cross_flops(batch, dim, rank, layers), BF16_FLOPS)


def seqpool_bytes(pooled_keys: int, pooled_rows: int, width: int) -> int:
    return 2 * (pooled_keys + pooled_rows) * width * F32


def seqpool_least_s(pooled_keys: int, pooled_rows: int, width: int) -> float:
    return least_s(seqpool_bytes(pooled_keys, pooled_rows, width))
