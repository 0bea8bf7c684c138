"""Layers for the CTR dense towers.

Port of the JAX package's ``models/layers.py``. Parameters are fp32
``nn.Linear`` modules; the MLP runs its activations in bf16 (each layer's
weight and bias cast to bf16 for the matmul and the bias add, ReLU in
bf16) and returns fp32 — the JAX package's precision recipe. The matmuls
stay ``torch.matmul``: the JAX package leaves them to XLA as well.

On a CUDA input whose rows in the compute dtype are no whole number of
16-byte units (bf16: a width not a multiple of 8), a tower's product
(:func:`product`: an MLP layer's, a DLRM cross layer's) runs on operands
widened with zero columns to the next such width. cuBLAS
takes its aligned sm90 kernels for the forward and both gradients there,
where an unaligned K falls back to sm75 ``align1`` kernels at a fraction
of the speed. The sums gain only zeros, and the parameters and their
gradients keep their shapes.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn


def linear_init(
    in_dim: int, out_dim: int, generator: torch.Generator, scale: str = "xavier", bias: bool = True
) -> nn.Linear:
    """fp32 ``nn.Linear`` with N(0, s^2) weights drawn from ``generator``
    (s = sqrt(2 / (in + out)) for "xavier", else 0.01) and a zero bias
    (none without ``bias``)."""
    # skip_init: the default init would draw from the global generator
    lin = nn.utils.skip_init(nn.Linear, in_dim, out_dim, bias=bias, dtype=torch.float32, device="cpu")
    s = math.sqrt(2.0 / (in_dim + out_dim)) if scale == "xavier" else 0.01
    with torch.no_grad():
        lin.weight.copy_(
            torch.randn((out_dim, in_dim), generator=generator, dtype=torch.float32) * s
        )
        if bias:
            lin.bias.zero_()
    return lin


def linear_apply(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``x @ w + b`` in the input's dtype (fp32 on the model's head). Under
    the strategy's ``amp`` the weights arrive as bf16 while an fp32 input
    may not: the product then runs in the wider dtype, as JAX promotes
    mixed operands."""
    w = lin.weight
    if w.dtype != x.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    return torch.matmul(x, w.t()) + lin.bias


def mlp_init(in_dim: int, hidden: Sequence[int], generator: torch.Generator) -> nn.ModuleList:
    dims = [in_dim, *hidden]
    return nn.ModuleList(
        linear_init(dims[i], dims[i + 1], generator) for i in range(len(hidden))
    )


# MLP products run on K-padded operands since the process started (one a
# layer that pads), like ops/cuda_kernels.launch_counts
padded_products = 0


def aligned_width(k: int, dtype: torch.dtype) -> int:
    """``k`` rounded up to a whole number of 16-byte units of ``dtype``."""
    unit = 16 // dtype.itemsize
    return -(-k // unit) * unit


class CastPadK(torch.autograd.Function):
    """``CastPadK.apply(t, dtype, k_pad)``: ``t.to(dtype)`` written into a
    buffer ``k_pad`` wide in its last dim, the columns past ``t``'s width
    zero, in one pass over ``t``. The backward casts the gradient's first
    columns back to ``t``'s dtype, so it comes back at ``t``'s shape."""

    @staticmethod
    def forward(ctx, t: torch.Tensor, dtype: torch.dtype, k_pad: int) -> torch.Tensor:
        k = t.shape[-1]
        ctx.k, ctx.src_dtype = k, t.dtype
        out = t.new_empty((*t.shape[:-1], k_pad), dtype=dtype)
        out[..., k:].zero_()
        out[..., :k].copy_(t)
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return g[..., : ctx.k].to(ctx.src_dtype).contiguous(), None, None


def product(x: torch.Tensor, weight: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """``x @ weight.T`` on operands cast to ``compute_dtype``, out in that
    dtype. On a CUDA input whose width is unaligned in ``compute_dtype``
    both operands are K-padded (module docstring); every other product, and
    every one on the CPU, casts and multiplies as the JAX package does."""
    global padded_products
    k = x.shape[-1]
    k_pad = aligned_width(k, compute_dtype) if x.is_cuda else k
    if k_pad != k:
        x = CastPadK.apply(x, compute_dtype, k_pad)
        w = CastPadK.apply(weight, compute_dtype, k_pad)
        padded_products += 1
    else:
        x, w = x.to(compute_dtype), weight.to(compute_dtype)
    return torch.matmul(x, w.t())


def mlp_apply(
    layers: nn.ModuleList,
    x: torch.Tensor,
    final_activation: bool = False,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """ReLU MLP; activations in bf16, params fp32, fp32 out; each layer's
    product is :func:`product`'s."""
    h = x
    for i, lin in enumerate(layers):
        h = product(h, lin.weight, compute_dtype) + lin.bias.to(compute_dtype)
        if i < len(layers) - 1 or final_activation:
            h = torch.relu(h)
    return h.to(torch.float32)
