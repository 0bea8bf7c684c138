"""Layers for the CTR dense towers.

Port of the JAX package's ``models/layers.py``. Parameters are fp32
``nn.Linear`` modules; the MLP runs its activations in bf16 (each layer's
weight and bias cast to bf16 for the matmul and the bias add, ReLU in
bf16) and returns fp32 — the JAX package's precision recipe. The matmuls
stay ``torch.matmul``: the JAX package leaves them to XLA as well.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn


def linear_init(
    in_dim: int, out_dim: int, generator: torch.Generator, scale: str = "xavier"
) -> nn.Linear:
    """fp32 ``nn.Linear`` with N(0, s^2) weights drawn from ``generator``
    (s = sqrt(2 / (in + out)) for "xavier", else 0.01) and zero bias."""
    # skip_init: the default init would draw from the global generator
    lin = nn.utils.skip_init(nn.Linear, in_dim, out_dim, dtype=torch.float32, device="cpu")
    s = math.sqrt(2.0 / (in_dim + out_dim)) if scale == "xavier" else 0.01
    with torch.no_grad():
        lin.weight.copy_(
            torch.randn((out_dim, in_dim), generator=generator, dtype=torch.float32) * s
        )
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


def mlp_apply(
    layers: nn.ModuleList,
    x: torch.Tensor,
    final_activation: bool = False,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """ReLU MLP; activations in bf16, params fp32, fp32 out."""
    h = x.to(compute_dtype)
    for i, lin in enumerate(layers):
        h = torch.matmul(h, lin.weight.to(compute_dtype).t()) + lin.bias.to(compute_dtype)
        if i < len(layers) - 1 or final_activation:
            h = torch.relu(h)
    return h.to(torch.float32)
