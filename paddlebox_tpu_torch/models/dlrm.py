"""DLRM with a DCNv2 low-rank cross network (MLPerf Training's
recommendation model), as an ``nn.Module``.

Sources: the MLCommons reference (``recommendation_v2/torchrec_dlrm``),
DCN-V2 (Wang et al., WWW 2021, arXiv:2008.13535) and DLRM (Naumov et al.,
arXiv:1906.00091). The JAX package has no counterpart. The zoo's contract:
``model(slot_feats [B, S, F], dense [B, Dd]) -> logits [B]``, where each
slot's feature is its sum-pooled, CVM'd records:

- the embedding of a slot is the last ``embedx_dim`` columns of its
  feature (show, clk and embed_w stay in the table's layout and are not
  read);
- bottom: a ReLU MLP over the dense features, its last width
  ``embedx_dim`` (``dlrm.bottom``);
- interaction: ``x0 = [bottom output; the S embeddings]``, (S + 1) x D
  wide, then the low-rank cross layers ``x_{l+1} = x0 * (W_l (V_l x_l) +
  b_l) + x_l`` (``dlrm.cross``, its backward ``dlrm.cross.bwd``). The two
  products of a layer run in the tower's compute dtype (bf16 operands,
  fp32 accumulation) by :func:`layers.product`; ``x_l`` and the
  elementwise update stay fp32;
- top: a ReLU MLP, then a linear 1-wide head in fp32 (``dlrm.top``).

Parameters (``state_dict`` keys): ``bottom.{i}.weight`` / ``.bias``,
``cross.{l}.V.weight`` [rank, d] (no bias), ``cross.{l}.W.weight`` [d,
rank], ``cross.{l}.W.bias`` [d], ``top.{i}.*`` and ``out.*``.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from paddlebox_tpu_torch.models.layers import linear_apply, linear_init, mlp_apply, mlp_init, product
from paddlebox_tpu_torch.utils.trace import record_event, span_with_backward


class LowRankCross(nn.Module):
    """The parameters of one DCNv2 cross layer of rank ``rank`` over
    ``dim`` features; :func:`cross_apply` runs the layers."""

    def __init__(self, dim: int, rank: int, generator: torch.Generator):
        super().__init__()
        self.V = linear_init(dim, rank, generator, bias=False)
        self.W = linear_init(rank, dim, generator)


def cross_apply(x0: torch.Tensor, *weights: torch.Tensor, compute_dtype: torch.dtype = torch.bfloat16):
    """The cross layers over ``x0`` [B, d] fp32; ``weights`` are each
    layer's (V, W, b) in turn. Returns the last ``x_l``, fp32."""
    x = x0
    for i in range(0, len(weights), 3):
        v, w, b = weights[i : i + 3]
        u = product(x, v, compute_dtype)  # [B, rank]
        x = torch.addcmul(x, x0, b + product(u, w, compute_dtype))
    return x


class DLRM(nn.Module):
    def __init__(
        self,
        num_slots: int,
        feat_width: int,
        embedx_dim: int,
        dense_dim: int,
        bottom: Sequence[int] = (512, 256, 128),
        cross_layers: int = 3,
        cross_rank: int = 512,
        top: Sequence[int] = (1024, 1024, 512, 256),
        *,
        generator: torch.Generator,
    ):
        """Parameters are drawn on the CPU from ``generator``: Xavier-normal
        weights, zero biases."""
        super().__init__()
        if bottom[-1] != embedx_dim:
            raise ValueError(f"the bottom MLP ends at {bottom[-1]}, the embeddings are {embedx_dim} wide")
        self.num_slots = num_slots
        self.feat_width = feat_width
        self.embedx_dim = embedx_dim
        self.dense_dim = dense_dim
        d = (num_slots + 1) * embedx_dim
        self.bottom = mlp_init(dense_dim, tuple(bottom), generator)
        self.cross = nn.ModuleList(LowRankCross(d, cross_rank, generator) for _ in range(cross_layers))
        self.top = mlp_init(d, tuple(top), generator)
        self.out = linear_init(top[-1], 1, generator)

    def forward(self, slot_feats: torch.Tensor, dense: torch.Tensor) -> torch.Tensor:
        if dense is None:
            raise ValueError("DLRM needs the dense features")
        B = slot_feats.shape[0]
        with record_event("dlrm.bottom", "model"):
            d = mlp_apply(self.bottom, dense, final_activation=True)
        emb = slot_feats[:, :, self.feat_width - self.embedx_dim :]
        x0 = torch.cat([d, emb.reshape(B, -1)], dim=1)
        weights = [t for c in self.cross for t in (c.V.weight, c.W.weight, c.W.bias)]
        x = span_with_backward("dlrm.cross", cross_apply, x0, *weights)
        with record_event("dlrm.top", "model"):
            h = mlp_apply(self.top, x, final_activation=True)
            return linear_apply(self.out, h)[:, 0]
