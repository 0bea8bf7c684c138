"""Wide&Deep and DCN (Deep & Cross Network), as ``nn.Module``s.

Port of the JAX package's ``models/wide_deep.py``. Same contract as
DeepFM: ``model(slot_feats [B, S, F], dense) -> logits [B]``.

Parameters (``state_dict`` keys):

- ``WideDeep``: ``mlp.{i}.weight`` [out, in] / ``mlp.{i}.bias``,
  ``out.weight`` / ``out.bias``, ``b`` (a scalar) and, with
  ``dense_dim``, ``wide_dense.weight`` / ``wide_dense.bias``;
- ``DCN``: ``cross_w.{l}`` and ``cross_b.{l}`` [in_dim] for each cross,
  ``mlp.{i}.*`` and ``out.*`` over ``[x, h]``.

``models/convert.py`` maps the JAX package's params onto these names.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from paddlebox_tpu_torch.models.layers import linear_apply, linear_init, mlp_apply, mlp_init


def _deep_input(slot_feats: torch.Tensor, dense: Optional[torch.Tensor], dense_dim: int) -> torch.Tensor:
    x = slot_feats.reshape(slot_feats.shape[0], -1)
    if dense_dim and dense is not None:
        x = torch.cat([x, dense], dim=1)
    return x


class WideDeep(nn.Module):
    """Wide: the embed_w sum (and a dense linear). Deep: a bf16 MLP tower."""

    def __init__(
        self,
        num_slots: int,
        feat_width: int,
        dense_dim: int = 0,
        hidden: Sequence[int] = (512, 256, 128),
        embed_w_col: int = 2,
        *,
        generator: torch.Generator,
    ):
        """Parameters are drawn on the CPU from ``generator``."""
        super().__init__()
        self.num_slots = num_slots
        self.feat_width = feat_width
        self.dense_dim = dense_dim
        self.hidden = tuple(hidden)
        self.embed_w_col = embed_w_col
        in_dim = num_slots * feat_width + dense_dim
        self.mlp = mlp_init(in_dim, self.hidden, generator)
        self.out = linear_init(self.hidden[-1], 1, generator)
        self.b = nn.Parameter(torch.zeros((), dtype=torch.float32))
        self.wide_dense = linear_init(dense_dim, 1, generator) if dense_dim else None

    def forward(self, slot_feats: torch.Tensor, dense: Optional[torch.Tensor] = None) -> torch.Tensor:
        wide = torch.sum(slot_feats[:, :, self.embed_w_col], dim=1)  # [B]
        h = mlp_apply(self.mlp, _deep_input(slot_feats, dense, self.dense_dim), final_activation=True)
        logit = self.b + wide + linear_apply(self.out, h)[:, 0]
        if self.dense_dim and dense is not None:
            logit = logit + linear_apply(self.wide_dense, dense)[:, 0]
        return logit


class DCN(nn.Module):
    """Deep & Cross: crosses x_{l+1} = x0 * (x_l . w) + b + x_l (fp32) beside
    a bf16 deep tower, one fused head over [x, h]."""

    def __init__(
        self,
        num_slots: int,
        feat_width: int,
        dense_dim: int = 0,
        n_cross: int = 3,
        hidden: Sequence[int] = (256, 128),
        *,
        generator: torch.Generator,
    ):
        """Parameters are drawn on the CPU from ``generator``: each cross
        weight N(0, 1 / in_dim), each cross bias zero."""
        super().__init__()
        self.num_slots = num_slots
        self.feat_width = feat_width
        self.dense_dim = dense_dim
        self.n_cross = n_cross
        self.hidden = tuple(hidden)
        self.in_dim = num_slots * feat_width + dense_dim
        d = self.in_dim
        self.cross_w = nn.ParameterList(
            torch.randn((d,), generator=generator, dtype=torch.float32) * d**-0.5 for _ in range(n_cross)
        )
        self.cross_b = nn.ParameterList(torch.zeros((d,), dtype=torch.float32) for _ in range(n_cross))
        self.mlp = mlp_init(d, self.hidden, generator)
        self.out = linear_init(self.hidden[-1] + d, 1, generator)

    def forward(self, slot_feats: torch.Tensor, dense: Optional[torch.Tensor] = None) -> torch.Tensor:
        x0 = _deep_input(slot_feats, dense, self.dense_dim)
        x = x0
        for w, b in zip(self.cross_w, self.cross_b):
            x = x0 * torch.matmul(x, w)[:, None] + b + x  # rank-1 cross, O(B * d)
        h = mlp_apply(self.mlp, x0, final_activation=True)
        return linear_apply(self.out, torch.cat([x, h], dim=1))[:, 0]
