"""Logistic regression over slot features, the smallest CTR config, as an
``nn.Module``.

Port of the JAX package's ``models/lr.py`` (BASELINE config 1: LR on
Criteo-Kaggle). The sparse first-order weight is the table's embed_w
column of the pooled record, summed over slots; the model adds a bias and,
with ``dense_dim``, a dense linear.

Parameters (``state_dict`` keys): ``b`` (a scalar) and, with
``dense_dim``, ``dense.weight`` [1, dense_dim] / ``dense.bias``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from paddlebox_tpu_torch.models.layers import linear_apply, linear_init


class LogisticRegression(nn.Module):
    def __init__(
        self,
        num_slots: int,
        feat_width: int,
        dense_dim: int = 0,
        embed_w_col: int = 2,
        *,
        generator: torch.Generator,
    ):
        """The dense linear is drawn on the CPU from ``generator``."""
        super().__init__()
        self.num_slots = num_slots
        self.feat_width = feat_width
        self.dense_dim = dense_dim
        self.embed_w_col = embed_w_col
        self.b = nn.Parameter(torch.zeros((), dtype=torch.float32))
        self.dense = linear_init(dense_dim, 1, generator) if dense_dim else None

    def forward(self, slot_feats: torch.Tensor, dense: Optional[torch.Tensor] = None) -> torch.Tensor:
        logit = torch.sum(slot_feats[:, :, self.embed_w_col], dim=1) + self.b
        if self.dense_dim and dense is not None:
            logit = logit + linear_apply(self.dense, dense)[:, 0]
        return logit
