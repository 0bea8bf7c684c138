"""Join-phase rank model: a base CTR tower + rank_attention over the pv rank
matrix, as an ``nn.Module``.

Port of the JAX package's ``models/rank.py``. The reference's join phase
feeds pv-merged batches whose ``rank_offset`` encodes each ad's rank and
its peers' positions; RankAttention mixes features across the pv before
the final logit (box_wrapper.h RankAttention + rank_attention_op.cu).

Parameters (``state_dict`` keys): the base module's under ``base.*`` and
``rank_param`` [max_rank * max_rank * in_dim, 1]; ``models/convert.py``
maps the JAX package's ``{"base": ..., "rank_param": ...}`` onto them.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from paddlebox_tpu_torch.ops.ctr_ops import rank_attention


class RankDeepFM(nn.Module):
    """Base model + rank_attention tower over the pv rank matrix."""

    def __init__(self, base: nn.Module, in_dim: int, max_rank: int = 3, *, generator: torch.Generator):
        """``rank_param`` is drawn as 0.01 * N(0, 1) on the CPU from
        ``generator`` (a CPU ``torch.Generator``); move the module with
        ``.to(device)``."""
        super().__init__()
        self.base = base
        self.in_dim = in_dim
        self.max_rank = max_rank
        self.rank_param = nn.Parameter(
            0.01 * torch.randn((max_rank * max_rank * in_dim, 1), generator=generator)
        )

    def forward(
        self,
        slot_feats: torch.Tensor,
        dense: Optional[torch.Tensor] = None,
        rank_offset: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        logit = self.base(slot_feats, dense)
        if rank_offset is not None:
            x = slot_feats.reshape(slot_feats.shape[0], -1)
            logit = logit + rank_attention(x, rank_offset, self.rank_param, self.max_rank)[:, 0]
        return logit
