"""DeepFM — the flagship model, as an ``nn.Module``.

Port of the JAX package's ``models/deepfm.py``. Consumes pooled slot
records [B, S, F] with F = cvm_offset + embedx_dim:

- first order: the embed_w column summed over slots (the pulled LR weight)
- FM second order over the embedx block: 0.5 * ((Σ_s v)² − Σ_s v²)
- deep tower: MLP over [flattened slot feats ; dense floats]

Parameters (``state_dict`` keys): ``mlp.{i}.weight`` [out, in],
``mlp.{i}.bias``, ``out.weight`` [1, hidden[-1]], ``out.bias``, ``b`` (a
scalar) and, with ``dense_dim``, ``dense_lin.weight`` / ``dense_lin.bias``.
``models/convert.py`` maps the JAX package's params onto these names.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from paddlebox_tpu_torch.models.layers import linear_apply, linear_init, mlp_apply, mlp_init


class DeepFM(nn.Module):
    def __init__(
        self,
        num_slots: int,
        feat_width: int,
        embedx_dim: int,
        dense_dim: int = 0,
        hidden: Sequence[int] = (512, 256, 128),
        embed_w_col: int = 2,
        *,
        generator: torch.Generator,
    ):
        """Parameters are drawn on the CPU from ``generator`` (a CPU
        ``torch.Generator``); move the module with ``.to(device)``."""
        super().__init__()
        self.num_slots = num_slots
        self.feat_width = feat_width
        self.embedx_dim = embedx_dim
        self.dense_dim = dense_dim
        self.hidden = tuple(hidden)
        self.embed_w_col = embed_w_col
        in_dim = num_slots * feat_width + dense_dim
        self.mlp = mlp_init(in_dim, self.hidden, generator)
        self.out = linear_init(self.hidden[-1], 1, generator)
        self.b = nn.Parameter(torch.zeros((), dtype=torch.float32))
        self.dense_lin = linear_init(dense_dim, 1, generator) if dense_dim else None

    def forward(self, slot_feats: torch.Tensor, dense: Optional[torch.Tensor] = None) -> torch.Tensor:
        B = slot_feats.shape[0]
        co = self.feat_width - self.embedx_dim
        first = torch.sum(slot_feats[:, :, self.embed_w_col], dim=1)  # [B]

        v = slot_feats[:, :, co:]  # [B, S, D] embedx block
        sum_v = torch.sum(v, dim=1)
        fm = 0.5 * torch.sum(sum_v * sum_v - torch.sum(v * v, dim=1), dim=1)  # [B]

        deep_in = slot_feats.reshape(B, -1)
        if self.dense_dim and dense is not None:
            deep_in = torch.cat([deep_in, dense], dim=1)
        h = mlp_apply(self.mlp, deep_in, final_activation=True)
        deep = linear_apply(self.out, h)[:, 0]

        logit = self.b + first + fm + deep
        if self.dense_dim and dense is not None:
            logit = logit + linear_apply(self.dense_lin, dense)[:, 0]
        return logit
