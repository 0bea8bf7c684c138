"""MMoE: multi-gate mixture-of-experts for multi-task CTR, as an
``nn.Module``.

Port of the JAX package's ``models/mmoe.py``. The experts are stacked:
each depth is one ``[E, in, h]`` weight and one ``[E, h]`` bias, applied
to every expert in one batched fp32 product (``torch.bmm``), as the JAX
package computes them. Per-task softmax gates mix the expert outputs and
a bf16 tower per task gives its logit.

``forward`` returns [B, n_tasks] logits; :func:`task_head` wraps the
model as the scalar-logit model the train step wants.

Parameters (``state_dict`` keys): ``experts.{l}.w`` [E, in, h] /
``experts.{l}.b`` [E, h], ``gates.{t}.weight`` [E, in] / ``.bias``,
``towers.{t}.mlp.{i}.*`` and ``towers.{t}.out.*``; ``models/convert.py``
maps the JAX package's ``{"experts", "gates", "towers"}`` onto them.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from paddlebox_tpu_torch.models.layers import linear_apply, linear_init, mlp_apply, mlp_init


class ExpertLayer(nn.Module):
    """One depth of the stacked experts: ``w`` [E, in, out], ``b`` [E, out]
    (the JAX package's layout, not transposed)."""

    def __init__(self, n_experts: int, in_dim: int, out_dim: int, generator: torch.Generator):
        super().__init__()
        # each expert's layer as linear_init draws it
        w = [linear_init(in_dim, out_dim, generator).weight.detach().t() for _ in range(n_experts)]
        self.w = nn.Parameter(torch.stack(w).contiguous())
        self.b = nn.Parameter(torch.zeros((n_experts, out_dim), dtype=torch.float32))


class Tower(nn.Module):
    def __init__(self, in_dim: int, hidden: Sequence[int], generator: torch.Generator):
        super().__init__()
        self.mlp = mlp_init(in_dim, hidden, generator)
        self.out = linear_init(hidden[-1], 1, generator)


class MMoE(nn.Module):
    def __init__(
        self,
        num_slots: int,
        feat_width: int,
        dense_dim: int = 0,
        n_experts: int = 4,
        n_tasks: int = 2,
        expert_hidden: Sequence[int] = (128, 64),
        tower_hidden: Sequence[int] = (32,),
        *,
        generator: torch.Generator,
    ):
        """Parameters are drawn on the CPU from ``generator``."""
        super().__init__()
        self.num_slots = num_slots
        self.feat_width = feat_width
        self.dense_dim = dense_dim
        self.n_experts = n_experts
        self.n_tasks = n_tasks
        self.expert_hidden = tuple(expert_hidden)
        self.tower_hidden = tuple(tower_hidden)
        self.in_dim = num_slots * feat_width + dense_dim
        dims = [self.in_dim, *self.expert_hidden]
        self.experts = nn.ModuleList(
            ExpertLayer(n_experts, dims[l], dims[l + 1], generator) for l in range(len(self.expert_hidden))
        )
        self.gates = nn.ModuleList(linear_init(self.in_dim, n_experts, generator) for _ in range(n_tasks))
        self.towers = nn.ModuleList(
            Tower(self.expert_hidden[-1], self.tower_hidden, generator) for _ in range(n_tasks)
        )

    def forward(self, slot_feats: torch.Tensor, dense: Optional[torch.Tensor] = None) -> torch.Tensor:
        B = slot_feats.shape[0]
        x = slot_feats.reshape(B, -1)
        if self.dense_dim and dense is not None:
            x = torch.cat([x, dense], dim=1)
        # every expert in one batched product a depth: h [E, B, h_l]
        h = x.unsqueeze(0).expand(self.n_experts, B, x.shape[1])
        for layer in self.experts:
            h = torch.relu(torch.bmm(h, layer.w) + layer.b[:, None])
        expert_out = h.permute(1, 0, 2)  # [B, E, h]
        logits = []
        for gate, tower in zip(self.gates, self.towers):
            g = torch.softmax(linear_apply(gate, x), dim=-1)  # [B, E]
            mixed = torch.einsum("be,beh->bh", g, expert_out)
            ht = mlp_apply(tower.mlp, mixed, final_activation=True)
            logits.append(linear_apply(tower.out, ht)[:, 0])
        return torch.stack(logits, dim=1)  # [B, n_tasks]


class TaskHead(nn.Module):
    """One task's scalar logit of an MMoE. Its parameters are the MMoE's
    own under the MMoE's names (the JAX ``task_head`` shares the MMoE's
    params tree), so a ``functional_call`` over them reaches the MMoE."""

    def __init__(self, model: MMoE, task: int):
        super().__init__()
        for name, child in model.named_children():
            self.add_module(name, child)
        object.__setattr__(self, "mmoe", model)  # not a submodule: its children are ours
        self.task = task
        self.num_slots, self.feat_width, self.dense_dim = model.num_slots, model.feat_width, model.dense_dim

    def forward(self, slot_feats: torch.Tensor, dense: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.mmoe(slot_feats, dense)[:, self.task]


def task_head(model: MMoE, task: int) -> TaskHead:
    """Scalar-logit view of one task for the CTR train step."""
    return TaskHead(model, task)
