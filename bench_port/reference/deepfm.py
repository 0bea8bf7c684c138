"""DeepFM (Guo et al., IJCAI 2017, arXiv:1703.04247), plain float32.

Input: the CVM'd slot records [B, S, 3 + D] = [log show, log ctr,
embed_w, embedx[D]]. The logit is ``b + first + fm + deep``:

- first order: embed_w summed over the slots;
- FM: ``0.5 * sum_d((sum_s v)^2 - sum_s v^2)`` over the embedx block;
- deep: a ReLU tower over the flattened records, then a linear head.

As the port runs it, the tower's input is every column of every slot's
record, and the tower has no dropout (the paper's 0.5 is left out).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from bench_port.reference.common import fp32_linear, mlp


def param_shapes(cfg: dict) -> List[Tuple[str, tuple]]:
    """The dense params' names and shapes, in the order weights are drawn."""
    dims = [cfg["num_slots"] * (3 + cfg["embedx_dim"]) + cfg["dense_dim"], *cfg["hidden"]]
    out = []
    for i in range(len(cfg["hidden"])):
        out += [(f"mlp.{i}.weight", (dims[i + 1], dims[i])), (f"mlp.{i}.bias", (dims[i + 1],))]
    out += [("out.weight", (1, dims[-1])), ("out.bias", (1,)), ("b", ())]
    if cfg["dense_dim"]:
        out += [("dense_lin.weight", (1, cfg["dense_dim"])), ("dense_lin.bias", (1,))]
    return out


def forward(params: Dict[str, torch.Tensor], feats: torch.Tensor, dense, linear=fp32_linear) -> torch.Tensor:
    B = feats.shape[0]
    first = feats[:, :, 2].sum(dim=1)
    v = feats[:, :, 3:]
    sum_v = v.sum(dim=1)
    fm = 0.5 * (sum_v * sum_v - (v * v).sum(dim=1)).sum(dim=1)
    x = feats.reshape(B, -1)
    if dense is not None:
        x = torch.cat([x, dense], dim=1)
    h = mlp(params, x, sum(1 for k in params if k.startswith("mlp.") and k.endswith(".weight")), linear)
    logit = params["b"] + first + fm + fp32_linear(h, params["out.weight"], params["out.bias"])[:, 0]
    if dense is not None:
        logit = logit + fp32_linear(dense, params["dense_lin.weight"], params["dense_lin.bias"])[:, 0]
    return logit


def tower_flops_per_sample(cfg: dict) -> int:
    """Forward and backward FLOPs of the tower and head a sample: 2 a
    multiply-add forward, 4 backward (the input's gradient and the
    weight's), so 6 a weight."""
    dims = [cfg["num_slots"] * (3 + cfg["embedx_dim"]) + cfg["dense_dim"], *cfg["hidden"], 1]
    return 6 * sum(a * b for a, b in zip(dims, dims[1:]))
