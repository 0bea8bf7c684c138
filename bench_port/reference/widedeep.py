"""Wide & Deep (Cheng et al., DLRS 2016, arXiv:1606.07792), plain float32.

Input: the CVM'd slot records [B, S, 3 + D] and the dense features
[B, Dd]. The logit is ``b + wide + deep (+ the dense slot's linear)``:

- wide: embed_w summed over the slots, and a linear over the dense slot
  (the port's wide part; the paper's cross-product transforms are not
  modelled);
- deep: a ReLU tower over the flattened records and the dense features,
  then a linear head.
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
        out += [("wide_dense.weight", (1, cfg["dense_dim"])), ("wide_dense.bias", (1,))]
    return out


def forward(params: Dict[str, torch.Tensor], feats: torch.Tensor, dense, linear=fp32_linear) -> torch.Tensor:
    B = feats.shape[0]
    wide = feats[:, :, 2].sum(dim=1)
    x = feats.reshape(B, -1)
    if dense is not None:
        x = torch.cat([x, dense], dim=1)
    h = mlp(params, x, sum(1 for k in params if k.startswith("mlp.") and k.endswith(".weight")), linear)
    logit = params["b"] + wide + fp32_linear(h, params["out.weight"], params["out.bias"])[:, 0]
    if dense is not None:
        logit = logit + fp32_linear(dense, params["wide_dense.weight"], params["wide_dense.bias"])[:, 0]
    return logit


def tower_flops_per_sample(cfg: dict) -> int:
    """Forward and backward FLOPs of the tower and head a sample (6 a weight)."""
    dims = [cfg["num_slots"] * (3 + cfg["embedx_dim"]) + cfg["dense_dim"], *cfg["hidden"], 1]
    return 6 * sum(a * b for a, b in zip(dims, dims[1:]))
