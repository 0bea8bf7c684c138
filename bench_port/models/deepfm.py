"""The port's DeepFM at a configuration's widths."""

from __future__ import annotations

import torch


def build(cfg: dict, layout):
    from paddlebox_tpu_torch.models import DeepFM

    return DeepFM(
        cfg["num_slots"], layout.pull_width, layout.embedx_dim, dense_dim=cfg["dense_dim"],
        hidden=tuple(cfg["hidden"]), generator=torch.Generator().manual_seed(0),
    )
