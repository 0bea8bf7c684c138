"""The port's Wide&Deep at a configuration's widths."""

from __future__ import annotations

import torch


def build(cfg: dict, layout):
    from paddlebox_tpu_torch.models import WideDeep

    return WideDeep(
        cfg["num_slots"], layout.pull_width, dense_dim=cfg["dense_dim"], hidden=tuple(cfg["hidden"]),
        generator=torch.Generator().manual_seed(0),
    )
