"""The port's DLRM-DCNv2 at a configuration's widths. The model is
imported with this module, so a program without it fails before set-up."""

from __future__ import annotations

import torch

from paddlebox_tpu_torch.models import DLRM


def build(cfg: dict, layout):
    return DLRM(
        cfg["num_slots"], layout.pull_width, layout.embedx_dim, cfg["dense_dim"], bottom=tuple(cfg["bottom_mlp"]),
        cross_layers=cfg["cross_layers"], cross_rank=cfg["cross_rank"], top=tuple(cfg["top_mlp"]),
        generator=torch.Generator().manual_seed(0),
    )
