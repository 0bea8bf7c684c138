"""Sparse optimizer semantics for the embedding table.

The reference's sparse optimizers live inside the closed libbox_ps.so /
libps.so; the observable contract (value layouts B3, lr_map plumbing
box_wrapper.cc:1234-1241, pslib public accessor configs) is re-derived here:

- per-key scalar AdaGrad on embed_w: g2sum accumulates the squared grad;
  step size = lr * sqrt(initial_g2sum / (initial_g2sum + g2sum))
  (pslib "sparse adagrad" shape: step decays with accumulated energy)
- per-key scalar AdaGrad on the embedx vector, with the *mean* squared grad
  accumulated so one g2 scalar serves the whole vector (keeps table width
  D+cvm+2, matching the single embedx_g2sum in pslib value accessors)
- embedx is gated: inactive until the key's show count reaches
  ``embedx_threshold`` (pslib embedx_threshold; observable in PullCopy's
  ``embedding_size > 0`` branch, box_wrapper.cu:54-63)
- show/clk counters: push adds per-key occurrence counts and click counts;
  pass-boundary decay show *= decay, clk *= decay (pslib show_click_decay_rate)
- slot-wise learning-rate map: slot id -> lr multiplier
  (initialize_gpu_and_load_model lr_map, box_wrapper.cc:1234-1241)

All of this runs inside the train step as vectorized column math on the
pass working-set tensor on the device, in place of the PS-side optimizer.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional


@dataclass(frozen=True)
class SparseOptimizerConfig:
    embed_lr: float = 0.05
    embedx_lr: float = 0.05
    initial_g2sum: float = 3.0
    initial_range: float = 1e-4  # embed_w / embedx init uniform(-r, r)
    embedx_threshold: float = 10.0  # show count gating embedx activity
    show_clk_decay: float = 0.98  # per-pass decay on counters
    shrink_threshold: float = 1.0  # drop keys whose decayed show falls below
    weight_bounds: float = 10.0  # |w| clip after update (pslib weight_bounds)
    slot_lr_map: Optional[Dict[int, float]] = None  # slot -> lr multiplier

    def lr_for_slot(self, slot: int) -> float:
        if self.slot_lr_map is None:
            return 1.0
        return self.slot_lr_map.get(slot, 1.0)
