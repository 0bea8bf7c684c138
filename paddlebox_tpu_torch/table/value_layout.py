"""Feature value layouts.

Parity with the reference's FeaturePullValueGpu/FeaturePushValueGpu template
grid (box_wrapper.cc:400-530 dispatches over embedx_dim × expand_dim ×
feature_type; the struct fields are visible through the copy kernels in
box_wrapper.cu:31-140: [show, clk, embed_w, embedx...] with
cvm_offset selecting how many leading floats flow to the model):

- PLAIN / QUANT / SHOW_CLK : cvm_offset 3  (show, clk, embed_w)
- CONV ("q value")         : cvm_offset 4  (box_wrapper.h:526)
- PCOC                     : cvm_offset 8  (box_wrapper.h:524)
- SHARE_EMBEDDING          : cvm_offset expand_embed_dim + 2 (box_wrapper.h:521)

Here the layout is a plain column map over one fp32 row per key, shared by
the host store and the device pass table:

    [show, clk, cvm_extra..., embed_w, embedx[D], embed_g2, embedx_g2]

The *pull* slice the model sees is the first ``cvm_offset + D`` columns
(hidden = cvm_offset + embedx_dim, matching CheckEmbedSizeIsValid,
box_wrapper.cc:442). Optimizer state (g2 sums) trails and never leaves the
table.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass


class FeatureType(enum.Enum):
    PLAIN = "plain"
    QUANT = "quant"
    SHOW_CLK = "show_clk"
    CONV = "conv"
    PCOC = "pcoc"
    SHARE_EMBEDDING = "share_embedding"
    # var-dim embeddings (box_wrapper.cc:419-437 selects a VARIABLE layout;
    # the per-key dim policy lives in the closed lib). Open re-expression:
    # a key's effective embedx dim unlocks in quarters as its show count
    # crosses doubling thresholds — embedx_threshold*1/2/4/8 for
    # 1/4, 1/2, 3/4, full dim — so cold keys spend HBM bandwidth on short
    # vectors and hot keys get the full embedding. Same row width; the
    # masking happens in the pull (ops/pull_push.py).
    VARIABLE = "variable"


_CVM_OFFSET = {
    FeatureType.PLAIN: 3,
    FeatureType.QUANT: 3,
    FeatureType.SHOW_CLK: 3,
    FeatureType.CONV: 4,
    FeatureType.PCOC: 8,
    FeatureType.VARIABLE: 3,
}

# embedx dims the reference compiles kernels for (box_wrapper.cc:444-457);
# informative only — any D works here: the ops take the width from the tensor.
REFERENCE_EMBEDX_DIMS = (0, 8, 16, 32, 64, 128, 256, 280)
REFERENCE_EXPAND_DIMS = (0, 8, 64)


@dataclass(frozen=True)
class ValueLayout:
    embedx_dim: int = 8
    expand_embed_dim: int = 0
    feature_type: FeatureType = FeatureType.PLAIN

    @property
    def cvm_offset(self) -> int:
        if self.feature_type == FeatureType.SHARE_EMBEDDING:
            return self.expand_embed_dim + 2
        return _CVM_OFFSET[self.feature_type]

    # --- column indices ---
    SHOW = 0
    CLK = 1

    @property
    def embed_w_col(self) -> int:
        # embed_w is the last of the cvm block (after show/clk and any
        # conv/pcoc extras)
        return self.cvm_offset - 1

    @property
    def embedx_col(self) -> int:
        return self.cvm_offset

    @property
    def expand_col(self) -> int:
        """First column of the expand-embedding block (B12 extended pull:
        pull_box_extended_sparse returns (emb, expand_emb) per slot). Empty
        unless expand_embed_dim > 0 with a non-SHARE_EMBEDDING type —
        SHARE_EMBEDDING folds its expand dims into the cvm block instead."""
        return self.cvm_offset + self.embedx_dim

    @property
    def expand_dim(self) -> int:
        if self.feature_type == FeatureType.SHARE_EMBEDDING:
            return 0
        return self.expand_embed_dim

    @property
    def embed_g2_col(self) -> int:
        return self.cvm_offset + self.embedx_dim + self.expand_dim

    @property
    def embedx_g2_col(self) -> int:
        return self.embed_g2_col + 1

    @property
    def expand_g2_col(self) -> int:
        if self.expand_dim == 0:
            raise ValueError("layout has no expand block")
        return self.embed_g2_col + 2

    @property
    def width(self) -> int:
        """Total fp32 columns per key in the table (incl. optimizer state)."""
        return (
            self.cvm_offset
            + self.embedx_dim
            + self.expand_dim
            + 2
            + (1 if self.expand_dim else 0)
        )

    @property
    def pull_width(self) -> int:
        """Columns the model sees per key (= hidden size of pull tensors)."""
        return self.cvm_offset + self.embedx_dim

    @property
    def push_width(self) -> int:
        """Per-key push record: [show, clk, grads for cvm-extras+embed_w+embedx].

        Mirrors FeaturePushValueGpu (show, clk, embed_g, embedx_g[D]).
        """
        return self.cvm_offset + self.embedx_dim

    @property
    def extended_push_width(self) -> int:
        """Extended push record: push_width + expand grads appended
        (FeaturePushValueGpu expand variants, box_wrapper.cc:466-530)."""
        return self.push_width + self.expand_dim
