from paddlebox_tpu_torch.ops.cuda_kernels import (
    pull_rows_cuda,
    pull_rows_ref,
    write_rows_cuda,
    write_rows_ref,
)
from paddlebox_tpu_torch.ops.ctr_ops import rank_attention
from paddlebox_tpu_torch.ops.pull_push import (
    embedx_active_mask,
    pull_sparse_rows,
    push_sparse_rows,
    sparse_update_rows,
)
from paddlebox_tpu_torch.ops.seqpool_cvm import cvm_transform, fused_seqpool_cvm

__all__ = [
    "pull_rows_cuda",
    "pull_rows_ref",
    "write_rows_cuda",
    "write_rows_ref",
    "embedx_active_mask",
    "pull_sparse_rows",
    "push_sparse_rows",
    "sparse_update_rows",
    "fused_seqpool_cvm",
    "cvm_transform",
    "rank_attention",
]
