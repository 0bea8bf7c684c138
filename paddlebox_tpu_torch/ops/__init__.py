from paddlebox_tpu_torch.ops.cuda_kernels import (
    pull_rows_cuda,
    pull_rows_ref,
    write_rows_cuda,
    write_rows_ref,
)
from paddlebox_tpu_torch.ops.ctr_ops import batch_fc, fused_concat, rank_attention
from paddlebox_tpu_torch.ops.pull_push import (
    embedx_active_mask,
    pull_sparse_rows,
    pull_sparse_rows_extended,
    push_sparse_rows,
    sparse_update_rows,
)
from paddlebox_tpu_torch.ops.seqpool_cvm import (
    cvm_transform,
    cvm_with_conv_transform,
    cvm_with_pcoc_transform,
    fused_seqpool_cvm,
    fused_seqpool_cvm_with_conv,
    fused_seqpool_cvm_with_diff_thres,
    fused_seqpool_cvm_with_pcoc,
)

__all__ = [
    "pull_rows_cuda",
    "pull_rows_ref",
    "write_rows_cuda",
    "write_rows_ref",
    "embedx_active_mask",
    "pull_sparse_rows",
    "pull_sparse_rows_extended",
    "push_sparse_rows",
    "sparse_update_rows",
    "fused_seqpool_cvm",
    "fused_seqpool_cvm_with_conv",
    "fused_seqpool_cvm_with_diff_thres",
    "fused_seqpool_cvm_with_pcoc",
    "cvm_transform",
    "cvm_with_conv_transform",
    "cvm_with_pcoc_transform",
    "rank_attention",
    "batch_fc",
    "fused_concat",
]
