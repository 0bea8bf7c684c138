"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
without sparsity), at the full 700 W power limit."""

BF16_FLOPS = 989e12  # tensor cores, bf16 in, fp32 accumulate
HBM_BYTES_PER_S = 3.35e12
