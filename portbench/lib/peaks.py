"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
without sparsity, at its 700 W limit)."""

BF16_FLOP_PER_S = 989e12        # tensor cores, bf16 / fp16
HBM_BYTES_PER_S = 3.35e12       # 80 GB HBM3
