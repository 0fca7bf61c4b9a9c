"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the part's full 700 W power limit)."""

BF16_FLOPS = 989e12  # dense bfloat16 tensor-core FLOP/s
HBM_BYTES_PER_S = 3.35e12  # HBM3 bytes/s
