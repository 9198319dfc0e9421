"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
no sparsity), at its full 700 W power limit. A share of a peak is stated
with the card's own ``power.limit`` beside it."""

#: bf16 / fp16 tensor-core operations a second
BF16_FLOPS = 989e12
#: HBM3 bytes a second
HBM_BYTES = 3.35e12
