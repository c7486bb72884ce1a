"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at its 700 W power limit).  A card set below 700 W runs slower
under load: the run prints the card's limit beside every share."""

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12          # outside the tensor cores
TF32_FLOPS_PER_S = 495e12
BF16_FLOPS_PER_S = 989e12
HBM_BYTES = 80e9
