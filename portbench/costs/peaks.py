"""NVIDIA H100 SXM data-sheet peaks, dense, at the 700 W power limit: the
only card the benchmark measures. Frozen copy of
``orp_tpu_torch/utils/flops.py:27-32``."""

CARD = "NVIDIA H100 80GB HBM3"
F32_FLOP_PER_S = 67e12      # f32 outside the tensor cores (132 SMs x 128 lanes x 2 x 1.98 GHz)
INT32_OP_PER_S = 16.7e12    # int32: 132 SMs x 64 INT32 lanes x 1.98 GHz
HBM_BYTES_PER_S = 3.35e12   # HBM3 bandwidth
BF16_FLOP_PER_S = 989e12    # bf16 on the tensor cores
