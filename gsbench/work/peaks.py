"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W power limit). The port computes in float32 outside the tensor
cores, so its rates are held to the f32 peak, not to TF32's or bf16's.
A run writes the card's power limit beside every share of these."""

PEAK_F32_OPS = 67e12      # float32 operations per second, CUDA cores
PEAK_BYTES = 3.35e12      # HBM3 bytes per second
