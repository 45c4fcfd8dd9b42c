"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the full 700 W): float32 outside the tensor cores, as the encoders
run with TF32 off, and HBM3 bandwidth."""

FLOAT32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
