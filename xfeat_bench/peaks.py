"""Peaks of one NVIDIA H100 SXM at its 700 W limit, from NVIDIA's data
sheet (dense, without sparsity). The port multiplies float32 operands; the
highest rate at which this card can do so is the TF32 tensor-core rate,
so no float32-grade implementation reads above it."""

TF32_FLOPS = 495e12      # dense TF32 tensor-core FLOP/s
HBM_BYTES = 3.35e12      # device memory bytes/s
