"""Wrappers of the hand-written CUDA kernels in `csrc/`. Each launches its
kernel on CUDA tensors, runs its plain torch version on CPU tensors, and
counts its launches in `<wrapper>.launches`. The kernels have no backward:
on CUDA tensors a wrapper raises when grad mode is on and an input
requires grad."""
