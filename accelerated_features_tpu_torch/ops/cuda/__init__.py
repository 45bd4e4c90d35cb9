"""Wrappers of the hand-written CUDA kernels in `csrc/`. Each launches its
kernel on CUDA tensors, runs its plain torch version on CPU tensors, and
counts its launches in `<wrapper>.launches`. Kernels A, B, C, E and F have
no backward: on CUDA tensors their wrappers raise when grad mode is on and an
input requires grad. Kernel D (attention) has one, a kernel of its own
(`attention.attention_backward`)."""
