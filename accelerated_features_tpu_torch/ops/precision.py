"""Numeric precision: the switches that keep the card's convolutions and
matrix products in full float32, and the CPU emulation of the 3xTF32
tensor-core products of kernels C and D.

Both switches clear a process-global torch flag for the duration of a
call and restore the caller's value after it. Calls may overlap across
threads (a server's handlers): the flag stays off while any of them is
inside, and the value from before the first of them is restored when the
last one leaves."""

from __future__ import annotations

import contextlib
import threading

import torch

_LOCK = threading.Lock()
# (backend, flag) -> [callers inside, the value saved by the first]
_HOLDERS: dict = {}


@contextlib.contextmanager
def _flag_off(backend, flag: str):
    """Clear the boolean `backend.flag` for the call. The first caller to
    enter saves the flag's value and clears it; the last one to leave
    restores the saved value. One lock guards the count and the flag."""
    key = (id(backend), flag)
    with _LOCK:
        held = _HOLDERS.setdefault(key, [0, None])
        if held[0] == 0:
            held[1] = getattr(backend, flag)
            setattr(backend, flag, False)
        held[0] += 1
    try:
        yield
    finally:
        with _LOCK:
            held[0] -= 1
            if held[0] == 0:
                setattr(backend, flag, held[1])


def full_fp32_convs():
    """Run float32 convolutions in full float32 on the card.

    cuDNN runs float32 convs in TF32 by default
    (`torch.backends.cudnn.allow_tf32` is True), which keeps ~3 decimal
    digits; the JAX reference convolves at Precision.HIGHEST, and TF32-grade
    heatmaps move NMS and top-k decisions. The flag is set for the forward
    only and restored after, so the caller's global setting is untouched."""
    return _flag_off(torch.backends.cudnn, "allow_tf32")


def full_fp32_matmuls():
    """Run float32 matrix products in full float32 on the card.

    cuBLAS runs float32 products in TF32 when the caller turned
    `torch.backends.cuda.matmul.allow_tf32` on; the JAX reference multiplies
    at Precision.HIGHEST, and TF32-grade similarities flip mutual-argmax
    and assignment decisions. Entered once per entry point (the plain
    matcher, the LighterGlue forward, the refinement), not per product;
    usable as a decorator. `torch.set_float32_matmul_precision` is the same
    global switch by another name."""
    return _flag_off(torch.backends.cuda.matmul, "allow_tf32")


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 (10 mantissa bits), nearest with ties away
    from zero, as `cvt.rna.tf32.f32` does: integer arithmetic on the bits.
    The sign-magnitude layout makes adding half a step to the magnitude and
    clearing the 13 low bits exactly that rounding."""
    bits = x.contiguous().view(torch.int32)
    mag = ((bits & 0x7FFFFFFF) + 0x1000) & ~0x1FFF
    sign = bits & -0x80000000
    return (sign | mag).view(torch.float32)


def tf32_cut(x: torch.Tensor) -> torch.Tensor:
    """Cut float32 to TF32 by clearing the 13 low bits: what a tensor core
    reads of a float32 operand handed to it as it is."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def tf32_split(x: torch.Tensor, cut: bool = False):
    """float32 x -> (hi, lo), both TF32 values with x ~ hi + lo:
    hi = tf32(x), lo = tf32(x - hi), where x - hi is exact in float32.
    `tf32` rounds to nearest (`csrc/tf32x3.cuh: split`, kernel C) or, with
    `cut`, clears the low bits (`split_cut`, kernel D)."""
    to_tf32 = tf32_cut if cut else tf32_round
    hi = to_tf32(x)
    return hi, to_tf32(x - hi)


def tf32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with both operands rounded to TF32 once and float32
    accumulation: what a single tensor-core pass gives (~1e-3 relative)."""
    return torch.matmul(tf32_round(a), tf32_round(b))


def tf32x3_matmul(a: torch.Tensor, b: torch.Tensor,
                  cut: bool = False) -> torch.Tensor:
    """a @ b as kernels C and D compute it, emulated in plain torch: each
    float32 operand split into a TF32 head and tail (`tf32_split`), three
    products with float32 accumulation, summed small first
    (lo_a.hi_b + hi_a.lo_b, then + hi_a.hi_b). The dropped lo_a.lo_b term
    is ~2^-22 relative (2^-20 with `cut`). The products of TF32 values are
    exact in float32, as on the tensor cores; the order of the additions
    inside a product differs from the card's. Used by tests to say on the
    CPU whether 3xTF32 keeps a float32 gate."""
    a_hi, a_lo = tf32_split(a, cut)
    b_hi, b_lo = tf32_split(b, cut)
    small = torch.matmul(a_lo, b_hi) + torch.matmul(a_hi, b_lo)
    return small + torch.matmul(a_hi, b_hi)
