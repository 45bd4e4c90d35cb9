"""Products in the precision a reference call asks for.

`full` is float32 with TF32 off: the precision both configurations state.
`tf32` is the control's: every operand of a product rounded to TF32 (10
mantissa bits, round to nearest, ties away from zero, as the tensor cores
take float32 inputs), the sums in float32. The rounding is done here, so
the control reads the same on a CPU as on the card.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import torch
import torch.nn.functional as F

PRECISIONS = ("full", "tf32")


@contextlib.contextmanager
def tf32_off() -> Iterator[None]:
    """Turn TF32 off in cuBLAS and cuDNN for the block, restoring the
    caller's flags after it."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> float32 holding the nearest TF32 value (the 13 low
    mantissa bits cleared after adding half of them)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class Products:
    """Convolutions and matrix products at one precision."""

    def __init__(self, precision: str = "full"):
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, "
                             f"got {precision!r}")
        self.precision = precision

    def _r(self, x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        if x is None or self.precision == "full":
            return x
        return round_tf32(x)

    def conv2d(self, x, w, b=None, stride=1, padding=0):
        with tf32_off():
            return F.conv2d(self._r(x), self._r(w), b, stride=stride,
                            padding=padding)

    def linear(self, x, w, b=None):
        """x (..., in) @ w (in, out) + b."""
        with tf32_off():
            y = torch.matmul(self._r(x), self._r(w))
        return y if b is None else y + b

    def matmul(self, a, b):
        with tf32_off():
            return torch.matmul(self._r(a), self._r(b))
