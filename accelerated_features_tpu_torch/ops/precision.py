"""Numeric precision switches shared by the backbone and the stem."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_fp32_convs():
    """Run float32 convolutions in full float32 on the card.

    cuDNN runs float32 convs in TF32 by default
    (`torch.backends.cudnn.allow_tf32` is True), which keeps ~3 decimal
    digits; the JAX reference convolves at Precision.HIGHEST, and TF32-grade
    heatmaps move NMS and top-k decisions. The flag is set for the forward
    only and restored after, so the caller's global setting is untouched."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev
