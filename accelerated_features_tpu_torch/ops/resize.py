"""Image preprocessing with torch `F.interpolate(align_corners=False)`
semantics (counterpart of the JAX package's `ops/resize.py`)."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def to_unit_float(x: torch.Tensor) -> torch.Tensor:
    """Integer images -> float32 / 255; float images -> float32."""
    if not torch.is_floating_point(x):
        return x.float() / 255.0
    return x.float()


def resize_bilinear(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """(B,H,W,C) -> (B,h,w,C), half-pixel bilinear without anti-aliasing
    (what `jax.image.resize(..., antialias=False)` computes)."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(out_hw),
                      mode="bilinear", align_corners=False, antialias=False)
    return y.permute(0, 2, 3, 1).contiguous()


def resize_nearest_torch(x: torch.Tensor, out_hw: Tuple[int, int]
                         ) -> torch.Tensor:
    """(B,H,W,C) -> (B,h,w,C) by torch `F.interpolate(mode='nearest')`'s
    rule: source index = floor(dst * in/out), in float32."""
    _, h, w, _ = x.shape
    oh, ow = out_hw
    ys = torch.floor(torch.arange(oh, dtype=torch.float32, device=x.device)
                     * (h / oh)).long()
    xs = torch.floor(torch.arange(ow, dtype=torch.float32, device=x.device)
                     * (w / ow)).long()
    return x[:, ys][:, :, xs]


def preprocess_shape(h: int, w: int) -> Tuple[int, int, float, float]:
    """Round a shape down to /32. Returns (_H, _W, rh, rw), with rh/rw
    mapping resized coordinates back to the input."""
    _h, _w = (h // 32) * 32, (w // 32) * 32
    if _h == 0 or _w == 0:
        raise ValueError(f"image {h}x{w} is smaller than the /32 stride; "
                         "inputs must be at least 32x32")
    return _h, _w, h / _h, w / _w


def preprocess_image(x: torch.Tensor) -> Tuple[torch.Tensor, float, float]:
    """Resize a (B,H,W,C) batch so that H and W are divisible by 32."""
    h, w = x.shape[1], x.shape[2]
    _h, _w, rh, rw = preprocess_shape(h, w)
    if (_h, _w) != (h, w):
        x = resize_bilinear(x, (_h, _w))
    return x, rh, rw
