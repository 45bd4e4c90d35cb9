"""Sparse sampling of (B,h,w,C) maps at keypoints with `F.grid_sample`
semantics (counterpart of the JAX package's `ops/sample.py`):

  * positions (x, y) live in an (H, W) reference frame and map to
    ix = x * w/(W-1) - 0.5 (normalize by W-1, align_corners=False);
  * out-of-bounds taps contribute zero (padding_mode='zeros');
  * 'nearest' rounds half to even; 'bicubic' uses A = -0.75.

`l2_normalize`, `sample_bicubic`, then `l2_normalize` again is the plain
version of the descriptor kernel in `ops/cuda/bicubic.py`.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _source_coords(pos: torch.Tensor, ref_hw: Tuple[int, int],
                   map_hw: Tuple[int, int]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(…,2) xy in an (H,W) frame -> fractional indices (ix, iy) into an
    (h,w) map."""
    H, W = ref_hw
    h, w = map_hw
    x = pos[..., 0].float()
    y = pos[..., 1].float()
    return x * (w / (W - 1)) - 0.5, y * (h / (H - 1)) - 0.5


def _gather2d(maps: torch.Tensor, ix: torch.Tensor,
              iy: torch.Tensor) -> torch.Tensor:
    """maps[b, iy, ix, :] with zeros for out-of-bounds taps.
    maps (B,h,w,C); ix, iy (B,N) integer -> (B,N,C)."""
    b, h, w, c = maps.shape
    inb = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
    idx = iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)
    out = torch.gather(maps.reshape(b, h * w, c), 1,
                       idx[..., None].expand(-1, -1, c))
    return out * inb[..., None].to(maps.dtype)


def sample_nearest(maps: torch.Tensor, pos: torch.Tensor,
                   ref_hw: Tuple[int, int]) -> torch.Tensor:
    """(B,h,w,C), (B,N,2) xy -> (B,N,C)."""
    ix, iy = _source_coords(pos, ref_hw, maps.shape[1:3])
    return _gather2d(maps, torch.round(ix).long(), torch.round(iy).long())


def sample_bilinear(maps: torch.Tensor, pos: torch.Tensor,
                    ref_hw: Tuple[int, int]) -> torch.Tensor:
    """(B,h,w,C), (B,N,2) xy -> (B,N,C)."""
    ix, iy = _source_coords(pos, ref_hw, maps.shape[1:3])
    x0 = torch.floor(ix).long()
    y0 = torch.floor(iy).long()
    tx = (ix - x0)[..., None].to(maps.dtype)
    ty = (iy - y0)[..., None].to(maps.dtype)
    top = _gather2d(maps, x0, y0) * (1 - tx) + _gather2d(maps, x0 + 1, y0) * tx
    bot = (_gather2d(maps, x0, y0 + 1) * (1 - tx)
           + _gather2d(maps, x0 + 1, y0 + 1) * tx)
    return top * (1 - ty) + bot * ty


def _cubic_weights(t: torch.Tensor, a: float = -0.75):
    """Cubic convolution weights of the taps at offsets -1, 0, 1, 2 from
    floor; `t` is the fractional part (torch's upsample cubic kernel)."""
    def k1(x):  # |x| <= 1
        return (a + 2) * x ** 3 - (a + 3) * x ** 2 + 1

    def k2(x):  # 1 < |x| < 2
        return a * x ** 3 - 5 * a * x ** 2 + 8 * a * x - 4 * a

    return k2(t + 1.0), k1(t), k1(1.0 - t), k2(2.0 - t)


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    """torch F.normalize semantics: x / max(||x||, eps)."""
    return x / torch.linalg.vector_norm(x, dim=dim, keepdim=True).clamp_min(
        eps)


def sample_bicubic(maps: torch.Tensor, pos: torch.Tensor,
                   ref_hw: Tuple[int, int]) -> torch.Tensor:
    """(B,h,w,C), (B,N,2) xy -> (B,N,C), bicubic with zeros padding."""
    ix, iy = _source_coords(pos, ref_hw, maps.shape[1:3])
    x0 = torch.floor(ix).long()
    y0 = torch.floor(iy).long()
    wx = _cubic_weights((ix - x0).to(maps.dtype))
    wy = _cubic_weights((iy - y0).to(maps.dtype))
    out = None
    for j in range(4):
        row = None
        yj = y0 + (j - 1)
        for i in range(4):
            v = _gather2d(maps, x0 + (i - 1), yj) * wx[i][..., None]
            row = v if row is None else row + v
        row = row * wy[j][..., None]
        out = row if out is None else out + row
    return out
