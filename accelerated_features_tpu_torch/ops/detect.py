"""Sparse keypoint selection, fixed-shape (counterpart of the JAX package's
`ops/detect.py`).

heatmap decode -> 5x5 NMS -> dense score map (nearest heatmap x bilinear
reliability, -1 where invalid) -> one candidate per 2x2 tile -> top-k.
`score_map` + `topk_keypoints` are the plain version of the fused detect
kernel in `ops/cuda/detect_fused.py`, and `_padded_top_k` the plain
version of its selection kernel (`topk_exact`), which orders keypoints the
same way.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.nn.functional as F


def heatmap_decode(logits: torch.Tensor,
                   softmax_temp: float = 1.0) -> torch.Tensor:
    """Keypoint logits (B,h,w,65) -> full-res heatmap (B,h*8,w*8): softmax
    over the 65 bins, dustbin dropped, bin 8*dy+dx to pixel (dy, dx)."""
    b, h, w, _ = logits.shape
    scores = torch.softmax(logits * softmax_temp, dim=-1)[..., :64]
    scores = scores.reshape(b, h, w, 8, 8).permute(0, 1, 3, 2, 4)
    return scores.reshape(b, h * 8, w * 8)


def local_max_mask(heat: torch.Tensor, threshold: float = 0.05,
                   kernel_size: int = 5) -> torch.Tensor:
    """(B,H,W) -> bool mask of 5x5 local maxima above threshold. Every
    pixel that ties the window's max passes (`heat == maxpool(heat)`)."""
    pad = kernel_size // 2
    lmax = F.max_pool2d(heat[:, None], kernel_size, stride=1,
                        padding=pad)[:, 0]  # pads with -inf
    return (heat == lmax) & (heat > threshold)


def _lerp_axis(arr: torch.Tensor, in_size: int, out_size: int,
               axis: int) -> torch.Tensor:
    """1-D lerp along `axis` at src = i*(in/(out-1)) - 0.5, in float32,
    zero weight for out-of-range taps."""
    i = torch.arange(out_size, dtype=torch.float32, device=arr.device)
    src = i * (in_size / (out_size - 1)) - 0.5
    i0 = torch.floor(src).long()
    t = src - i0
    m0 = ((i0 >= 0) & (i0 < in_size)).float()
    m1 = ((i0 + 1 >= 0) & (i0 + 1 < in_size)).float()
    g0 = torch.index_select(arr, axis, i0.clamp(0, in_size - 1))
    g1 = torch.index_select(arr, axis, (i0 + 1).clamp(0, in_size - 1))
    shape = [1] * arr.ndim
    shape[axis] = out_size
    t, m0, m1 = t.reshape(shape), m0.reshape(shape), m1.reshape(shape)
    return g0 * m0 * (1 - t) + g1 * m1 * t


def _upsample_reliability(rel: torch.Tensor,
                          out_hw: Tuple[int, int]) -> torch.Tensor:
    """The /8 reliability map (B,h,w) bilinearly sampled at every full-res
    pixel (separable: along W, then along H)."""
    _, h, w = rel.shape
    H, W = out_hw
    return _lerp_axis(_lerp_axis(rel, w, W, 2), h, H, 1)


def score_map(kpt_heat: torch.Tensor, reliability: torch.Tensor,
              threshold: float = 0.05, kernel_size: int = 5) -> torch.Tensor:
    """Dense score map (B,H,W): heat x upsampled reliability at local maxima,
    -1 elsewhere. The last row and column score 0 (the nearest sample falls
    outside the image there) and pixel (0,0) scores -1 (padding kill)."""
    _, H, W = kpt_heat.shape
    mask = local_max_mask(kpt_heat, threshold, kernel_size)
    near = kpt_heat.clone()
    near[:, :, W - 1] = 0.0
    near[:, H - 1, :] = 0.0
    scores = torch.where(mask, near * _upsample_reliability(reliability,
                                                            (H, W)),
                         torch.full_like(near, -1.0))
    scores[:, 0, 0] = -1.0
    return scores


def tile_candidates(scores: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B,H,W) score map, H and W even -> the best score of each 2x2 tile
    (B,H/2,W/2) and its position in the tile (uint8, 2*dy+dx, first of
    equal maxima). The 5x5 NMS leaves at most one positive score in a 2x2
    tile (two tie-free maxima lie >= 3 apart), so this loses nothing."""
    b, H, W = scores.shape
    s4 = scores.reshape(b, H // 2, 2, W // 2, 2).permute(0, 1, 3, 2, 4)
    best, sub = s4.reshape(b, H // 2, W // 2, 4).max(dim=-1)
    return best, sub.to(torch.uint8)


def _padded_top_k(flat: torch.Tensor, k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of (B,N) by value, ties in index order (as `lax.top_k`), also
    where equal values straddle the k-th place; for k > N the tail is
    padded with (-1.0, index 0).

    `torch.topk` promises no order among equal values, so the selection
    runs on 64-bit keys that have none: the float's bits, made monotonic
    as a signed integer (so -0.0 sorts below +0.0, as it does in
    `lax.top_k`), above the complemented index."""
    n = flat.shape[-1]
    bits = flat.float().contiguous().view(torch.int32).long()
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    key = (ordered << 32) | (n - 1 - torch.arange(n, device=flat.device))
    top = torch.topk(key, min(k, n), dim=-1).values
    idx = (n - 1) - (top & 0xFFFFFFFF)
    vals = torch.gather(flat, -1, idx)
    if k > n:
        vals = F.pad(vals, (0, k - n), value=-1.0)
        idx = F.pad(idx, (0, k - n), value=0)
    return vals, idx


def dense_topk(feat_flat: torch.Tensor, rel_flat: torch.Tensor, top_k: int,
               select: Callable = _padded_top_k
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Semi-dense selector: the top-k /8 cells by reliability and their
    descriptors. feat_flat (B,h*w,C), rel_flat (B,h*w) -> idx (B,K) int64,
    feats (B,K,C). With fewer than K cells the tail is cell 0. `select`
    is `_padded_top_k` or a function with its contract, such as kernel A's
    `topk_exact`."""
    _, idx = select(rel_flat, top_k)
    feats = torch.gather(feat_flat, 1,
                         idx[..., None].expand(-1, -1, feat_flat.shape[-1]))
    return idx, feats


def select_keypoints(best: torch.Tensor, sub: torch.Tensor, top_k: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """2x2-tile candidates -> ((B,K,2) int64 xy, (B,K) scores), sorted by
    descending score. Slots with score <= 0 are invalid."""
    b, h2, w2 = best.shape
    scores, idx = _padded_top_k(best.reshape(b, h2 * w2), top_k)
    s = torch.gather(sub.reshape(b, h2 * w2), 1, idx).long()
    ys = (idx // w2) * 2 + s // 2
    xs = (idx % w2) * 2 + s % 2
    return torch.stack([xs, ys], dim=-1), scores


def topk_keypoints(scores: torch.Tensor, top_k: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense (B,H,W) score map -> ((B,K,2) int64 xy, (B,K) scores)."""
    b, h, w = scores.shape
    if h % 2 or w % 2:
        top, idx = _padded_top_k(scores.reshape(b, h * w), top_k)
        return torch.stack([idx % w, idx // w], dim=-1), top
    return select_keypoints(*tile_candidates(scores), top_k)
