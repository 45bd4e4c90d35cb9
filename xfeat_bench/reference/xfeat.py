"""XFeat's sparse extraction in plain PyTorch, from the published model
(`modules/model.py` XFeatModel) and `XFeat.detectAndCompute`
(`modules/xfeat.py`):

- gray = channel mean, InstanceNorm (biased variance, eps 1e-5);
- block1 (1->4->8->8->24, strides 1,2,1,2) + skip1 (avg-pool 4, 1x1
  conv), block2 (24,24), block3 (24->64 s2, 64, 1x1 64), block4 (64 s2,
  64, 64), block5 (64->128 s2, 128, 128, 1x1 ->64); block4 and block5
  upsampled bilinearly (half-pixel) to block3's size and summed with it;
  block_fusion (64, 64, 1x1 conv) gives the 64-channel descriptor map;
  heatmap_head (1x1 64, 64, 1x1 ->1, sigmoid) the reliability; the
  keypoint head (1x1 64 x3, 1x1 ->65) on the 8x8 unfold of the gray image;
- keypoint heatmap: softmax over 65, drop the dustbin, bin 8*dy+dx to pixel
  (dy, dx); candidates are 5x5 local maxima above `detection_threshold`;
  score = nearest heatmap x bilinear reliability (grid_sample,
  align_corners=False, positions normalized by W-1 and H-1); the point
  (0, 0) scores -1; the `top_k` best scores are kept (ties in row-major
  order), valid where the score is > 0;
- descriptors: the map L2-normalized per pixel, sampled bicubically
  (grid_sample), L2-normalized per keypoint.

Every convolution runs through `precision.Products`.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from .precision import Products

STRIDES = {
    "block1": [1, 2, 1, 2],
    "block2": [1, 1],
    "block3": [2, 1, 1],
    "block4": [2, 1, 1],
    "block5": [2, 1, 1, 1],
    "block_fusion": [1, 1, 1],
    "heatmap_head": [1, 1, 1],
    "keypoint_head": [1, 1, 1, 1],
}
# blocks whose last layer is a plain convolution (no ReLU after it)
PLAIN_LAST = ("block_fusion", "heatmap_head", "keypoint_head")


def _block(prod: Products, layers, x, name):
    for i, (p, s) in enumerate(zip(layers, STRIDES[name])):
        x = prod.conv2d(x, p["w"], p["b"], stride=s,
                        padding=p["w"].shape[-1] // 2)
        if not (name in PLAIN_LAST and i == len(layers) - 1):
            x = F.relu(x)
    return x


def backbone(params: Dict[str, Any], prod: Products, x: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B,C,H,W) float in [0, 1], H and W divisible by 32 -> descriptor
    map (B,64,H/8,W/8), keypoint logits (B,65,H/8,W/8), reliability
    (B,1,H/8,W/8)."""
    x = x.mean(dim=1, keepdim=True)
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = x.var(dim=(2, 3), keepdim=True, unbiased=False)
    x = (x - mean) / torch.sqrt(var + 1e-5)

    skip = params["skip1"]
    x1 = _block(prod, params["block1"], x, "block1")
    x2 = _block(prod, params["block2"],
                x1 + prod.conv2d(F.avg_pool2d(x, 4, 4), skip["w"], skip["b"]),
                "block2")
    x3 = _block(prod, params["block3"], x2, "block3")
    x4 = _block(prod, params["block4"], x3, "block4")
    x5 = _block(prod, params["block5"], x4, "block5")
    hw = x3.shape[-2:]
    x4 = F.interpolate(x4, hw, mode="bilinear", align_corners=False)
    x5 = F.interpolate(x5, hw, mode="bilinear", align_corners=False)
    feats = _block(prod, params["block_fusion"], x3 + x4 + x5, "block_fusion")
    heat = torch.sigmoid(_block(prod, params["heatmap_head"], feats,
                                "heatmap_head"))
    b, _, h, w = x.shape
    unfold = x.reshape(b, h // 8, 8, w // 8, 8).permute(0, 2, 4, 1, 3)
    logits = _block(prod, params["keypoint_head"],
                    unfold.reshape(b, 64, h // 8, w // 8), "keypoint_head")
    return feats, logits, heat


def keypoint_heatmap(logits: torch.Tensor) -> torch.Tensor:
    """(B,65,h,w) -> (B,H,W)."""
    scores = F.softmax(logits, dim=1)[:, :64]
    b, _, h, w = scores.shape
    heat = scores.permute(0, 2, 3, 1).reshape(b, h, w, 8, 8)
    return heat.permute(0, 1, 3, 2, 4).reshape(b, h * 8, w * 8)


def _grid(pos: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """(B,N,2) xy in an (H, W) frame -> grid_sample's (B,N,1,2) grid."""
    scale = torch.tensor([W - 1, H - 1], dtype=torch.float32,
                         device=pos.device)
    return (2.0 * (pos.float() / scale) - 1.0)[:, :, None, :]


def sample(maps: torch.Tensor, pos: torch.Tensor, H: int, W: int,
           mode: str) -> torch.Tensor:
    """(B,C,h,w) sampled at (B,N,2) xy of the (H, W) frame -> (B,N,C)."""
    out = F.grid_sample(maps, _grid(pos, H, W), mode=mode,
                        align_corners=False)
    return out[..., 0].permute(0, 2, 1).contiguous()


def dense_scores(kheat: torch.Tensor, heat: torch.Tensor) -> torch.Tensor:
    """Every pixel's score as if it were a candidate: nearest heatmap x
    bilinear reliability, (B,H,W); pixel (0, 0) scores -1."""
    b, H, W = kheat.shape
    ys, xs = torch.meshgrid(torch.arange(H, device=kheat.device),
                            torch.arange(W, device=kheat.device),
                            indexing="ij")
    pos = torch.stack([xs, ys], -1).reshape(1, H * W, 2).expand(b, -1, -1)
    near = sample(kheat[:, None], pos, H, W, "nearest")[..., 0]
    rel = sample(heat, pos, H, W, "bilinear")[..., 0]
    scores = (near * rel).reshape(b, H, W)
    scores[:, 0, 0] = -1.0
    return scores


def candidates(kheat: torch.Tensor, threshold: float) -> torch.Tensor:
    """5x5 non-maximum suppression: (B,H,W) bool."""
    local = F.max_pool2d(kheat[:, None], 5, stride=1, padding=2)[:, 0]
    return (kheat == local) & (kheat > threshold)


def select(kheat: torch.Tensor, scores: torch.Tensor, top_k: int,
           threshold: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The `top_k` candidates by score, ties in row-major order ->
    positions (B,K,2) int64 xy and scores (B,K), padded with (0, 0) and
    score -1 where an image has fewer candidates."""
    b, H, W = kheat.shape
    cand = candidates(kheat, threshold).reshape(b, H * W)
    flat = torch.where(cand, scores.reshape(b, H * W),
                       torch.full_like(scores.reshape(b, H * W),
                                       float("-inf")))
    order = torch.sort(flat, dim=1, descending=True, stable=True).indices
    idx = order[:, :top_k]
    val = torch.gather(flat, 1, idx)
    real = torch.isfinite(val)
    pos = torch.stack([idx % W, idx // W], -1)
    pos = torch.where(real[..., None], pos, torch.zeros_like(pos))
    val = torch.where(real, val, torch.full_like(val, -1.0))
    if idx.shape[1] < top_k:
        pad = top_k - idx.shape[1]
        pos = F.pad(pos, (0, 0, 0, pad))
        val = F.pad(val, (0, pad), value=-1.0)
    return pos, val


def to_unit(images: torch.Tensor) -> Tuple[torch.Tensor, float, float]:
    """(B,H,W,C) uint8 -> (B,C,_H,_W) float in [0, 1], resized to sides
    divisible by 32 (bilinear, half-pixel), and the factors rh, rw back to
    the input's coordinates."""
    x = images.permute(0, 3, 1, 2).float() / 255.0
    H, W = x.shape[-2:]
    _H, _W = (H // 32) * 32, (W // 32) * 32
    if (_H, _W) != (H, W):
        x = F.interpolate(x, (_H, _W), mode="bilinear", align_corners=False)
    return x, H / _H, W / _W


@torch.no_grad()
def extract(params: Dict[str, Any], images: torch.Tensor, top_k: int,
            threshold: float, precision: str = "full",
            maps: bool = False) -> Dict[str, torch.Tensor]:
    """(B,H,W,C) uint8 -> keypoints (B,K,2) float xy in the input's
    coordinates, scores (B,K), descriptors (B,K,64), valid (B,K); with
    `maps`, also the keypoint heatmap `kheat` and the dense `scores`
    (B,_H,_W) that the judge reads margins from."""
    prod = Products(precision)
    x, rh, rw = to_unit(images)
    _H, _W = x.shape[-2:]
    feats, logits, heat = backbone(params, prod, x)
    kheat = keypoint_heatmap(logits)
    dense = dense_scores(kheat, heat)
    pos, val = select(kheat, dense, top_k, threshold)
    descs = F.normalize(sample(F.normalize(feats, dim=1), pos, _H, _W,
                               "bicubic"), dim=-1)
    out = {"keypoints": pos.float() * torch.tensor(
               [rw, rh], dtype=torch.float32, device=pos.device),
           "scores": val, "descriptors": descs, "valid": val > 0}
    if maps:
        out["kheat"], out["dense"] = kheat, dense
    return out
