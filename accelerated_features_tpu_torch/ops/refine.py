"""Semi-dense match refinement, the XFeat* core, batched and fixed-shape
(counterpart of the JAX package's `ops/refine.py`).

Matched coarse descriptor pairs go through the fine-matcher MLP; its 64
logits are read as an 8x8 offset heatmap; a temperature-3 soft-argmax
gives a sub-pixel offset that is scaled by the keypoint's extraction scale
and added to the source keypoint; matches below the confidence gate are
masked out.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..models.backbone import fine_matcher_forward
from .precision import full_fp32_matmuls


def subpix_softmax2d(logits: torch.Tensor, temp: float = 3.0) -> torch.Tensor:
    """(..., 64) logits -> (..., 2) soft-argmax (x, y) offsets over the 8x8
    grid, centered at (4, 4)."""
    probs = torch.softmax(logits * temp, dim=-1)
    grid = torch.arange(8, dtype=probs.dtype, device=probs.device) - 4.0
    px = probs.reshape(*probs.shape[:-1], 8, 8)
    off_x = (px * grid[None, :]).sum(dim=(-2, -1))
    off_y = (px * grid[:, None]).sum(dim=(-2, -1))
    return torch.stack([off_x, off_y], dim=-1)


@full_fp32_matmuls()
def refine_matches(params: Dict[str, Any], kpts0: torch.Tensor,
                   kpts1: torch.Tensor, descs0: torch.Tensor,
                   descs1: torch.Tensor, scales0: torch.Tensor,
                   idx1: torch.Tensor, match_mask: torch.Tensor,
                   fine_conf: float = 0.25
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                              torch.Tensor]:
    """Refine coarse matches. kpts0/1 (B,K,2), descs0/1 (B,K,64), scales0
    (B,K) extraction scale of set 0, idx1 (B,K) each slot's match in set 1,
    match_mask (B,K) the slots that are mutual matches ->
    mkpts0 (B,K,2) refined, mkpts1 (B,K,2) gathered, conf (B,K),
    mask (B,K) = match_mask & (conf > fine_conf). `params` is the model
    tree; only `params['fine_matcher']` is read."""
    idx = idx1[..., None]
    f2 = torch.gather(descs1, 1, idx.expand(-1, -1, descs1.shape[-1]))
    k1 = torch.gather(kpts1, 1, idx.expand(-1, -1, 2))
    logits = fine_matcher_forward(params, torch.cat([descs0, f2], dim=-1))
    conf = torch.softmax(logits * 3.0, dim=-1).max(dim=-1).values
    offsets = subpix_softmax2d(logits, temp=3.0)
    mkpts0 = kpts0 + offsets * scales0[..., None]
    return mkpts0, k1, conf, match_mask & (conf > fine_conf)
