"""Mutual nearest neighbours, as `XFeat.match` computes them: cosine
similarity of L2-normalized descriptors, each row's best column and each
column's best row; a row matches where the two agree (and its similarity
exceeds `min_cossim` when that is > 0). Padded rows and columns take no
part."""

from __future__ import annotations

from typing import Tuple

import torch

from .precision import Products

NEG = float("-inf")


def similarity(d1: torch.Tensor, d2: torch.Tensor, valid1: torch.Tensor,
               valid2: torch.Tensor, precision: str = "full"
               ) -> torch.Tensor:
    """(B,K1,64), (B,K2,64), (B,K1), (B,K2) -> (B,K1,K2), -inf wherever a
    row or a column is padding."""
    sim = Products(precision).matmul(d1, d2.transpose(1, 2))
    keep = valid1[:, :, None] & valid2[:, None, :]
    return torch.where(keep, sim, torch.full_like(sim, NEG))


@torch.no_grad()
def match(d1: torch.Tensor, d2: torch.Tensor, valid1: torch.Tensor,
          valid2: torch.Tensor, min_cossim: float = -1.0,
          precision: str = "full") -> Tuple[torch.Tensor, torch.Tensor]:
    """-> idx1 (B,K1) int64, each row's best column, and mask (B,K1) bool,
    the rows that match."""
    sim = similarity(d1, d2, valid1, valid2, precision)
    best, idx1 = sim.max(dim=2)
    idx0 = sim.argmax(dim=1)
    rows = torch.arange(sim.shape[1], device=sim.device)[None]
    mask = (torch.gather(idx0, 1, idx1) == rows) & torch.isfinite(best)
    if min_cossim > 0:
        mask &= best > min_cossim
    return idx1, mask
