"""Mutual-nearest-neighbour matching, fixed-shape and masked (counterpart
of the JAX package's `ops/matching.py`).

Descriptor rows may be padding; `valid` masks mark real rows. `idx1[i]` is
row i's best column; `mask` selects the mutual (and gated) matches among
valid rows. Invalid rows and columns are pushed out of each argmax with a
-1e9 fill, and ties go to the first index. `batch_mnn_match` is the plain
version of the fused MNN kernel in `ops/cuda/mnn.py`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .precision import full_fp32_matmuls

NEG = -1e9


def similarity(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """(…,K1,C) x (…,K2,C) -> (…,K1,K2) dot products in full float32.

    bf16-grade similarities flip mutual-argmax decisions when similarities
    cluster tightly, so this must not run in TF32 on the card: callers
    enter `full_fp32_matmuls`, as `batch_mnn_match` does."""
    return torch.matmul(d1.float(), d2.float().transpose(-1, -2))


@full_fp32_matmuls()
def batch_mnn_match(d1: torch.Tensor, d2: torch.Tensor,
                    valid1: Optional[torch.Tensor] = None,
                    valid2: Optional[torch.Tensor] = None,
                    min_cossim: float = -1.0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B,K1,C), (B,K2,C), optional (B,K1) / (B,K2) bool masks ->
    idx1 (B,K1) int64, mask (B,K1) bool. `min_cossim` <= 0 disables the
    gate on the best similarity."""
    sim = similarity(d1, d2)
    if valid2 is not None:
        sim = torch.where(valid2[:, None, :], sim, NEG)
    simT = sim.transpose(1, 2)
    if valid1 is not None:
        simT = torch.where(valid1[:, None, :], simT, NEG)
    match12 = torch.argmax(sim, dim=2)
    match21 = torch.argmax(simT, dim=2)
    arange = torch.arange(d1.shape[1], device=d1.device)
    mask = torch.gather(match21, 1, match12) == arange
    if valid1 is not None:
        mask = mask & valid1
    if min_cossim > 0:
        mask = mask & (sim.max(dim=2).values > min_cossim)
    return match12, mask


def batch_mnn_match_dense(d1: torch.Tensor, d2: torch.Tensor,
                          min_cossim: float = -1.0
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`batch_mnn_match` for the semi-dense path, where every row is real."""
    return batch_mnn_match(d1, d2, None, None, min_cossim)


def mnn_match(d1: torch.Tensor, d2: torch.Tensor,
              valid1: Optional[torch.Tensor] = None,
              valid2: Optional[torch.Tensor] = None,
              min_cossim: float = 0.82) -> Tuple[torch.Tensor, torch.Tensor]:
    """One pair: (K1,C), (K2,C), optional (K,) masks -> idx1 (K1,), mask
    (K1,). The default gate 0.82 is the bare `match` default."""
    idx, mask = batch_mnn_match(
        d1[None], d2[None], None if valid1 is None else valid1[None],
        None if valid2 is None else valid2[None], min_cossim)
    return idx[0], mask[0]
