"""LighterGlue training loss of the port: the JAX package's
`train/lighterglue_loss.py` in torch. The negative log-likelihood of the
ground-truth assignment under the dustbin log-assignment matrix, plus the
dustbin terms of the points with no true match, each side weighted 0.5."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


def assignment_nll(log_assignment: torch.Tensor, gt_idx0: torch.Tensor,
                   gt_idx1: torch.Tensor, gt_valid: torch.Tensor,
                   unmatched0: Optional[torch.Tensor] = None,
                   unmatched1: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """log_assignment (B, M+1, N+1); gt_idx0/gt_idx1/gt_valid (B, S) the
    true index pairs (padded); unmatched0 (B, M), unmatched1 (B, N) the
    points without a true match. Returns (loss, metrics)."""
    b, m1, n1 = log_assignment.shape
    m, n = m1 - 1, n1 - 1
    pos = torch.gather(log_assignment.reshape(b, -1), 1,
                       gt_idx0.long() * n1 + gt_idx1.long())
    n_pos = gt_valid.sum().clamp_min(1)
    loss_pos = -torch.where(gt_valid, pos, 0.0).sum() / n_pos
    metrics = {"nll_pos": loss_pos.detach()}
    loss = loss_pos
    if unmatched0 is not None:
        dust0 = log_assignment[:, :m, n]
        loss_un0 = -torch.where(unmatched0, dust0, 0.0).sum() \
            / unmatched0.sum().clamp_min(1)
        loss = loss + 0.5 * loss_un0
        metrics["nll_unmatched0"] = loss_un0.detach()
    if unmatched1 is not None:
        dust1 = log_assignment[:, m, :n]
        loss_un1 = -torch.where(unmatched1, dust1, 0.0).sum() \
            / unmatched1.sum().clamp_min(1)
        loss = loss + 0.5 * loss_un1
        metrics["nll_unmatched1"] = loss_un1.detach()
    pred = log_assignment[:, :m, :n].argmax(dim=2)
    hit = torch.gather(pred, 1, gt_idx0.long()) == gt_idx1.long()
    metrics["match_acc"] = (hit & gt_valid).sum() / n_pos
    metrics["loss_total"] = loss.detach()
    return loss, metrics


def lighterglue_loss(params, batch: Dict[str, torch.Tensor], heads: int = 1):
    """Forward and loss on a fixed-shape batch: kpts0/1 (B,M,2), descs0/1
    (B,M,64), size0/1 (B,2), mask0/1 (B,M), gt_idx0/gt_idx1/gt_valid
    (B,S), unmatched0/1 (B,M)."""
    from ..models.lighterglue import lighterglue_forward
    out = lighterglue_forward(
        params, batch["kpts0"], batch["kpts1"], batch["descs0"],
        batch["descs1"], batch["size0"], batch["size1"], batch.get("mask0"),
        batch.get("mask1"), heads=heads)
    return assignment_nll(out["log_assignment"], batch["gt_idx0"],
                          batch["gt_idx1"], batch["gt_valid"],
                          batch.get("unmatched0"), batch.get("unmatched1"))
