"""Training losses of the port: the JAX package's `train/losses.py` in
torch, function by function, with the same names, masks and weights.

Every function works on one item (the JAX trainer `vmap`s them; the
port's trainer loops over the batch), takes a validity mask instead of
variable-length tensors, and keeps the JAX package's arithmetic: masked
logits at -1e9, the dual-softmax temperature 0.2, the coordinate loss x2,
the reliability L1 x3. Cell and hashmap collisions resolve to the highest
index (`scatter_reduce` "amax"), as the JAX package's scatter-max does.
Where JAX draws from a key, the port takes a `torch.Generator` on the
data's device, or the draw itself (`keep_neg`, `offsets`), so tests can
hand both packages the same one.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

NEG = -1e9


def _masked_log_softmax(logits: torch.Tensor, mask: torch.Tensor,
                        dim: int = -1) -> torch.Tensor:
    return torch.log_softmax(torch.where(mask, logits, NEG), dim=dim)


def _nll(logp: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return -torch.gather(logp, -1, labels[:, None].long())[:, 0]


def _count(valid: torch.Tensor) -> torch.Tensor:
    return valid.sum().clamp_min(1)


def _scatter_max_lut(idx: torch.Tensor, values: torch.Tensor,
                     size: int) -> torch.Tensor:
    """lut (size,) int64: the largest of `values` written to each slot,
    -1 where none; an `idx` of `size` or more is dropped."""
    lut = torch.full((size + 1,), -1, dtype=torch.int64, device=idx.device)
    lut = lut.scatter_reduce(0, idx.clamp(max=size).long(), values.long(),
                             reduce="amax")
    return lut[:size]


def dual_softmax_loss(m1: torch.Tensor, m2: torch.Tensor,
                      valid: torch.Tensor, temp: float = 0.2
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric InfoNCE over corresponding rows of m1, m2 (M, C), masked
    by valid (M,). Returns (loss, (M,) mutual-softmax confidence without
    gradient)."""
    sim = (m1 @ m2.T) * temp
    vmask = valid[None, :] & valid[:, None]
    log12 = _masked_log_softmax(sim, vmask, 1)
    log21 = _masked_log_softmax(sim.T, vmask, 1)
    diag12, diag21 = torch.diagonal(log12), torch.diagonal(log21)
    loss = -(torch.where(valid, diag12, 0.0).sum()
             + torch.where(valid, diag21, 0.0).sum()) / _count(valid)
    conf12 = torch.exp(log12).max(dim=-1).values
    conf21 = torch.exp(log21).max(dim=-1).values
    conf = (conf12 * conf21 * valid).detach()
    return loss, conf


def coordinate_classification_loss(coords_logits: torch.Tensor,
                                   pts1: torch.Tensor, conf: torch.Tensor,
                                   valid: torch.Tensor
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fine offset classification: the 8x8 bin of pts1's fractional /8
    position, weighted by conf over the valid rows."""
    frac = pts1 - torch.floor(pts1)
    offs = torch.floor(frac * 8.0).long()
    labels = offs[:, 0] + 8 * offs[:, 1]
    nll = _nll(torch.log_softmax(coords_logits, dim=-1), labels)
    w = torch.where(valid, conf, 0.0)
    w = w / w.sum().clamp_min(1e-12)
    loss = (nll * w).sum() * 2.0
    pred = coords_logits.argmax(dim=-1)
    sure = valid & (conf > 0.1)
    acc = ((pred == labels) & sure).sum() / _count(sure)
    return loss, acc


def keypoint_reliability_loss(h1: torch.Tensor, h2: torch.Tensor,
                              conf: torch.Tensor,
                              valid: torch.Tensor) -> torch.Tensor:
    """L1 between both views' sampled reliabilities and the match
    confidence, x3."""
    l1 = (torch.where(valid, (h1 - conf).abs(), 0.0).sum()
          + torch.where(valid, (h2 - conf).abs(), 0.0).sum()) / _count(valid)
    return l1 * 3.0


def distill_labels_from_kpts(teacher_kpts: torch.Tensor,
                             kpt_valid: torch.Tensor, h: int,
                             w: int) -> torch.Tensor:
    """(h, w) int64 labels, the 0..63 bin of a cell's teacher keypoint or 64
    (dustbin); the highest-index keypoint wins a cell. teacher_kpts (T, 2)
    full-resolution xy, kpt_valid (T,)."""
    cell_x = (teacher_kpts[:, 0] / 8.0).long().clamp(0, w - 1)
    cell_y = (teacher_kpts[:, 1] / 8.0).long().clamp(0, h - 1)
    frac = teacher_kpts / 8.0 - torch.floor(teacher_kpts / 8.0)
    off = torch.floor(frac * 8.0).long()
    bins = off[:, 0] + 8 * off[:, 1]
    t = teacher_kpts.shape[0]
    ar = torch.arange(t, device=teacher_kpts.device)
    flat = torch.where(kpt_valid, cell_y * w + cell_x, h * w)
    lut = _scatter_max_lut(flat, torch.where(kpt_valid, ar, -1), h * w)
    labels = torch.where(lut >= 0, bins[lut.clamp(0, t - 1)], 64)
    return labels.reshape(h, w)


def distill_keep_probability(labels: torch.Tensor,
                             neg_ratio: int = 32) -> torch.Tensor:
    """The Bernoulli probability of keeping a dustbin cell: n_pos /
    (neg_ratio * n_neg), clipped to [0, 1]."""
    pos = labels.reshape(-1) < 64
    n_neg = (~pos).sum().clamp_min(1)
    return ((pos.sum().float() / neg_ratio) / n_neg.float()).clamp(0.0, 1.0)


def distill_loss(kpt_logits: torch.Tensor, labels: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 neg_ratio: int = 32,
                 keep_neg: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keypoint-head distillation: NLL over every positive cell and a
    Bernoulli(n_pos / (neg_ratio * n_neg)) subset of dustbin cells.
    kpt_logits (h, w, 65), labels (h, w). The keep draw comes from
    `generator`, or is given as `keep_neg` (h*w,) bool."""
    h, w, _ = kpt_logits.shape
    logits = kpt_logits.reshape(h * w, 65)
    lbl = labels.reshape(h * w)
    pos = lbl < 64
    if keep_neg is None:
        p_neg = distill_keep_probability(labels, neg_ratio)
        keep_neg = torch.rand((h * w,), generator=generator,
                              device=logits.device) < p_neg
    sel = pos | (keep_neg.reshape(-1) & ~pos)
    nll = _nll(torch.log_softmax(logits, dim=-1), lbl)
    n_sel = _count(sel)
    loss = torch.where(sel, nll, 0.0).sum() / n_sel
    acc = ((logits.argmax(dim=-1) == lbl) & sel).sum() / n_sel
    return loss, acc


def hard_triplet_loss(x: torch.Tensor, y: torch.Tensor, valid: torch.Tensor,
                      margin: float = 0.5) -> torch.Tensor:
    """Margin ranking against the hardest negative, masked."""
    d2 = ((x ** 2).sum(-1)[:, None] + (y ** 2).sum(-1)[None, :]
          - 2.0 * (x @ y.T))
    dist = torch.sqrt(d2.clamp_min(1e-12))
    pos = torch.diagonal(dist)
    eye = torch.eye(x.shape[0], dtype=torch.bool, device=x.device)
    neg = torch.where(eye | (dist <= 0.01)
                      | ~(valid[None, :] & valid[:, None]), dist + 100.0,
                      dist)
    hard_neg = neg.min(dim=1).values
    loss = (margin + pos - hard_neg).clamp_min(0.0)
    return torch.where(valid, loss, 0.0).sum() / _count(valid)


def smooth_l1_loss(x: torch.Tensor, target: torch.Tensor, beta: float = 2.0,
                   valid: Optional[torch.Tensor] = None,
                   size_average: bool = True) -> torch.Tensor:
    """Huber-style smooth L1, masked by `valid` over the leading dims."""
    diff = (x - target).abs()
    loss = torch.where(diff < beta, 0.5 * diff ** 2 / beta, diff - 0.5 * beta)
    if valid is not None:
        v = valid.reshape(valid.shape + (1,) * (loss.dim() - valid.dim()))
        loss = torch.where(v.expand(loss.shape), loss, 0.0)
        n = _count(valid) * (loss.numel() // valid.numel())
        return loss.sum() / n if size_average else loss.sum()
    return loss.mean() if size_average else loss.sum()


def keypoint_position_loss(logits1: torch.Tensor, logits2: torch.Tensor,
                           pts1: torch.Tensor, pts2: torch.Tensor,
                           valid: torch.Tensor, softmax_temp: float = 1.0
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Teacher-free keypoint-head supervision: view-2 cells learn the 8x8
    offset of the correspondence found at view-1's current argmax, and
    view-1's argmax is entrenched. logits (h, w, 65); pts1, pts2 (M, 2)
    full-resolution xy; valid (M,). Returns (loss, view-2 accuracy)."""
    h, w, c = logits1.shape
    H, W = h * 8, w * 8
    dev = logits1.device
    l1 = logits1.reshape(h * w, c) * softmax_temp
    l2 = logits2.reshape(h * w, c) * softmax_temp

    p1, p2 = pts1.long(), pts2.long()
    m = pts1.shape[0]
    flat1 = torch.where(valid, p1[:, 1] * W + p1[:, 0], H * W)
    lut = _scatter_max_lut(flat1, torch.where(
        valid, torch.arange(m, device=dev), -1), H * W)
    hashmap = torch.where((lut >= 0)[:, None], p2[lut.clamp(0, m - 1)], -1)

    off1 = l1.argmax(dim=-1)
    cy, cx = torch.meshgrid(torch.arange(h, device=dev),
                            torch.arange(w, device=dev), indexing="ij")
    coord_x = cx.reshape(-1) * 8 + off1 % 8
    coord_y = cy.reshape(-1) * 8 + off1 // 8
    inb = (coord_x < W) & (coord_y < H)
    gt12 = torch.where(inb[:, None],
                       hashmap[torch.where(inb, coord_y * W + coord_x, 0)],
                       -1)
    cell_valid = (gt12 >= 0).all(dim=-1)
    labels2 = torch.where(cell_valid,
                          (gt12[:, 0] % 8) + 8 * (gt12[:, 1] % 8), 0)
    tgt_cell = torch.where(cell_valid,
                           (gt12[:, 1] // 8) * w + (gt12[:, 0] // 8), 0)

    logp1 = torch.log_softmax(l1, dim=-1)
    logp2 = torch.log_softmax(l2[tgt_cell], dim=-1)
    nll1 = _nll(logp1, off1.detach())
    nll2 = _nll(logp2, labels2)
    n = _count(cell_valid)
    loss = (torch.where(cell_valid, nll1, 0.0).sum()
            + torch.where(cell_valid, nll2, 0.0).sum()) / n
    acc = ((logp2.argmax(dim=-1) == labels2) & cell_valid).sum() / n
    return loss, acc


def _subpix_softmax2d_ws(heat: torch.Tensor, temp: float = 0.25
                         ) -> torch.Tensor:
    """Soft-argmax of (N, h, w) heatmaps -> (N, 2) xy offsets from the
    window centre (w//2, h//2)."""
    n, h, w = heat.shape
    p = torch.softmax(temp * heat.reshape(n, h * w), dim=-1).reshape(n, h, w)
    gx = (torch.arange(w, dtype=p.dtype, device=p.device) - w // 2)
    gy = (torch.arange(h, dtype=p.dtype, device=p.device) - h // 2)
    return torch.stack([(p * gx[None, None, :]).sum(dim=(1, 2)),
                        (p * gy[None, :, None]).sum(dim=(1, 2))], dim=-1)


def fine_loss(f1: torch.Tensor, f2: torch.Tensor, pts1: torch.Tensor,
              pts2: torch.Tensor,
              fine_module: Callable[[torch.Tensor, torch.Tensor],
                                    Tuple[torch.Tensor, torch.Tensor]],
              generator: Optional[torch.Generator] = None,
              valid: Optional[torch.Tensor] = None, ws: int = 7,
              offsets: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Patch-level sub-pixel regression: pts2 moved by offsets drawn
    uniformly in (-ws//2, ws//2] (or given as `offsets` (N, 2)), patches of
    the two (H, W, C) maps matched by `fine_module(p1, p2) -> (p1, p2)`,
    and the soft-argmax of the centre-vs-patch similarity must recover
    -offset."""
    from .utils import crop_patches
    n, c = pts1.shape[0], f1.shape[-1]
    half = ws // 2
    if offsets is None:
        offsets = half - 2.0 * half * torch.rand(
            (n, 2), generator=generator, device=pts2.device)
    pts2_random = pts2 + offsets
    patches1 = crop_patches(f1, torch.floor(pts1 + 0.5).long(), ws)
    patches2 = crop_patches(f2, torch.floor(pts2_random + 0.5).long(), ws)
    p1, p2 = fine_module(patches1.reshape(n, ws * ws, c),
                         patches2.reshape(n, ws * ws, c))
    centre = p1.reshape(n, ws, ws, c)[:, half, half, :]
    heat = (centre[:, None, None, :] * p2.reshape(n, ws, ws, c)).sum(-1)
    err = ((_subpix_softmax2d_ws(heat) + offsets) ** 2).sum(-1)
    if valid is not None:
        return torch.where(valid, err, 0.0).sum() / _count(valid)
    return err.mean()


__all__ = ["dual_softmax_loss", "coordinate_classification_loss",
           "keypoint_reliability_loss", "distill_labels_from_kpts",
           "distill_keep_probability", "distill_loss", "hard_triplet_loss",
           "smooth_l1_loss", "keypoint_position_loss", "fine_loss"]
