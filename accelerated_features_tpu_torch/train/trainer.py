"""The XFeat trainer of the port: the JAX package's `train/trainer.py` in
torch, on one device.

One step (`train_step`): both views through `xfeat_forward(train=True)`,
per item the dual-softmax, fine-coordinate, reliability and keypoint-head
losses on fixed-shape, masked correspondences, then the optax chain of
the JAX package (`optim.py`): global-norm clip 1.0, Adam, and a staircase
learning rate (x0.5 every 30k steps) read at the count before the update.
BatchNorm running statistics are two sequential EMA updates for the two
backbone forwards and one for the fine matcher, applied to the updated
parameters.

The parameters are the port's tensor tree with BatchNorm unfolded
(`models.params.params_from_jax` of an unfolded tree). Every leaf has an
Adam moment, as in the JAX state; the BatchNorm running statistics get a
zero gradient. The JAX package `vmap`s the per-item losses; here they run
in a loop over the batch, each item's fine-matcher BatchNorm on its own
rows, as under `vmap`. Randomness (the distillation keep-mask) comes from
a `torch.Generator` on the data's device. The sharded step of the JAX
package (`make_sharded_train_step`) is not ported: one device only.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..models.backbone import fine_matcher_forward, xfeat_forward
from ..ops.precision import full_fp32_convs, full_fp32_matmuls
from . import optim
from .losses import (coordinate_classification_loss, distill_loss,
                     dual_softmax_loss, keypoint_position_loss,
                     keypoint_reliability_loss)

BN_STATS = ("mean", "var")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    lr_step: int = 30_000
    lr_gamma: float = 0.5
    grad_clip: float = 1.0
    bn_momentum: float = 0.1  # torch BatchNorm default
    distill_weight: float = 2.0
    use_distill: bool = True
    # teacher-free keypoint-head supervision (keypoint_position_loss);
    # needs batch["corrs_full"]
    use_kp_position: bool = False
    kp_position_weight: float = 1.0


def lr_schedule(cfg: TrainConfig):
    """count -> the learning rate of the step at that optimizer count."""
    return optim.exponential_decay(cfg.lr, cfg.lr_step, cfg.lr_gamma,
                                   staircase=True)


def make_optimizer(cfg: TrainConfig) -> optim.GradientTransformation:
    return optim.chain(optim.clip_by_global_norm(cfg.grad_clip),
                       optim.scale_by_adam(),
                       optim.scale_by_learning_rate(lr_schedule(cfg)))


def init_train_state(params: Dict[str, Any], cfg: TrainConfig
                     ) -> Dict[str, Any]:
    """{params, opt_state (the optax chain's states), step (int32)}."""
    dev = optim.tree_leaves(params)[0].device
    return {"params": params,
            "opt_state": make_optimizer(cfg).init(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _gather_at(maps: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """maps (h, w, C); pts (M, 2) /8-grid xy -> (M, C) at the integer
    cells."""
    h, w, c = maps.shape
    x = pts[:, 0].long().clamp(0, w - 1)
    y = pts[:, 1].long().clamp(0, h - 1)
    return maps.reshape(h * w, c)[y * w + x]


def _mean_stats(per_item: List[List[Dict[str, torch.Tensor]]]):
    return [{k: torch.stack([s[i][k] for s in per_item]).mean(0)
             for k in BN_STATS} for i in range(len(per_item[0]))]


@full_fp32_matmuls()
def loss_fn(params: Dict[str, Any], batch: Dict[str, torch.Tensor],
            generator: Optional[torch.Generator], cfg: TrainConfig,
            keep_neg: Optional[torch.Tensor] = None):
    """The XFeat training loss of one fixed-shape batch.

    batch: image0, image1 (B,H,W,1) in [0,1]; corrs (B,M,4) (x0,y0,x1,y1)
    in /8-grid coordinates; corr_valid (B,M); optional distill_labels0/1
    (B,h,w); optional corrs_full (B,Mf,4) full-resolution with
    corr_full_valid. `keep_neg` (B,2,h*w) bool gives the distillation's
    dustbin keep-masks instead of drawing them from `generator`.

    Returns (loss, (metrics, (stats1, stats2, fine-matcher stats))), the
    stats being the BatchNorm batch statistics for the running update."""
    dtype = batch["image0"].dtype  # float32; float64 checks the arithmetic
    feats1, k1, h1, stats1 = xfeat_forward(params, batch["image0"],
                                           train=True, compute_dtype=dtype)
    feats2, k2, h2, stats2 = xfeat_forward(params, batch["image1"],
                                           train=True, compute_dtype=dtype)
    lbl0 = batch.get("distill_labels0") if cfg.use_distill else None
    lbl1 = batch.get("distill_labels1") if cfg.use_distill else None
    cfull = batch.get("corrs_full") if cfg.use_kp_position else None
    cf_valid = batch.get("corr_full_valid", batch["corr_valid"])

    losses, metrics, fm_stats = [], [], []
    for i in range(feats1.shape[0]):
        corrs, valid = batch["corrs"][i], batch["corr_valid"][i]
        pts1, pts2 = corrs[:, :2], corrs[:, 2:]
        m1, m2 = _gather_at(feats1[i], pts1), _gather_at(feats2[i], pts2)
        hv1 = _gather_at(h1[i], pts1)[:, 0]
        hv2 = _gather_at(h2[i], pts2)[:, 0]

        loss_ds, conf = dual_softmax_loss(m1, m2, valid)
        coords1, stats = fine_matcher_forward(
            params, torch.cat([m1, m2], dim=-1), train=True, valid=valid)
        fm_stats.append(stats)
        loss_coords, acc_coords = coordinate_classification_loss(
            coords1, pts1, conf, valid)
        loss_kp = keypoint_reliability_loss(hv1, hv2, conf, valid)

        zero = feats1.new_zeros(())
        if lbl0 is not None:
            kn = (None, None) if keep_neg is None else keep_neg[i]
            l1, a1 = distill_loss(k1[i], lbl0[i], generator, keep_neg=kn[0])
            l2, a2 = distill_loss(k2[i], lbl1[i], generator, keep_neg=kn[1])
            loss_distill = (l1 + l2) * cfg.distill_weight
            acc_pos = (a1 + a2) / 2
        elif cfull is not None:
            loss_distill, acc_pos = keypoint_position_loss(
                k1[i], k2[i], cfull[i][:, :2], cfull[i][:, 2:], cf_valid[i])
            loss_distill = loss_distill * cfg.kp_position_weight
        else:
            loss_distill, acc_pos = zero, zero

        losses.append((loss_ds + loss_coords + loss_kp + loss_distill) / 4.0)
        metrics.append({
            "loss_coarse": loss_ds, "loss_fine": loss_coords,
            "loss_reliability": loss_kp, "loss_distill": loss_distill,
            "acc_fine": acc_coords, "acc_distill": acc_pos,
            "n_corr": valid.sum()})

    loss = torch.stack(losses).mean()
    out = {k: torch.stack([m[k].detach().float() for m in metrics]).mean()
           for k in metrics[0]}
    out["loss_total"] = loss.detach()
    return loss, (out, (stats1, stats2, _mean_stats(fm_stats)))


def _update_running_stats(params: Dict[str, Any], stats, momentum: float
                          ) -> Dict[str, Any]:
    """torch-style running-statistics updates: two sequential EMA steps for
    the backbone (two forwards), one for the fine matcher."""
    stats1, stats2, fm_stats = stats

    def upd(run, batch):
        return (1.0 - momentum) * run + momentum * batch

    new = dict(params)
    for name in stats1:
        layers = []
        for i, p in enumerate(params[name]):
            if "mean" in p and i < len(stats1[name]):
                q = dict(p)
                for k in BN_STATS:
                    q[k] = upd(upd(p[k], stats1[name][i][k]),
                               stats2[name][i][k])
                layers.append(q)
            else:
                layers.append(p)
        new[name] = layers
    fm = []
    for i, p in enumerate(params["fine_matcher"]):
        if "mean" in p and i < len(fm_stats):
            q = dict(p)
            for k in BN_STATS:
                q[k] = upd(p[k], fm_stats[i][k])
            fm.append(q)
        else:
            fm.append(p)
    new["fine_matcher"] = fm
    return new


def value_and_grad(params: Dict[str, Any], batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator], cfg: TrainConfig,
                   keep_neg: Optional[torch.Tensor] = None):
    """(loss, (metrics, stats), grads): grads a tree shaped like params,
    zero at the BatchNorm running statistics. Forward and backward run
    convolutions and products in full float32 on the card."""
    with full_fp32_convs(), full_fp32_matmuls():
        return optim.value_and_grad(
            lambda p: loss_fn(p, batch, generator, cfg, keep_neg), params,
            frozen=BN_STATS)


def train_step(state: Dict[str, Any], batch: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator], cfg: TrainConfig,
               keep_neg: Optional[torch.Tensor] = None
               ) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
    """One step: gradients, clip, Adam, learning rate, BatchNorm running
    update. Returns (new state, metrics)."""
    _, (metrics, stats), grads = value_and_grad(state["params"], batch,
                                                generator, cfg, keep_neg)
    with torch.no_grad():
        updates, opt_state = make_optimizer(cfg).update(
            grads, state["opt_state"], state["params"])
        params = optim.apply_updates(state["params"], updates)
        params = _update_running_stats(params, stats, cfg.bn_momentum)
    return {"params": params, "opt_state": opt_state,
            "step": state["step"] + 1}, metrics
