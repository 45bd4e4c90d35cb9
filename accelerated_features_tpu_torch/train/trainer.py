"""The XFeat trainer of the port: the JAX package's `train/trainer.py` in
torch, on one device or sharded over a (data, model) mesh.

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
a `torch.Generator` on the data's device.

`make_sharded_train_step` runs the same step over `torch.distributed`
(`parallel/mesh.py`): the batch split over 'data', the fine-matcher MLP
over 'model' (`param_pspecs`: column and row splits alternated, the last
layer replicated). It computes what the single-device step computes on
the global batch: the backbone's BatchNorm takes the global batch's
statistics through an all-reduce that carries the gradient; each rank
sums its items' losses over the global batch size and the gradients are
summed over 'data'; the global-norm clip counts a replicated leaf once
and sums a sharded one over 'model'; Adam's moments are sharded like
their parameters; every rank draws the whole batch's keep-masks from the
same seeded generator and keeps its items'. Sums run in another order
than on one device, so the two agree within rounding, not bit for bit.
The single-device `train_step` runs the same loss on a mesh of one
(`local_mesh`), whose collectives are identities: one training path.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..models.backbone import _batch_norm, xfeat_forward
from ..ops.precision import full_fp32_convs, full_fp32_matmuls
from . import optim
from ..parallel.mesh import (Mesh, copy_to, local_mesh, reduce_from,
                             replicate, shard_on)
from .losses import (coordinate_classification_loss,
                     distill_keep_probability, distill_loss,
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


def make_optimizer(cfg: TrainConfig, norm_fn=None
                   ) -> optim.GradientTransformation:
    """The optax chain; `norm_fn` is the clip's norm of a sharded tree."""
    return optim.chain(optim.clip_by_global_norm(cfg.grad_clip, norm_fn),
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


def fine_matcher_forward_tp(params: Dict[str, Any], x: torch.Tensor,
                            valid: torch.Tensor, mesh: Mesh,
                            axis: str = "model"):
    """`fine_matcher_forward(train=True)` on this rank's shard of the MLP
    (`param_pspecs`): a column-split layer computes its share of the
    outputs, its input's gradient summed over `axis` in the backward; a
    row-split layer's partial products are summed over `axis`, then its
    replicated bias added; BatchNorm per feature, on the features the
    rank holds. Returns (logits, [{mean, var}]) as one device does; on a
    mesh of one (`local_mesh`) it is `fine_matcher_forward`."""
    mlp = params["fine_matcher"]
    if mesh.size(axis) > 1 and (len(mlp) - 1) % 2:
        raise ValueError("tensor parallelism of the fine matcher needs an "
                         "even number of hidden layers")
    stats: List[Dict[str, torch.Tensor]] = []
    dims = tuple(range(x.dim() - 1))
    for i, layer in enumerate(mlp[:-1]):
        if i % 2 == 0:
            x = F.linear(copy_to(x, mesh, axis), layer["w"], layer["b"])
        else:
            x = reduce_from(F.linear(x, layer["w"]), mesh, axis) + layer["b"]
        x = F.relu(_batch_norm(x, dims, stats, valid))
    return F.linear(x, mlp[-1]["w"], mlp[-1]["b"]), stats


@full_fp32_matmuls()
def loss_fn(params: Dict[str, Any], batch: Dict[str, torch.Tensor],
            generator: Optional[torch.Generator], cfg: TrainConfig,
            keep_neg: Optional[torch.Tensor] = None,
            mesh: Optional[Mesh] = None):
    """The XFeat training loss of one fixed-shape batch.

    batch: image0, image1 (B,H,W,1) in [0,1]; corrs (B,M,4) (x0,y0,x1,y1)
    in /8-grid coordinates; corr_valid (B,M); optional distill_labels0/1
    (B,h,w); optional corrs_full (B,Mf,4) full-resolution with
    corr_full_valid. `keep_neg` (B,2,h*w) bool gives the distillation's
    dustbin keep-masks instead of drawing them from `generator`.

    `batch` is this rank's share of the global batch over the mesh's
    'data' axis and `params` its shard (`make_sharded_train_step`;
    without a `mesh`, one device's whole batch, `local_mesh`): the loss
    is this rank's items' share of the global mean (their sum over the
    global batch size), and the metrics and fine-matcher statistics are
    the global batch's.

    Returns (loss, (metrics, (stats1, stats2, fine-matcher stats))), the
    stats being the BatchNorm batch statistics for the running update."""
    dtype = batch["image0"].dtype  # float32; float64 checks the arithmetic
    mesh = mesh or local_mesh()
    bn = mesh.reducer("data") if mesh.size("data") > 1 else None
    feats1, k1, h1, stats1 = xfeat_forward(params, batch["image0"],
                                           train=True, compute_dtype=dtype,
                                           bn_reduce=bn)
    feats2, k2, h2, stats2 = xfeat_forward(params, batch["image1"],
                                           train=True, compute_dtype=dtype,
                                           bn_reduce=bn)
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
        pair = torch.cat([m1, m2], dim=-1)
        coords1, stats = fine_matcher_forward_tp(params, pair, valid, mesh)
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

    n = len(losses) * mesh.size("data")

    def global_mean(items):
        return mesh.all_reduce(torch.stack(items).sum(0) / n, "data")
    loss = torch.stack(losses).sum() / n
    out = {k: global_mean([m[k].detach().float() for m in metrics])
           for k in metrics[0]}
    out["loss_total"] = mesh.all_reduce(loss.detach(), "data")
    fm = [{k: global_mean([s[i][k] for s in fm_stats]) for k in BN_STATS}
          for i in range(len(fm_stats[0]))]
    return loss, (out, (stats1, stats2, fm))


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


# ---------------------------------------------------------------------------
# Sharding over a (data, model) mesh
# ---------------------------------------------------------------------------

def param_pspecs(params: Dict[str, Any]) -> Dict[str, Any]:
    """A spec per leaf, the tuple of the mesh axis each dimension is split
    over (None: whole), as the JAX package's PartitionSpecs: the backbone
    replicated, the fine-matcher MLP column- and row-split in turn over
    'model' and its last layer replicated. The port's linear weights are
    (out, in), so a column split cuts dimension 0 and a row split
    dimension 1; bias, mean and var follow the output dimension."""
    specs = optim.tree_map(lambda _: (), params)
    mlp = params["fine_matcher"]
    fm = []
    for i, p in enumerate(mlp):
        if i == len(mlp) - 1:
            fm.append({k: () for k in p})
            continue
        col = i % 2 == 0
        fm.append({k: (("model", None) if col else (None, "model"))
                   if k == "w" else (("model",) if col else ())
                   for k in p})
    specs["fine_matcher"] = fm
    return specs


def batch_pspecs(batch: Dict[str, Any]) -> Dict[str, Tuple]:
    return {k: ("data",) for k in batch}


def _map_opt_state(opt_state, fn):
    """fn(moment tree) over the trees of optimizer states shaped like the
    parameters (Adam's mu and nu); counts and empty states unchanged."""
    return tuple(s._replace(mu=fn(s.mu), nu=fn(s.nu))
                 if isinstance(s, optim.ScaleByAdamState) else s
                 for s in opt_state)


def shard_state(mesh: Mesh, state: Dict[str, Any]) -> Dict[str, Any]:
    """The state as rank 0 holds it (broadcast), then this rank's shard of
    every 'model'-split leaf and of its Adam moments."""
    state = replicate(mesh, state)
    pspec = param_pspecs(state["params"])

    def shard(tree):
        return optim.tree_map(
            lambda t, s: shard_on(mesh, t, "model", s.index("model")).clone()
            if "model" in s else t, tree, pspec)
    return {"params": shard(state["params"]),
            "opt_state": _map_opt_state(state["opt_state"], shard),
            "step": state["step"]}


def gather_state(mesh: Mesh, state: Dict[str, Any]) -> Dict[str, Any]:
    """The whole state from its shards (every rank of a 'model' group
    calls it; each gets the whole state), e.g. for a checkpoint."""
    pspec = param_pspecs(state["params"])

    def gather(tree):
        return optim.tree_map(
            lambda t, s: mesh.all_gather(t, "model", s.index("model"))
            if "model" in s else t, tree, pspec)
    return {"params": gather(state["params"]),
            "opt_state": _map_opt_state(state["opt_state"], gather),
            "step": state["step"]}


def _sum_over(mesh: Mesh, tree: Any, axis: str) -> Any:
    """Every leaf summed over `axis`, one all-reduce a dtype."""
    leaves = optim.tree_leaves(tree)
    out = list(leaves)
    for dt in {t.dtype for t in leaves}:
        idx = [i for i, t in enumerate(leaves) if t.dtype == dt]
        flat = mesh.all_reduce(torch.cat([leaves[i].reshape(-1)
                                          for i in idx]), axis)
        for i, piece in zip(idx, torch.split(
                flat, [leaves[i].numel() for i in idx])):
            out[i] = piece.view_as(leaves[i])
    it = iter(out)
    return optim.tree_map(lambda _: next(it), tree)


def draw_keep_neg(generator: Optional[torch.Generator],
                  labels0: torch.Tensor, labels1: torch.Tensor,
                  mesh: Mesh) -> torch.Tensor:
    """The distillation keep-masks (B_local, 2, h*w) of this rank's items:
    the uniforms of the whole global batch drawn in the single-device
    step's order (item by item, view 0 then view 1), this rank's kept,
    compared with each item's keep probability."""
    b, h, w = labels0.shape
    dev = labels0.device
    u = torch.stack([torch.rand((h * w,), generator=generator, device=dev)
                     for _ in range(2 * b * mesh.size("data"))])
    i = mesh.index("data")
    u = u.reshape(-1, 2, h * w)[i * b:(i + 1) * b]
    p = torch.stack([torch.stack([distill_keep_probability(a),
                                  distill_keep_probability(c)])
                     for a, c in zip(labels0, labels1)])
    return u < p[..., None]


def make_sharded_train_step(mesh: Mesh, state: Dict[str, Any],
                            batch: Dict[str, torch.Tensor],
                            cfg: TrainConfig):
    """The train step over `mesh` (`batch`, an example batch, is not read:
    the JAX signature, whose jit takes its shardings from it). Returns
    (step_fn, sharded_state, shard_batch): `shard_batch(global batch)`
    is this rank's share over
    'data'; `step_fn(sharded_state, local batch, generator, keep_neg=None)`
    returns (new sharded state, the global batch's metrics). Every rank
    passes a generator seeded alike, or the global batch's keep-masks
    (B, 2, h*w). `gather_state` rebuilds the whole state."""
    pspec = param_pspecs(state["params"])
    sharded = optim.tree_leaves(optim.tree_map(
        lambda _, s: "model" in s, state["params"], pspec))

    def norm_fn(tree):
        sq = [(x * x).sum() for x in optim.tree_leaves(tree)]
        rep = sum(q for q, sh in zip(sq, sharded) if not sh)
        part = sum(q for q, sh in zip(sq, sharded) if sh)
        return torch.sqrt(rep + mesh.all_reduce(part, "model"))

    def shard_batch(b: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return shard_on(mesh, dict(b), "data", 0)

    def step_fn(state: Dict[str, Any], local: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator],
                keep_neg: Optional[torch.Tensor] = None):
        if keep_neg is not None:   # the global batch's, given
            keep_neg = shard_on(mesh, keep_neg, "data", 0)
        elif cfg.use_distill and "distill_labels0" in local:
            keep_neg = draw_keep_neg(generator, local["distill_labels0"],
                                     local["distill_labels1"], mesh)
        with full_fp32_convs(), full_fp32_matmuls():
            _, (metrics, stats), grads = optim.value_and_grad(
                lambda p: loss_fn(p, local, generator, cfg, keep_neg, mesh),
                state["params"], frozen=BN_STATS)
        with torch.no_grad():
            grads = _sum_over(mesh, grads, "data")
            updates, opt_state = make_optimizer(cfg, norm_fn).update(
                grads, state["opt_state"], state["params"])
            params = optim.apply_updates(state["params"], updates)
            params = _update_running_stats(params, stats, cfg.bn_momentum)
        return {"params": params, "opt_state": opt_state,
                "step": state["step"] + 1}, metrics

    return step_fn, shard_state(mesh, state), shard_batch

