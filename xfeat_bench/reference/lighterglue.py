"""LighterGlue in plain PyTorch, one pair at a time, from the published
LightGlue (`lightglue.py` of cvg/LightGlue, which kornia's copy and
XFeat's `modules/lighterglue.py` run):

- keypoints centred on the image and divided by half its larger side; a
  learnable Fourier encoding (`posenc_wr`, 2 -> head_dim / 2), its cos and
  sin repeated pairwise, rotates q and k of every self-attention;
- `input_proj` (64 -> 96), then `n_layers` layers, each a self-attention
  block on either image and a cross-attention block between them; a block
  adds to x an MLP over [x, message]: linear 2d -> 2d, LayerNorm, GELU
  (erf), linear 2d -> d; attention is softmax(q k^T / sqrt(d)) v;
- width-confidence pruning after every layer but the last, on a side
  whose current number of points exceeds `pruning_min_kpts`: a point
  stays while sigmoid(matchability) > 1 - `width_confidence` under that
  layer's assignment head; pruned points are gathered out and never come
  back (depth confidence is off, so no token confidence takes part);
- the last layer's assignment head: final_proj scaled by d^-1/4, the
  similarity, matchability logits, the log double softmax with dustbins;
  mutual argmax over the kept points; a match's score exp(best log
  score).

`forward_pair` takes the valid points of one pair only, as the published
matcher is called on one pair. `force` lets the judge make a pruning
decision go the other way at a given layer (see `check.py`).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from .precision import Products


def _lin(prod: Products, p: Dict[str, torch.Tensor], x: torch.Tensor):
    return prod.linear(x, p["w"], p["b"])


def _ffn(prod, p, x, message):
    y = _lin(prod, p["ffn0"], torch.cat([x, message], -1))
    y = F.layer_norm(y, y.shape[-1:], p["ln"]["w"], p["ln"]["b"], eps=1e-5)
    return x + _lin(prod, p["ffn1"], F.gelu(y))


def _attend(prod, q, k, v):
    sim = prod.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    return prod.matmul(F.softmax(sim, dim=-1), v)


def _rotate_half(x):
    x = x.unflatten(-1, (-1, 2))
    return torch.stack([-x[..., 1], x[..., 0]], dim=-1).flatten(-2)


def _encode(prod, wr, kpts, size):
    """-> (cos, sin), each (N, head_dim), pairwise repeated."""
    size = size.float()
    kn = (kpts - size / 2) / (size.max() / 2)
    proj = prod.matmul(kn, wr)
    return (torch.repeat_interleave(torch.cos(proj), 2, dim=-1),
            torch.repeat_interleave(torch.sin(proj), 2, dim=-1))


def _self_block(prod, p, x, enc):
    q, k, v = _lin(prod, p["qkv"], x).chunk(3, dim=-1)
    cos, sin = enc
    q = q * cos + _rotate_half(q) * sin
    k = k * cos + _rotate_half(k) * sin
    return _ffn(prod, p, x, _lin(prod, p["out"], _attend(prod, q, k, v)))


def _cross_block(prod, p, x0, x1):
    qk0, qk1 = _lin(prod, p["to_qk"], x0), _lin(prod, p["to_qk"], x1)
    v0, v1 = _lin(prod, p["to_v"], x0), _lin(prod, p["to_v"], x1)
    m0 = _lin(prod, p["to_out"], _attend(prod, qk0, qk1, v1))
    m1 = _lin(prod, p["to_out"], _attend(prod, qk1, qk0, v0))
    return _ffn(prod, p, x0, m0), _ffn(prod, p, x1, m1)


def log_assignment(prod, asg, x0, x1):
    """-> (M+1, N+1) log assignment with dustbins (the corner 0)."""
    d = x0.shape[-1]
    md0 = _lin(prod, asg["final_proj"], x0) / d ** 0.25
    md1 = _lin(prod, asg["final_proj"], x1) / d ** 0.25
    sim = prod.matmul(md0, md1.transpose(-1, -2))
    z0 = _lin(prod, asg["matchability"], x0)[:, 0]
    z1 = _lin(prod, asg["matchability"], x1)[:, 0]
    m, n = sim.shape
    scores = sim.new_zeros((m + 1, n + 1))
    scores[:m, :n] = (F.log_softmax(sim, 1) + F.log_softmax(sim, 0)
                      + F.logsigmoid(z0)[:, None] + F.logsigmoid(z1)[None])
    scores[:m, n] = F.logsigmoid(-z0)
    scores[m, :n] = F.logsigmoid(-z1)
    return scores


@torch.no_grad()
def forward_pair(params: Dict[str, Any], conf: Dict[str, Any],
                 kpts0: torch.Tensor, kpts1: torch.Tensor,
                 descs0: torch.Tensor, descs1: torch.Tensor,
                 size0: torch.Tensor, size1: torch.Tensor,
                 precision: str = "full",
                 force: Optional[Dict[Tuple[int, int, int], bool]] = None
                 ) -> Dict[str, Any]:
    """One pair's valid points: kpts (N,2) xy, descs (N,64), size (2,)
    (W, H). `force` maps (side, point, layer) to keep: at that layer the
    point's pruning decision is `keep`, whatever its matchability says.

    Returns `scores` (M'+1, N'+1) over the points kept to the end,
    `ind` [(M',), (N',)] their indices, `matches0` (M,) int64 into image
    1 or -1 and `mscores0` (M,) (mutual argmax before any score
    threshold), `decisions`: per side a list of (layer, points, logit
    margins, kept) of every pruning decision taken, the margin being the
    matchability logit minus the threshold's logit, and `counts`: the
    points of each side at the input of every layer."""
    prod = Products(precision)
    force = force or {}
    wc = conf["width_confidence"]
    threshold = 1.0 - wc
    thr_logit = math.log(threshold / (1.0 - threshold)) if wc > 0 else 0.0
    x = [_lin(prod, params["input_proj"], descs0),
         _lin(prod, params["input_proj"], descs1)]
    enc = [_encode(prod, params["posenc_wr"], kpts0, size0),
           _encode(prod, params["posenc_wr"], kpts1, size1)]
    dev = descs0.device
    ind = [torch.arange(descs0.shape[0], device=dev),
           torch.arange(descs1.shape[0], device=dev)]
    decisions: List[List[Any]] = [[], []]
    counts: List[Tuple[int, int]] = []
    n_layers = len(params["layers"])
    for i, layer in enumerate(params["layers"]):
        counts.append((int(ind[0].numel()), int(ind[1].numel())))
        if counts[-1][0] == 0 or counts[-1][1] == 0:
            break
        x = [_self_block(prod, layer["self"], x[s], enc[s]) for s in (0, 1)]
        x = list(_cross_block(prod, layer["cross"], x[0], x[1]))
        if i == n_layers - 1 or wc <= 0:
            continue
        for s in (0, 1):
            if x[s].shape[0] <= conf["pruning_min_kpts"]:
                continue
            z = _lin(prod, params["assignments"][i]["matchability"],
                     x[s])[:, 0]
            keep = torch.sigmoid(z) > threshold
            for (side, point, at), value in force.items():
                if side == s and at == i:
                    keep[ind[s] == point] = value
            decisions[s].append((i, ind[s].clone(), z - thr_logit,
                                 keep.clone()))
            x[s], ind[s] = x[s][keep], ind[s][keep]
            enc[s] = (enc[s][0][keep], enc[s][1][keep])
    scores = log_assignment(prod, params["assignments"][-1], x[0], x[1])
    m, n = x[0].shape[0], x[1].shape[0]
    m0 = torch.full((descs0.shape[0],), -1, dtype=torch.int64, device=dev)
    ms0 = torch.zeros((descs0.shape[0],), device=dev)
    if m and n:
        inner = scores[:m, :n]
        best, r = inner.max(dim=1)
        c = inner.argmax(dim=0)
        mutual = c[r] == torch.arange(m, device=dev)
        m0[ind[0][mutual]] = ind[1][r[mutual]]
        ms0[ind[0][mutual]] = torch.exp(best[mutual])
    return {"scores": scores, "ind": ind, "matches0": m0, "mscores0": ms0,
            "decisions": decisions, "counts": counts}
