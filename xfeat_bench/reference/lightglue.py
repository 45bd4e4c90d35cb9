"""LightGlue in plain PyTorch, one pair at a time, following
`LightGlue._forward` of cvg/LightGlue (`lightglue/lightglue.py`,
Lindenberger, Sarlin and Pollefeys, ICCV 2023) at its `default_conf`:

- keypoints centred on the image and divided by half its larger side; the
  learnable Fourier encoding `posenc.Wr` (2 -> head_dim / 2), its cos and
  sin repeated pairwise, rotates every head's q and k in self-attention
  (`apply_cached_rotary_emb` on (heads, N, head_dim));
- `input_proj`, then `n_layers` layers, each a self-attention block on
  either image and a cross-attention block between them. Self-attention
  unflattens `Wqkv`'s outputs as (heads, head_dim, 3) and takes q, k, v
  as `[..., 0]`, `[..., 1]`, `[..., 2]`; cross-attention splits `to_qk`
  and `to_v` into heads, scales both sides by head_dim^-1/4 and takes the
  softmax of one similarity along either axis. A block adds to x an MLP
  over [x, message]: linear 2d -> 2d, LayerNorm, GELU (erf), linear
  2d -> d;
- after every layer but the last, with `depth_confidence` > 0, each side's
  token confidence sigmoid(`token_confidence.{i}`(x)); the pair stops
  (`check_if_stop`) when 1 - (confidences below
  clip(0.8 + 0.1 exp(-4 i / n_layers), 0, 1)) / (m + n) exceeds
  `depth_confidence`, m + n the pair's points at the input, so a pruned
  point counts as confident;
- if it goes on, on a side whose current number of points exceeds
  `pruning_min_kpts`, a point stays while sigmoid(matchability) under
  that layer's assignment head exceeds 1 - `width_confidence`, or its
  confidence is at most the threshold (`get_pruning_mask`); pruned points
  are gathered out and never come back;
- the assignment head of the layer the pair stopped at (the last one if
  it never stopped): final_proj scaled by d^-1/4, the similarity,
  matchability logits, the log double softmax with dustbins; mutual argmax
  over the kept points, before any score threshold (as `lighterglue.py`
  here); a match's score exp(best log score).

One departure from the published model: `input_dim` is 64, XFeat's
descriptor width (the published checkpoints take 256 or 128).

The weights are the published state dict (`seeded.py` draws one), read by
`weights_from_state_dict`. `force` and `force_exit` let the judge make a
pruning or exit decision go the other way at a given layer; each decision
taken is returned with its margin, so that a near-tie can be told from a
wrong decision.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from . import seeded
from .lighterglue import _encode, _ffn, _lin, _rotate_half, log_assignment
from .precision import Products


def weights_from_state_dict(sd: Dict[str, torch.Tensor],
                            conf: Dict[str, Any]) -> Dict[str, Any]:
    """A state dict in the published layout -> linear weights (in, out),
    `Wqkv`'s outputs in their published order, `posenc_wr`
    (2, head_dim / 2), and `token_confidence` for layers 0 .. n - 2."""
    def lin(name):
        return {"w": sd[name + ".weight"].T.contiguous(),
                "b": sd[name + ".bias"]}

    def block(name, linears):
        p = {k: lin(f"{name}.{v}") for k, v in linears.items()}
        p["ffn0"], p["ffn1"] = lin(name + ".ffn.0"), lin(name + ".ffn.3")
        p["ln"] = {"w": sd[name + ".ffn.1.weight"],
                   "b": sd[name + ".ffn.1.bias"]}
        return p

    n = conf["n_layers"]
    return {
        "input_proj": lin("input_proj"),
        "posenc_wr": sd["posenc.Wr.weight"].T.contiguous(),
        "layers": [{"self": block(f"self_attn.{i}",
                                  {"Wqkv": "Wqkv", "out": "out_proj"}),
                    "cross": block(f"cross_attn.{i}",
                                   {"to_qk": "to_qk", "to_v": "to_v",
                                    "to_out": "to_out"})}
                   for i in range(n)],
        "assignments": [{"matchability": lin(f"log_assignment.{i}."
                                             "matchability"),
                         "final_proj": lin(f"log_assignment.{i}.final_proj")}
                        for i in range(n)],
        "token_confidence": [lin(f"token_confidence.{i}.token.0")
                             for i in range(n - 1)]}


def weights(entry: Any, conf: Dict[str, Any], device) -> Dict[str, Any]:
    """A configuration's matcher weights: `{"seed": n}`, drawn in the
    published layout by `seeded.py`."""
    if not (isinstance(entry, dict) and "seed" in entry):
        raise ValueError(f"LightGlue's reference takes seeded weights; got "
                         f"{entry!r}")
    return weights_from_state_dict(
        seeded.lighterglue_state_dict(conf, entry["seed"], device), conf)


def confidence_threshold(layer: int, n_layers: int) -> float:
    return min(max(0.8 + 0.1 * math.exp(-4.0 * layer / n_layers), 0.0), 1.0)


def _rotate(t, enc):
    cos, sin = enc
    return t * cos + _rotate_half(t) * sin


def _attend(prod, q, k, v):
    sim = prod.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    return prod.matmul(F.softmax(sim, dim=-1), v)


def _self_block(prod, p, x, enc, heads):
    qkv = _lin(prod, p["Wqkv"], x).unflatten(-1, (heads, -1, 3))
    qkv = qkv.transpose(0, 1)                        # (heads, N, hd, 3)
    q, k, v = qkv[..., 0], qkv[..., 1], qkv[..., 2]
    ctx = _attend(prod, _rotate(q, enc), _rotate(k, enc), v)
    message = _lin(prod, p["out"], ctx.transpose(0, 1).flatten(-2))
    return _ffn(prod, p, x, message)


def _cross_block(prod, p, x0, x1, heads):
    def split(t):                                    # -> (heads, N, hd)
        return t.unflatten(-1, (heads, -1)).transpose(0, 1)

    qk0, qk1 = split(_lin(prod, p["to_qk"], x0)), \
        split(_lin(prod, p["to_qk"], x1))
    v0, v1 = split(_lin(prod, p["to_v"], x0)), split(_lin(prod, p["to_v"],
                                                          x1))
    s = qk0.shape[-1] ** -0.25
    sim = prod.matmul(qk0 * s, (qk1 * s).transpose(-1, -2))
    m0 = prod.matmul(F.softmax(sim, dim=-1), v1)
    m1 = prod.matmul(F.softmax(sim.transpose(-1, -2), dim=-1), v0)
    m0, m1 = (_lin(prod, p["to_out"], t.transpose(0, 1).flatten(-2))
              for t in (m0, m1))
    return _ffn(prod, p, x0, m0), _ffn(prod, p, x1, m1)


def run_layer(prod, layer, x, enc, heads):
    """One layer on both sides: self-attention, then cross-attention."""
    x = [_self_block(prod, layer["self"], x[s], enc[s], heads)
         for s in (0, 1)]
    return list(_cross_block(prod, layer["cross"], x[0], x[1], heads))


def _logit(p: float) -> float:
    return math.log(p / (1.0 - p))


def exit_decision(logits: torch.Tensor, threshold: float, points: int,
                  depth_confidence: float) -> Tuple[bool, float]:
    """`check_if_stop` on the token logits of the kept points of both
    sides -> (stop, margin). The margin is how far, in logits, the k-th
    nearest point has to move across the threshold for the decision to
    turn, k the fewest points whose crossing turns it (inf when too few
    points lie on that side)."""
    unsure = torch.sigmoid(logits) < threshold
    ratio = 1.0 - unsure.float().sum() / points
    stop = bool(ratio > depth_confidence)
    counts = torch.arange(points + 1, dtype=torch.float32,
                          device=logits.device)
    stops = ((1.0 - counts / points) > depth_confidence).tolist()
    u = int(unsure.sum())
    if stop:
        turn = [c for c in range(u, points + 1) if not stops[c]]
        dist = (logits[~unsure] - _logit(threshold)).abs()
    else:
        turn = [c for c in range(u, -1, -1) if stops[c]]
        dist = (_logit(threshold) - logits[unsure]).abs()
    if not turn:
        return stop, math.inf
    k = abs(turn[0] - u)
    if k > dist.numel():
        return stop, math.inf
    return stop, float(torch.sort(dist).values[k - 1])


@torch.no_grad()
def forward_pair(params: Dict[str, Any], conf: Dict[str, Any],
                 kpts0: torch.Tensor, kpts1: torch.Tensor,
                 descs0: torch.Tensor, descs1: torch.Tensor,
                 size0: torch.Tensor, size1: torch.Tensor,
                 precision: str = "full",
                 force: Optional[Dict[Tuple[int, int, int], bool]] = None,
                 force_exit: Optional[Dict[int, bool]] = None
                 ) -> Dict[str, Any]:
    """One pair's valid points: kpts (N,2) xy, descs (N, input_dim),
    size (2,) (W, H). `force` maps (side, point, layer) to keep: at that
    layer the point's pruning decision is `keep`; `force_exit` maps a
    layer to stop: after it the exit decision is `stop`.

    Returns `scores` (M'+1, N'+1) over the points kept to the end, `ind`
    [(M',), (N',)] their indices, `matches0` (M,) int64 into image 1 or -1
    and `mscores0` (M,), `layers` the layers run, `exits` a list of
    (layer, stop, margin) of every exit decision taken, `decisions` per
    side a list of (layer, points, margins, kept) of every pruning
    decision taken, each margin max(matchability logit minus the
    threshold's logit, the confidence threshold's logit minus the token
    logit) with depth confidence on (its first term without), and
    `counts`: the points of each side at the input of every layer run."""
    prod = Products(precision)
    force, force_exit = force or {}, force_exit or {}
    heads, n_layers = conf["num_heads"], conf["n_layers"]
    wc, dc = conf["width_confidence"], conf["depth_confidence"]
    thr_logit = _logit(1.0 - wc) if wc > 0 else 0.0
    x = [_lin(prod, params["input_proj"], descs0),
         _lin(prod, params["input_proj"], descs1)]
    enc = [_encode(prod, params["posenc_wr"], kpts0, size0),
           _encode(prod, params["posenc_wr"], kpts1, size1)]
    dev = descs0.device
    points = descs0.shape[0] + descs1.shape[0]
    ind = [torch.arange(descs0.shape[0], device=dev),
           torch.arange(descs1.shape[0], device=dev)]
    exits: List[Tuple[int, bool, float]] = []
    decisions: List[List[Any]] = [[], []]
    counts: List[Tuple[int, int]] = []
    ran = 0
    for i, layer in enumerate(params["layers"]):
        counts.append((int(ind[0].numel()), int(ind[1].numel())))
        if counts[-1][0] == 0 or counts[-1][1] == 0:
            break
        x = run_layer(prod, layer, x, enc, heads)
        ran = i + 1
        if i == n_layers - 1:
            continue
        logits = None
        if dc > 0:
            thr = confidence_threshold(i, n_layers)
            logits = [_lin(prod, params["token_confidence"][i], x[s])[:, 0]
                      for s in (0, 1)]
            stop, margin = exit_decision(torch.cat(logits), thr, points, dc)
            stop = force_exit.get(i, stop)
            exits.append((i, stop, margin))
            if stop:
                break
        if wc <= 0:
            continue
        for s in (0, 1):
            if x[s].shape[0] <= conf["pruning_min_kpts"]:
                continue
            z = _lin(prod, params["assignments"][i]["matchability"],
                     x[s])[:, 0]
            keep = torch.sigmoid(z) > 1.0 - wc
            margin = z - thr_logit
            if logits is not None:
                keep |= torch.sigmoid(logits[s]) <= thr
                margin = torch.maximum(margin, _logit(thr) - logits[s])
            for (side, point, at), value in force.items():
                if side == s and at == i:
                    keep[ind[s] == point] = value
            decisions[s].append((i, ind[s].clone(), margin, keep.clone()))
            x[s], ind[s] = x[s][keep], ind[s][keep]
            enc[s] = (enc[s][0][keep], enc[s][1][keep])
    scores = log_assignment(prod, params["assignments"][max(ran - 1, 0)],
                            x[0], x[1])
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
            "layers": ran, "exits": exits, "decisions": decisions,
            "counts": counts}
