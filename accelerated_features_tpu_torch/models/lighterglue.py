"""LighterGlue, the attention-based sparse matcher, in PyTorch (counterpart
of the JAX package's `models/lighterglue.py`, inference only), and
LightGlue at its published widths on the same path.

`DEFAULT_CONF` is LighterGlue: 6 layers, 1 head, 96-D, over 64-D XFeat
descriptors. `LIGHTGLUE_CONF` is LightGlue's published `default_conf`
(Lindenberger et al., ICCV 2023; cvg/LightGlue `lightglue/lightglue.py`):
256-D, 9 layers, 4 heads of 64, depth confidence 0.95, width confidence
0.99, over the same 64-D descriptors (`input_proj` 64 -> 256). Both:
keypoints normalized by image size, a learnable Fourier encoding applied
as rotary cos/sin to q and k in self-attention (an encoding of head
width, as published, rotates each head's slice; one of full width, as
the JAX package's multi-head forward takes it, the whole of q and k);
per layer a self-attention block and a cross-attention block, each with a
residual GELU MLP over [x, message]; an assignment head (matchability +
scaled similarity, log double-softmax with dustbins) and a mutual-argmax
filter.

Keypoint sets are fixed-shape (B, M) with validity masks: padded slots
attend nowhere and match nothing. Width-confidence pruning is MASKED, as
in the JAX package: a point whose matchability under layer i's assignment
head is <= 1 - width_confidence leaves every later attention and the
final assignment through the masks; nothing is gathered. With depth
confidence on, after every layer but the last each pair that is not done
yet computes its points' token confidence and stops, as published, once
the share of confident points of its original m + n (a pruned point
counts as confident) exceeds `depth_confidence`; a low-confidence point
is never pruned. Each pair of a batch exits on its own: every layer runs
for the whole batch (no host sync), a pair keeps the descriptors of the
layer it stopped at, and its assignment comes from that layer's head.

On CUDA tensors every attention runs kernel D (`ops/cuda/attention.py`),
at every size; on CPU tensors its plain version. Under a profiler,
`lighterglue_forward` is the range `xfeat.lighterglue`, holding
`.embed`, `.self` (two a layer), `.cross`, `.confidence` (a layer but the
last, with depth confidence on), `.prune` (a layer, when pruning) and
`.assign` (`utils.profiling.span`). The parameter tree keeps the JAX
package's nesting with torch layouts (`models.params.
load_lighterglue_params`): linear weights (out, in), `posenc_wr`
(2, head_dim/2).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.cuda.attention import NEG, flash_attention
from ..ops.precision import full_fp32_matmuls
from ..utils.profiling import span
from .params import (is_state_dict, is_torch_file, load_lighterglue_params,
                     read_torch_file)

DEFAULT_CONF = {
    "input_dim": 64,
    "descriptor_dim": 96,
    "n_layers": 6,
    "num_heads": 1,
    "filter_threshold": 0.1,
    # depth confidence off, width confidence 0.95, engaged above 1536
    # keypoints (the published configuration)
    "width_confidence": 0.95,
    "pruning_min_kpts": 1536,
}

# LightGlue's published default_conf; input_dim is XFeat's descriptor width
# and pruning_min_kpts the published threshold for flash attention
LIGHTGLUE_CONF = {
    "input_dim": 64,
    "descriptor_dim": 256,
    "n_layers": 9,
    "num_heads": 4,
    "filter_threshold": 0.1,
    "depth_confidence": 0.95,
    "width_confidence": 0.99,
    "pruning_min_kpts": 1536,
}


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def _linear_init(gen: torch.Generator, din: int, dout: int
                 ) -> Dict[str, torch.Tensor]:
    bound = 1.0 / math.sqrt(din)
    return {"w": (torch.rand((dout, din), generator=gen) * 2 - 1) * bound,
            "b": (torch.rand((dout,), generator=gen) * 2 - 1) * bound}


def init_lighterglue_params(gen: torch.Generator,
                            conf: Mapping[str, Any] = DEFAULT_CONF
                            ) -> Dict[str, Any]:
    """Random weights drawn from `gen` (a CPU generator), in the port's
    layout. The values are not the JAX package's random init."""
    dim = conf["descriptor_dim"]
    head_dim = dim // conf["num_heads"]

    def ln():
        return {"w": torch.ones(2 * dim), "b": torch.zeros(2 * dim)}

    params: Dict[str, Any] = {
        "input_proj": _linear_init(gen, conf["input_dim"], dim),
        "posenc_wr": torch.randn((2, head_dim // 2), generator=gen),
        "layers": [], "assignments": [], "token_confidence": [],
    }
    for _ in range(conf["n_layers"]):
        params["layers"].append({
            "self": {"qkv": _linear_init(gen, dim, 3 * dim),
                     "out": _linear_init(gen, dim, dim),
                     "ffn0": _linear_init(gen, 2 * dim, 2 * dim),
                     "ln": ln(),
                     "ffn1": _linear_init(gen, 2 * dim, dim)},
            "cross": {"to_qk": _linear_init(gen, dim, dim),
                      "to_v": _linear_init(gen, dim, dim),
                      "to_out": _linear_init(gen, dim, dim),
                      "ffn0": _linear_init(gen, 2 * dim, 2 * dim),
                      "ln": ln(),
                      "ffn1": _linear_init(gen, 2 * dim, dim)},
        })
        params["assignments"].append({
            "matchability": _linear_init(gen, dim, 1),
            "final_proj": _linear_init(gen, dim, dim)})
        params["token_confidence"].append(_linear_init(gen, dim, 1))
    return params


def _t(sd: Mapping[str, Any], key: str) -> torch.Tensor:
    v = sd[key]
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", torch.float32).clone()
    return torch.tensor(np.asarray(v, np.float32))


def _lin(sd: Mapping[str, Any], prefix: str) -> Dict[str, torch.Tensor]:
    """A Linear as the port stores it: weight (out, in) as torch keeps it;
    a missing bias is zeros."""
    w = _t(sd, prefix + ".weight")
    b = _t(sd, prefix + ".bias") if prefix + ".bias" in sd \
        else torch.zeros(w.shape[0])
    return {"w": w, "b": b}


def _qkv_row_perm(dim: int, heads: int) -> np.ndarray:
    """Row permutation from the kornia/official fused Wqkv packing to the
    port's chunked [q | k | v] rows.

    The official SelfBlock does `qkv.unflatten(-1, (heads, -1, 3))` and
    takes q, k, v as `[..., 0]`, `[..., 1]`, `[..., 2]`: output row o of
    Wqkv is (head o // (3*hd), feature (o % (3*hd)) // 3, which o % 3),
    q, k and v interleaved per feature. The forward splits the projection
    into contiguous thirds, so row t of the port's weight is row
    `perm[t]` of Wqkv (the JAX package's permutation, applied there to
    the columns of its (in, out) weight)."""
    hd = dim // heads
    out = np.empty(3 * dim, np.int64)
    t = 0
    for which in range(3):
        for h in range(heads):
            for d in range(hd):
                out[t] = h * 3 * hd + d * 3 + which
                t += 1
    return out


def import_lighterglue_state_dict(sd: Mapping[str, Any],
                                  conf: Mapping[str, Any] = DEFAULT_CONF
                                  ) -> Dict[str, Any]:
    """A torch LightGlue state dict in the kornia layout (tensor or numpy
    values) -> the port's tree on the CPU (linear weights (out, in)).

    Accepts the published names (`self_attn.{i}`, `cross_attn.{i}`, an
    optional `matcher.` prefix) and the renamed ones
    (`transformers.{i}.self_attn`), as the JAX package's function of the
    same name does; Wqkv's rows are permuted by `_qkv_row_perm`."""
    norm = {}
    for k, v in sd.items():
        k = k.replace("matcher.", "")
        for i in range(conf["n_layers"]):
            k = k.replace(f"self_attn.{i}", f"transformers.{i}.self_attn")
            k = k.replace(f"cross_attn.{i}", f"transformers.{i}.cross_attn")
        norm[k] = v
    sd = norm

    def ln(prefix):
        return {"w": _t(sd, prefix + ".weight"), "b": _t(sd, prefix + ".bias")}

    params: Dict[str, Any] = {
        "input_proj": _lin(sd, "input_proj"),
        "posenc_wr": _t(sd, "posenc.Wr.weight").T.contiguous(),
        "layers": [], "assignments": [], "token_confidence": []}
    perm = torch.from_numpy(_qkv_row_perm(conf["descriptor_dim"],
                                          conf["num_heads"]))
    for i in range(conf["n_layers"]):
        s, c = f"transformers.{i}.self_attn", f"transformers.{i}.cross_attn"
        qkv = _lin(sd, s + ".Wqkv")
        params["layers"].append({
            "self": {"qkv": {"w": qkv["w"][perm], "b": qkv["b"][perm]},
                     "out": _lin(sd, s + ".out_proj"),
                     "ffn0": _lin(sd, s + ".ffn.0"),
                     "ln": ln(s + ".ffn.1"),
                     "ffn1": _lin(sd, s + ".ffn.3")},
            "cross": {"to_qk": _lin(sd, c + ".to_qk"),
                      "to_v": _lin(sd, c + ".to_v"),
                      "to_out": _lin(sd, c + ".to_out"),
                      "ffn0": _lin(sd, c + ".ffn.0"),
                      "ln": ln(c + ".ffn.1"),
                      "ffn1": _lin(sd, c + ".ffn.3")}})
        params["assignments"].append({
            "matchability": _lin(sd, f"log_assignment.{i}.matchability"),
            "final_proj": _lin(sd, f"log_assignment.{i}.final_proj")})
        if f"token_confidence.{i}.token.0.weight" in sd:
            params["token_confidence"].append(
                _lin(sd, f"token_confidence.{i}.token.0"))
    return params


def _tree_to(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _apply(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    # full float32 on the card: lighterglue_forward enters full_fp32_matmuls
    return F.linear(x, p["w"], p["b"])


def normalize_keypoints(kpts: torch.Tensor, size: torch.Tensor
                        ) -> torch.Tensor:
    """kpts (B,M,2) xy; size (B,2) (W,H) -> centered, scaled by max-dim/2."""
    size = size.float()
    shift = size / 2.0
    scale = size.max(dim=-1, keepdim=True).values / 2.0
    return (kpts - shift[:, None, :]) / scale[:, None, :]


def rotary_encoding(kpts_n: torch.Tensor, wr: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Learnable Fourier positional encoding -> (cos, sin), each (B,M,D) in
    the pair-repeated layout [c0,c0,c1,c1,...]. `wr` is (2, D/2)."""
    proj = kpts_n @ wr
    return (torch.repeat_interleave(torch.cos(proj), 2, dim=-1),
            torch.repeat_interleave(torch.sin(proj), 2, dim=-1))


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    x = x.reshape(*x.shape[:-1], -1, 2)
    return torch.stack([-x[..., 1], x[..., 0]], dim=-1).flatten(-2)


def apply_rotary(t: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor) -> torch.Tensor:
    return t * cos + _rotate_half(t) * sin


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               mask_k: Optional[torch.Tensor], heads: int) -> torch.Tensor:
    """Scaled dot-product attention on (B,M,D) with an optional key-side
    mask (B,N). Heads are folded into the batch, (B*heads, N, D/heads), so
    on CUDA tensors every head count runs kernel D (`flash_attention`
    takes the plain version on CPU tensors)."""
    b, m, d = q.shape
    if heads == 1:
        return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               mask_k, 1.0 / math.sqrt(d))
    hd = d // heads

    def split(x):  # (B,N,D) -> (B*heads, N, hd)
        return x.reshape(b, -1, heads, hd).transpose(1, 2).reshape(
            b * heads, -1, hd)

    mask_h = None if mask_k is None else \
        mask_k.repeat_interleave(heads, 0).contiguous()
    out = flash_attention(split(q), split(k), split(v), mask_h,
                          1.0 / math.sqrt(hd))
    return out.reshape(b, heads, m, hd).transpose(1, 2).reshape(b, m, d)


def _ffn(p: Dict[str, Any], x: torch.Tensor,
         message: torch.Tensor) -> torch.Tensor:
    y = _apply(p["ffn0"], torch.cat([x, message], dim=-1))
    y = F.layer_norm(y, y.shape[-1:], p["ln"]["w"], p["ln"]["b"], eps=1e-5)
    return x + _apply(p["ffn1"], F.gelu(y))


def _self_block(p, x, cos, sin, mask, heads):
    q, k, v = _apply(p["qkv"], x).chunk(3, dim=-1)
    if cos.shape[-1] == q.shape[-1]:
        # a full-width encoding, as the JAX package applies it at any head
        # count (and every encoding at one head)
        q, k = apply_rotary(q, cos, sin), apply_rotary(k, cos, sin)
    else:
        # a head-width encoding, as published LightGlue's: q and k are
        # head-major (`_qkv_row_perm`), so each head's slice rotates with it
        cos, sin = cos[..., None, :], sin[..., None, :]
        q, k = (apply_rotary(t.unflatten(-1, (heads, -1)), cos, sin)
                .flatten(-2) for t in (q, k))
    ctx = _attention(q, k, v, mask, heads)
    return _ffn(p, x, _apply(p["out"], ctx))


def _cross_block(p, x0, x1, mask0, mask1, heads):
    qk0, qk1 = _apply(p["to_qk"], x0), _apply(p["to_qk"], x1)
    v0, v1 = _apply(p["to_v"], x0), _apply(p["to_v"], x1)
    m0 = _attention(qk0, qk1, v1, mask1, heads)
    m1 = _attention(qk1, qk0, v0, mask0, heads)
    return (_ffn(p, x0, _apply(p["to_out"], m0)),
            _ffn(p, x1, _apply(p["to_out"], m1)))


def sigmoid_log_double_softmax(sim: torch.Tensor, z0: torch.Tensor,
                               z1: torch.Tensor, mask0: torch.Tensor,
                               mask1: torch.Tensor) -> torch.Tensor:
    """(B,M,N) similarity + matchability logits -> (B,M+1,N+1) log
    assignment with dustbins; the corner is -inf."""
    b, m, n = sim.shape
    sim = torch.where(mask1[:, None, :], sim, NEG)
    sim = torch.where(mask0[:, :, None], sim, NEG)
    certainties = (F.logsigmoid(z0)[:, :, None] + F.logsigmoid(z1)[:, None, :])
    # over the rows through a transposed copy: torch's softmax along an
    # inner dimension is far slower on the card than along the last one
    scores1 = torch.log_softmax(sim.transpose(1, 2), dim=2).transpose(1, 2)
    scores = sim.new_full((b, m + 1, n + 1), float("-inf"))
    scores[:, :m, :n] = torch.log_softmax(sim, dim=2) + scores1 + certainties
    scores[:, :m, n] = F.logsigmoid(-z0)
    scores[:, m, :n] = F.logsigmoid(-z1)
    return scores


def get_matchability(asg_params: Dict[str, Any],
                     x: torch.Tensor) -> torch.Tensor:
    """Per-point match probability from a layer's assignment head."""
    return torch.sigmoid(_apply(asg_params["matchability"], x)[..., 0])


def confidence_threshold(layer: int, n_layers: int) -> float:
    """The published token-confidence threshold after `layer`."""
    return float(np.clip(0.8 + 0.1 * np.exp(-4.0 * layer / n_layers), 0, 1))


def _exit_head(asgs, exit_layer: torch.Tensor, x: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each pair's final projection (scaled by d^-1/4) and matchability
    logits under the assignment head of the layer it stopped at
    (`exit_layer` (B,), 0-based): the heads stacked and gathered by pair."""
    def stacked(name, key):
        return torch.stack([a[name][key] for a in asgs])[exit_layer]

    proj = torch.baddbmm(stacked("final_proj", "b")[:, None, :], x,
                         stacked("final_proj", "w").transpose(1, 2))
    z = torch.baddbmm(stacked("matchability", "b")[:, None, :], x,
                      stacked("matchability", "w").transpose(1, 2))
    return proj / x.shape[-1] ** 0.25, z[..., 0]


def filter_matches_from_scores(scores: torch.Tensor, m: int, n: int
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mutual argmax over the (M,N) part of the log assignment; confidence
    = exp(best log score). matches0 is -1 (and the score 0) where not
    mutual. Ties go to the first index."""
    inner = scores[:, :m, :n]
    best, m0 = inner.max(dim=2)
    m1 = inner.argmax(dim=1)
    idx = torch.arange(m, device=scores.device)
    mutual = torch.gather(m1, 1, m0) == idx[None, :]
    return (torch.where(mutual, m0, -1),
            torch.where(mutual, torch.exp(best), 0.0))


@full_fp32_matmuls()
def lighterglue_forward(params: Dict[str, Any], kpts0: torch.Tensor,
                        kpts1: torch.Tensor, descs0: torch.Tensor,
                        descs1: torch.Tensor, size0: torch.Tensor,
                        size1: torch.Tensor,
                        mask0: Optional[torch.Tensor] = None,
                        mask1: Optional[torch.Tensor] = None,
                        heads: int = 1, width_confidence: float = -1.0,
                        pruning_min_kpts: int = 1536,
                        depth_confidence: float = -1.0
                        ) -> Dict[str, torch.Tensor]:
    """Run the matcher on batched tensors; masks select real keypoints.

    `width_confidence` > 0 turns on masked point pruning (module
    docstring) when max(M, N) > `pruning_min_kpts`; a pruned point never
    returns and ends unmatched with score 0. `depth_confidence` > 0 turns
    on each pair's early exit (module docstring), which reads
    `params["token_confidence"][i]` after layer i < n_layers - 1.

    Returns log_assignment (B,M+1,N+1), matches0 (B,M) int64 index into
    image 1 or -1, mscores0 (B,M), keep0 (B,M) / keep1 (B,N) bool, the
    real points that were never pruned, and prune_margin0 (B,M) /
    prune_margin1 (B,N): how close each point's pruning decision came to
    going the other way while the point was still kept (matchability
    against its threshold, and with depth confidence on the larger of that
    and the token confidence below its threshold; inf without pruning),
    which tells where two float32 runs may decide differently. With depth
    confidence on, also layers (B,) int64: the layers each pair ran."""
    with span("xfeat.lighterglue"):
        b, m, _ = kpts0.shape
        n = kpts1.shape[1]
        dev = kpts0.device
        if mask0 is None:
            mask0 = torch.ones((b, m), dtype=torch.bool, device=dev)
        if mask1 is None:
            mask1 = torch.ones((b, n), dtype=torch.bool, device=dev)

        with span("xfeat.lighterglue.embed"):
            x0 = _apply(params["input_proj"], descs0.float())
            x1 = _apply(params["input_proj"], descs1.float())
            cos0, sin0 = rotary_encoding(
                normalize_keypoints(kpts0.float(), size0), params["posenc_wr"])
            cos1, sin1 = rotary_encoding(
                normalize_keypoints(kpts1.float(), size1), params["posenc_wr"])

        do_prune = width_confidence > 0 and max(m, n) > pruning_min_kpts
        do_exit = depth_confidence > 0
        keep = [mask0, mask1]
        margin = [torch.full((b, m), float("inf"), device=dev),
                  torch.full((b, n), float("inf"), device=dev)]
        n_layers = len(params["layers"])
        if do_exit:
            # a pair stopped after layer i holds i + 1 and its descriptors
            # of that layer in `held`
            layers = torch.full((b,), n_layers, dtype=torch.int64, device=dev)
            done = torch.zeros((b,), dtype=torch.bool, device=dev)
            points = (mask0.sum(1) + mask1.sum(1)).float()
            held = [x0, x1]
        for i, layer in enumerate(params["layers"]):
            with span("xfeat.lighterglue.self"):
                x0 = _self_block(layer["self"], x0, cos0, sin0, keep[0], heads)
            with span("xfeat.lighterglue.self"):
                x1 = _self_block(layer["self"], x1, cos1, sin1, keep[1], heads)
            with span("xfeat.lighterglue.cross"):
                x0, x1 = _cross_block(layer["cross"], x0, x1, keep[0], keep[1],
                                      heads)
            if i == n_layers - 1:
                continue
            if do_exit:
                with span("xfeat.lighterglue.confidence"):
                    thr = confidence_threshold(i, n_layers)
                    conf = [torch.sigmoid(_apply(
                        params["token_confidence"][i], x)[..., 0])
                        for x in (x0, x1)]
                    unsure = ((conf[0] < thr) & keep[0]).sum(1) \
                        + ((conf[1] < thr) & keep[1]).sum(1)
                    stop = ((1.0 - unsure.float() / points)
                            > depth_confidence) & ~done
                    layers = torch.where(stop, i + 1, layers)
                    held = [torch.where(stop[:, None, None], x, h)
                            for x, h in zip((x0, x1), held)]
                    done = done | stop
                    # a low-confidence point is never pruned, nor a point
                    # of a pair that stopped
                    low = [thr - c for c in conf]
            if do_prune:
                with span("xfeat.lighterglue.prune"):
                    for side, x in enumerate((x0, x1)):
                        over = get_matchability(params["assignments"][i], x) \
                            - (1.0 - width_confidence)
                        stays = over > 0
                        live = keep[side]
                        if do_exit:
                            stays = stays | (low[side] >= 0) | done[:, None]
                            over = torch.maximum(over, low[side])
                            live = live & ~done[:, None]
                        margin[side] = torch.where(
                            live, torch.minimum(margin[side], over.abs()),
                            margin[side])
                        keep[side] = keep[side] & stays
        keep0, keep1 = keep

        with span("xfeat.lighterglue.assign"):
            if do_exit:
                x0, x1 = (torch.where(done[:, None, None], h, x)
                          for x, h in zip((x0, x1), held))
                md0, z0 = _exit_head(params["assignments"], layers - 1, x0)
                md1, z1 = _exit_head(params["assignments"], layers - 1, x1)
                sim = torch.matmul(md0, md1.transpose(1, 2))
            else:
                asg = params["assignments"][-1]
                dim = x0.shape[-1]
                md0 = _apply(asg["final_proj"], x0) / dim ** 0.25
                md1 = _apply(asg["final_proj"], x1) / dim ** 0.25
                sim = torch.matmul(md0, md1.transpose(1, 2))
                z0 = _apply(asg["matchability"], x0)[..., 0]
                z1 = _apply(asg["matchability"], x1)[..., 0]
            scores = sigmoid_log_double_softmax(sim, z0, z1, keep0, keep1)
            m0, ms0 = filter_matches_from_scores(scores, m, n)
            if do_prune:
                m0 = torch.where(keep0, m0, -1)
                ms0 = torch.where(keep0, ms0, 0.0)
        out = {"log_assignment": scores, "matches0": m0, "mscores0": ms0,
               "keep0": keep0, "keep1": keep1,
               "prune_margin0": margin[0], "prune_margin1": margin[1]}
        if do_exit:
            out["layers"] = layers
        return out


# ---------------------------------------------------------------------------
# user-facing wrapper
# ---------------------------------------------------------------------------

class LighterGlue:
    """Inference wrapper. `weights`: a matcher `.npz` path (the JAX
    package's format; a full train state works too), a training checkpoint
    directory, a `.pt`/`.pth` path or an in-memory state dict in the
    kornia LightGlue layout (`import_lighterglue_state_dict`), a
    JAX-layout numpy tree, or None for random weights drawn from
    `generator` (seed 0 when none is given). `device` is required: the
    caller decides where it runs."""

    def __init__(self, weights: Optional[Union[str, Mapping[str, Any]]],
                 device: Union[str, torch.device],
                 conf: Mapping[str, Any] = DEFAULT_CONF,
                 generator: Optional[torch.Generator] = None):
        self.conf = dict(conf)
        self.device = torch.device(device)
        if weights is None:
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            params = init_lighterglue_params(generator, self.conf)
        elif is_torch_file(weights):
            params = import_lighterglue_state_dict(read_torch_file(weights),
                                                   self.conf)
        elif is_state_dict(weights):
            params = import_lighterglue_state_dict(weights, self.conf)
        else:
            params = load_lighterglue_params(weights)
        self.params = _tree_to(params, self.device)

    def _padded(self, x: Any, k: int) -> torch.Tensor:
        """(N,C) array or tensor -> (1,K,C) float32 on the device, zero
        rows after the first N."""
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        out = x.new_zeros((1, k, x.shape[1]))
        out[0, :x.shape[0]] = x
        return out

    @torch.inference_mode()
    def forward_padded(self, d0: Mapping[str, Any], d1: Mapping[str, Any]
                       ) -> Dict[str, torch.Tensor]:
        """`lighterglue_forward` on one pair, both sets padded to one
        power-of-two bucket (at least 16). Pruning is decided on the real
        keypoint counts, not on the bucket."""
        n0, n1 = len(d0["keypoints"]), len(d1["keypoints"])
        k = 1 << (max(n0, n1, 16) - 1).bit_length()
        wc = self.conf.get("width_confidence", -1.0)
        if not (wc > 0 and max(n0, n1) > self.conf.get("pruning_min_kpts",
                                                       1536)):
            wc = -1.0
        ar = torch.arange(k, device=self.device)[None]

        def size(d):
            return torch.as_tensor(d["image_size"], dtype=torch.float32,
                                   device=self.device)[None]

        return lighterglue_forward(
            self.params, self._padded(d0["keypoints"], k),
            self._padded(d1["keypoints"], k),
            self._padded(d0["descriptors"], k),
            self._padded(d1["descriptors"], k), size(d0), size(d1),
            ar < n0, ar < n1, heads=self.conf["num_heads"],
            width_confidence=wc, pruning_min_kpts=0,
            depth_confidence=self.conf.get("depth_confidence", -1.0))

    @torch.inference_mode()
    def match(self, d0: Mapping[str, Any], d1: Mapping[str, Any],
              min_conf: float = 0.1) -> torch.Tensor:
        """d0/d1: 'keypoints' (N,2), 'descriptors' (N,64) as tensors or
        arrays, 'image_size' (W,H). Returns the matched index pairs, an
        (S,2) int64 tensor on the device."""
        n0, n1 = len(d0["keypoints"]), len(d1["keypoints"])
        out = self.forward_padded(d0, d1)
        m0, ms0 = out["matches0"][0], out["mscores0"][0]
        ar = torch.arange(m0.shape[0], device=self.device)
        rows = torch.nonzero((m0 >= 0) & (ms0 > min_conf) & (ar < n0))[:, 0]
        cols = m0[rows]
        keep = cols < n1
        return torch.stack([rows[keep], cols[keep]], dim=-1)
