"""XFeat backbone and heads in PyTorch: inference with folded BatchNorm,
and training with batch statistics.

Counterpart of the JAX package's `models/backbone.py`: the same five conv
blocks with the avg-pool skip, the bilinear pyramid fusion, the
reliability head and the keypoint head on the 8x8 space-to-depth of the
normalized image. Inside it runs NCHW with `F.conv2d`; at its edges it
keeps the JAX layouts: images (B,H,W,C) in, NHWC `feats`, `logits` and
`heat` out.

`train=True` normalizes every affine-free BatchNorm with the batch mean
and biased variance and returns, per layer, the batch mean and unbiased
variance for the trainer's running-average update (JAX
`backbone._basic_layer`).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.cuda.stem_fused import stem_fused
from ..ops.precision import full_fp32_convs
from .params import BN_EPS

IN_EPS = 1e-5  # torch InstanceNorm2d default eps

# conv strides per block (kernel sizes follow from the weights)
BLOCK_STRIDES = {
    "block1": [1, 2, 1, 2],
    "block2": [1, 1],
    "block3": [2, 1, 1],
    "block4": [2, 1, 1],
    "block5": [2, 1, 1, 1],
}


def _conv(x: torch.Tensor, p: Dict[str, torch.Tensor],
          stride: int = 1) -> torch.Tensor:
    """Conv with pad = k // 2; weight and bias are cast to the activation's
    dtype here, for every conv of the backbone (bfloat16 convs accumulate
    in float32 inside cuDNN)."""
    b = p.get("b")
    return F.conv2d(x, p["w"].to(x.dtype),
                    None if b is None else b.to(x.dtype), stride=stride,
                    padding=p["w"].shape[-1] // 2)


def _batch_norm(x: torch.Tensor, dims: Tuple[int, ...],
                stats_out: Optional[list],
                valid: Optional[torch.Tensor] = None,
                reduce: Optional[Callable] = None) -> torch.Tensor:
    """Affine-free BatchNorm with batch statistics over `dims`: mean and
    biased variance in float32, over the rows where `valid` holds when it
    is given, applied in x's dtype (the JAX package's arithmetic); appends
    {mean, unbiased var} to `stats_out`.

    `reduce` (data parallelism, `parallel.mesh.AxisSum`) sums a tensor
    over the ranks that hold the rest of the batch, with its gradient;
    the statistics are then the global batch's, in two passes (the sum,
    then the squared deviations from the global mean) as one device
    computes them."""
    xf = x.float()
    if reduce is not None:
        if valid is not None:
            raise ValueError("a reduced BatchNorm takes no row mask")
        n = float(xf.numel() // xf.shape[1 if xf.dim() == 4 else -1]) \
            * reduce.size
        shape = [1, -1, 1, 1] if x.dim() == 4 else [-1]
        mean = reduce(xf.sum(dim=dims)) / n
        var = reduce(((xf - mean.reshape(shape)) ** 2).sum(dim=dims)) / n
        unbiased = var * n / max(n - 1.0, 1.0)
    elif valid is None:
        mean = xf.mean(dim=dims)
        var = xf.var(dim=dims, unbiased=False)
        n = float(xf.numel() // xf.shape[1 if xf.dim() == 4 else -1])
        unbiased = var * n / max(n - 1.0, 1.0)
    else:
        m = valid[..., None].float()
        nt = m.sum().clamp_min(1.0)
        mean = (xf * m).sum(dim=dims) / nt
        var = (m * (xf - mean) ** 2).sum(dim=dims) / nt
        unbiased = var * nt / (nt - 1.0).clamp_min(1.0)
    if stats_out is not None:
        stats_out.append({"mean": mean.detach(), "var": unbiased.detach()})
    shape = [1, -1, 1, 1] if x.dim() == 4 else [-1]
    inv = torch.rsqrt(var + BN_EPS)
    return (x - mean.reshape(shape).to(x.dtype)) * inv.reshape(shape).to(
        x.dtype)


def _basic(p: Dict[str, torch.Tensor], x: torch.Tensor, stride: int = 1,
           stats_out: Optional[list] = None,
           reduce: Optional[Callable] = None) -> torch.Tensor:
    """Conv + BatchNorm + ReLU: the BatchNorm folded into the conv's bias
    (inference), or with batch statistics when `stats_out` is a list
    (training; `reduce` as in `_batch_norm`)."""
    if "b" in p:
        return F.relu(_conv(x, p, stride))
    if stats_out is None:
        raise ValueError("inference needs BatchNorm folded into the conv "
                         "biases (models.params.fold_batchnorm)")
    return F.relu(_batch_norm(_conv(x, p, stride), (0, 2, 3), stats_out,
                              reduce=reduce))


def space_to_depth(x: torch.Tensor, ws: int = 8) -> torch.Tensor:
    """(B,H,W,C) -> (B,H/ws,W/ws,ws*ws*C), channel 8*dy + dx for C = 1
    (the reference's `_unfold2d` order; NHWC as in the JAX package)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // ws, w // ws, ws * ws * c)


def upsample_bilinear(x: torch.Tensor, out_hw: Tuple[int, int]
                      ) -> torch.Tensor:
    """(B,H,W,C) -> (B,h,w,C), half-pixel bilinear (torch
    `align_corners=False`); NHWC as in the JAX package."""
    return _upsample(x.permute(0, 3, 1, 2), tuple(out_hw)) \
        .permute(0, 2, 3, 1).contiguous()


def input_norm(x: torch.Tensor) -> torch.Tensor:
    """(B,H,W,C) -> (B,1,H,W): channel mean, then instance norm with the
    biased variance."""
    x = x.mean(dim=-1).unsqueeze(1)
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = x.var(dim=(2, 3), keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + IN_EPS)


def _upsample(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    # half-pixel bilinear == jax.image.resize(bilinear, antialias=False)
    return F.interpolate(x, size=hw, mode="bilinear", align_corners=False)


def stem_unfused(params: Dict[str, Any], x: torch.Tensor,
                 stats: Optional[Dict[str, list]] = None,
                 bn_reduce: Optional[Callable] = None) -> torch.Tensor:
    """block1 and the avg-pool skip as the backbone's own convs, in the
    dtype of the normalized gray image x (B,1,H,W) -> (B,24,H/4,W/4).
    With `stats`, block1 normalizes with batch statistics and records
    them under stats["block1"]."""
    x1 = x
    sub = None if stats is None else stats.setdefault("block1", [])
    for p, s in zip(params["block1"], BLOCK_STRIDES["block1"]):
        x1 = _basic(p, x1, s, sub, bn_reduce)
    return x1 + _conv(F.avg_pool2d(x, 4, 4), params["skip1"])


def xfeat_forward(params: Dict[str, Any], x: torch.Tensor, *,
                  compute_dtype: torch.dtype = torch.float32,
                  fused_stem: bool = False, train: bool = False,
                  bn_reduce: Optional[Callable] = None):
    """(B,H,W,C) float images in [0,1], H and W divisible by 32 ->
    feats (B,H/8,W/8,64), logits (B,H/8,W/8,65), heat (B,H/8,W/8,1), all
    in `compute_dtype`; with `train=True` also the BatchNorm batch
    statistics, {block: [{mean, var}, ...]} (var unbiased), as the JAX
    package returns them.

    `compute_dtype`: float32 or bfloat16 (or float64, to check the
    training arithmetic on the CPU). The input is normalized in float32 and
    then cast; every conv runs in that dtype; BatchNorm statistics are
    float32 (as in the JAX package).
    `fused_stem`: run block1 and the skip as the fused stem kernel
    (`ops/cuda/stem_fused.py`) on CUDA tensors, and as its plain version on
    CPU tensors; inference only. An explicit keyword only; no environment
    variable sets it.
    `bn_reduce`: with `train=True` under data parallelism, the sum over
    the ranks that hold the rest of the batch (`parallel.mesh.AxisSum`),
    so that every BatchNorm normalizes with the global batch's
    statistics."""
    if compute_dtype not in (torch.float32, torch.bfloat16, torch.float64):
        raise ValueError(f"compute_dtype must be float32 or bfloat16, got "
                         f"{compute_dtype}")
    if fused_stem and train:
        raise ValueError("fused_stem=True requires inference (train=False) "
                         "and BatchNorm folded into conv biases "
                         "(models.params.fold_batchnorm)")
    stats: Optional[Dict[str, List]] = {} if train else None

    def block(name, y, strides):
        sub = None if stats is None else stats.setdefault(name, [])
        for p, s in zip(params[name], strides):
            y = _basic(p, y, s, sub, bn_reduce)
        return y

    with full_fp32_convs():
        # the input normalization carries no gradient (JAX: stop_gradient)
        x = input_norm(x.float()).detach().to(compute_dtype)

        # stem_fused raises on unfolded BatchNorm
        y = stem_fused(params, x) if fused_stem else \
            stem_unfused(params, x, stats, bn_reduce)
        outs = {}
        for name in ("block2", "block3", "block4", "block5"):
            y = outs[name] = block(name, y, BLOCK_STRIDES[name])

        x3 = outs["block3"]
        hw = (x3.shape[2], x3.shape[3])
        fused = x3 + _upsample(outs["block4"], hw) + _upsample(outs["block5"],
                                                               hw)
        fused = block("block_fusion", fused, [1, 1])
        feats = _conv(fused, params["block_fusion"][-1])

        h = block("heatmap_head", feats, [1, 1])
        heat = torch.sigmoid(_conv(h, params["heatmap_head"][-1]))

        # channel = 8*dy + dx, the JAX package's space_to_depth order
        k = block("keypoint_head", F.pixel_unshuffle(x, 8), [1, 1, 1])
        logits = _conv(k, params["keypoint_head"][-1])

    def nhwc(t):
        return t.permute(0, 2, 3, 1).contiguous()

    if train:
        return nhwc(feats), nhwc(logits), nhwc(heat), stats
    return nhwc(feats), nhwc(logits), nhwc(heat)


def fine_matcher_forward(params: Dict[str, Any], x: torch.Tensor, *,
                         train: bool = False,
                         valid: Optional[torch.Tensor] = None):
    """Fine-matcher MLP 128 -> 512 x4 -> 64 on (..., 128) concatenated
    descriptor pairs. Inference: BatchNorm folded into the four hidden
    layers. `train=True`: BatchNorm1d with batch statistics over every
    leading dimension, only the rows where `valid` (...) holds when it is
    given; returns (logits, [{mean, var}] x4), var unbiased, as the JAX
    package does. Full float32 on the card inside `full_fp32_matmuls`,
    which `ops.refine.refine_matches` and the trainer enter."""
    mlp = params["fine_matcher"]
    if not train and any("mean" in layer for layer in mlp):
        raise ValueError("inference needs BatchNorm folded into the fine "
                         "matcher (models.params.fold_batchnorm)")
    stats: Optional[list] = [] if train else None
    dims = tuple(range(x.dim() - 1))
    for layer in mlp[:-1]:
        x = F.linear(x, layer["w"], layer["b"])
        if train:
            x = _batch_norm(x, dims, stats, valid)
        x = F.relu(x)
    x = F.linear(x, mlp[-1]["w"], mlp[-1]["b"])
    return (x, stats) if train else x


class XFeatModel(nn.Module):
    """The backbone as a module: holds a folded parameter tree as buffers
    (so `.to(device)` moves it) and runs `xfeat_forward`."""

    def __init__(self, params: Dict[str, Any]):
        super().__init__()
        self._layout = self._register(params, "")

    def _register(self, node, prefix):
        if isinstance(node, dict):
            return {k: self._register(v, f"{prefix}{k}_") for k, v in
                    node.items()}
        if isinstance(node, (list, tuple)):
            return [self._register(v, f"{prefix}{i}_")
                    for i, v in enumerate(node)]
        name = prefix[:-1]
        self.register_buffer(name, node)
        return name

    @property
    def params(self) -> Dict[str, Any]:
        def build(node):
            if isinstance(node, dict):
                return {k: build(v) for k, v in node.items()}
            if isinstance(node, list):
                return [build(v) for v in node]
            return getattr(self, node)
        return build(self._layout)

    def forward(self, x: torch.Tensor, *,
                compute_dtype: torch.dtype = torch.float32,
                fused_stem: bool = False):
        return xfeat_forward(self.params, x, compute_dtype=compute_dtype,
                             fused_stem=fused_stem)
