"""XFeat backbone and heads in PyTorch (inference, folded BatchNorm).

Counterpart of the JAX package's `models/backbone.py`: the same five conv
blocks with the avg-pool skip, the bilinear pyramid fusion, the
reliability head and the keypoint head on the 8x8 space-to-depth of the
normalized image. Inside it runs NCHW with `F.conv2d`; at its edges it
keeps the JAX layouts: images (B,H,W,C) in, NHWC `feats`, `logits` and
`heat` out.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.cuda.stem_fused import stem_fused
from ..ops.precision import full_fp32_convs

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


def _basic(p: Dict[str, torch.Tensor], x: torch.Tensor,
           stride: int = 1) -> torch.Tensor:
    """Conv + folded BatchNorm + ReLU."""
    if "b" not in p:
        raise ValueError("inference needs BatchNorm folded into the conv "
                         "biases (models.params.fold_batchnorm)")
    return F.relu(_conv(x, p, stride))


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


def stem_unfused(params: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """block1 and the avg-pool skip as the backbone's own convs, in the
    dtype of the normalized gray image x (B,1,H,W) -> (B,24,H/4,W/4)."""
    x1 = x
    for p, s in zip(params["block1"], BLOCK_STRIDES["block1"]):
        x1 = _basic(p, x1, s)
    return x1 + _conv(F.avg_pool2d(x, 4, 4), params["skip1"])


def xfeat_forward(params: Dict[str, Any], x: torch.Tensor, *,
                  compute_dtype: torch.dtype = torch.float32,
                  fused_stem: bool = False):
    """(B,H,W,C) float images in [0,1], H and W divisible by 32 ->
    feats (B,H/8,W/8,64), logits (B,H/8,W/8,65), heat (B,H/8,W/8,1), all
    in `compute_dtype`.

    `compute_dtype`: float32 or bfloat16. The input is normalized in
    float32 and then cast; every conv runs in that dtype.
    `fused_stem`: run block1 and the skip as the fused stem kernel
    (`ops/cuda/stem_fused.py`) on CUDA tensors, and as its plain version on
    CPU tensors. An explicit keyword only; no environment variable sets
    it."""
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute_dtype must be float32 or bfloat16, got "
                         f"{compute_dtype}")
    with full_fp32_convs():
        x = input_norm(x.float()).to(compute_dtype)

        # stem_fused raises on unfolded BatchNorm
        y = stem_fused(params, x) if fused_stem else stem_unfused(params, x)
        outs = {}
        for name in ("block2", "block3", "block4", "block5"):
            for p, s in zip(params[name], BLOCK_STRIDES[name]):
                y = _basic(p, y, s)
            outs[name] = y

        x3 = outs["block3"]
        hw = (x3.shape[2], x3.shape[3])
        fused = x3 + _upsample(outs["block4"], hw) + _upsample(outs["block5"],
                                                               hw)
        for p in params["block_fusion"][:-1]:
            fused = _basic(p, fused)
        feats = _conv(fused, params["block_fusion"][-1])

        h = feats
        for p in params["heatmap_head"][:-1]:
            h = _basic(p, h)
        heat = torch.sigmoid(_conv(h, params["heatmap_head"][-1]))

        # channel = 8*dy + dx, the JAX package's space_to_depth order
        k = F.pixel_unshuffle(x, 8)
        for p in params["keypoint_head"][:-1]:
            k = _basic(p, k)
        logits = _conv(k, params["keypoint_head"][-1])

    def nhwc(t):
        return t.permute(0, 2, 3, 1).contiguous()

    return nhwc(feats), nhwc(logits), nhwc(heat)


def fine_matcher_forward(params: Dict[str, Any],
                         x: torch.Tensor) -> torch.Tensor:
    """Fine-matcher MLP 128 -> 512 x4 -> 64 on (..., 128) concatenated
    descriptor pairs (inference: BatchNorm folded into the four hidden
    layers). Full float32 on the card inside `full_fp32_matmuls`, which
    `ops.refine.refine_matches` enters."""
    mlp = params["fine_matcher"]
    if any("mean" in layer for layer in mlp):
        raise ValueError("inference needs BatchNorm folded into the fine "
                         "matcher (models.params.fold_batchnorm)")
    for layer in mlp[:-1]:
        x = F.relu(F.linear(x, layer["w"], layer["b"]))
    return F.linear(x, mlp[-1]["w"], mlp[-1]["b"])


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
