"""Extraction pipelines, sparse and semi-dense (counterpart of the JAX
package's `ops/extraction.py`).

Sparse (`detect_and_compute`): on CUDA tensors the keypoint selection runs
the fused detect kernel and the descriptor sampling runs the bicubic
kernel; on CPU tensors both run their plain torch versions. The sparse
path L2-normalizes descriptors twice, per pixel before sampling and per
keypoint after it; both normalizations belong to the sampling step
(`sample_descriptors` takes the raw map). Under a profiler its stages are
the ranges `xfeat.extract.backbone`, `.decode`, `.select` and `.sample`
inside `xfeat.extract` (`utils.profiling.span`).

Semi-dense (`extract_dense`, `extract_dualscale`,
`detect_and_compute_dense`): the /8 cells with the highest reliability and
their raw descriptors, NOT L2-normalized. On CUDA tensors the cells are
selected by the detect kernel's exact top-k (`topk_exact`), on CPU tensors
by its plain version.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..models.backbone import xfeat_forward
from ..utils.profiling import span
from .cuda.bicubic import sample_descriptors
from .cuda.detect_fused import topk_exact, topk_keypoints_fused
from .detect import dense_topk, heatmap_decode
from .resize import preprocess_image, resize_bilinear, to_unit_float
from .sample import l2_normalize

__all__ = ["l2_normalize", "detect_and_compute", "extract_dense",
           "extract_dualscale", "detect_and_compute_dense"]


def detect_and_compute(params: Dict[str, Any], images: torch.Tensor,
                       top_k: int = 4096, detection_threshold: float = 0.05,
                       compute_dtype: torch.dtype = torch.float32,
                       fused_stem: bool = False) -> Dict[str, torch.Tensor]:
    """(B,H,W,C) images (integer 0-255 or float in [0,1]) -> fixed-shape
    keypoints (B,K,2) f32 xy in input coordinates, scores (B,K),
    descriptors (B,K,64) L2-normalized, valid (B,K) bool.

    `compute_dtype` and `fused_stem` go to `xfeat_forward`; its outputs are
    cast to float32, so selection, sampling and matching see float32. (In
    bfloat16 the JAX package samples descriptors from a bfloat16 map; here
    the map is the float32 cast of the backbone's output.)"""
    with span("xfeat.extract"):
        with span("xfeat.extract.backbone"):
            x, rh, rw = preprocess_image(to_unit_float(images))
            H, W = x.shape[1], x.shape[2]
            feats, logits, heat = xfeat_forward(
                params, x, compute_dtype=compute_dtype, fused_stem=fused_stem)
        with span("xfeat.extract.decode"):
            kheat = heatmap_decode(logits.float())               # (B, H, W)
        with span("xfeat.extract.select"):
            kpts_i, scores = topk_keypoints_fused(
                kheat, heat[..., 0].float().contiguous(), top_k,
                detection_threshold)
        with span("xfeat.extract.sample"):
            kpts_f = kpts_i.float()
            descs = sample_descriptors(feats.float(), kpts_f, (H, W))
            kpts = kpts_f * torch.tensor([rw, rh], dtype=torch.float32,
                                         device=kpts_f.device)
        return {"keypoints": kpts, "scores": scores, "descriptors": descs,
                "valid": scores > 0}


def extract_dense(params: Dict[str, Any], images: torch.Tensor, top_k: int,
                  compute_dtype: torch.dtype = torch.float32,
                  fused_stem: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Coarse /8-grid features, the top-k cells by reliability ->
    keypoints (B,K,2) f32 xy in input coordinates (cell corners),
    descriptors (B,K,64) raw. K = min(top_k, number of cells)."""
    x, rh, rw = preprocess_image(to_unit_float(images))
    feats, _, heat = xfeat_forward(params, x, compute_dtype=compute_dtype,
                                   fused_stem=fused_stem)
    feats, heat = feats.float(), heat.float()
    b, h, w, c = feats.shape
    idx, descs = dense_topk(feats.reshape(b, h * w, c),
                            heat.reshape(b, h * w).contiguous(),
                            min(h * w, top_k), topk_exact)
    xs = (idx % w).float() * 8.0 * rw
    ys = (idx // w).float() * 8.0 * rh
    return torch.stack([xs, ys], dim=-1), descs


def _reciprocal(s: float) -> float:
    """1/s rounded as float32 arithmetic rounds it. XLA turns the JAX
    package's `kpts / s` into a product with this constant, and torch
    divides by a scalar the same way on the card but not on the CPU;
    multiplying by it gives all three the same keypoints."""
    return float(np.float32(1.0) / np.float32(s))


def extract_dualscale(params: Dict[str, Any], images: torch.Tensor,
                      top_k: int, s1: float = 0.6, s2: float = 1.3,
                      compute_dtype: torch.dtype = torch.float32,
                      fused_stem: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Two-scale coarse extraction: 20% of `top_k` at scale `s1`, 80% at
    `s2`, keypoints mapped back to input coordinates -> keypoints (B,K,2),
    each keypoint's extraction scale (B,K) for the refinement step,
    descriptors (B,K,64)."""
    images = to_unit_float(images)
    h, w = images.shape[1], images.shape[2]
    x1 = resize_bilinear(images, (math.floor(h * s1), math.floor(w * s1)))
    x2 = resize_bilinear(images, (math.floor(h * s2), math.floor(w * s2)))
    mk1, f1 = extract_dense(params, x1, int(top_k * 0.20), compute_dtype,
                            fused_stem)
    mk2, f2 = extract_dense(params, x2, int(top_k * 0.80), compute_dtype,
                            fused_stem)
    kpts = torch.cat([mk1 * _reciprocal(s1), mk2 * _reciprocal(s2)], dim=1)
    sc = torch.cat([mk1.new_full(mk1.shape[:2], 1.0 / s1),
                    mk2.new_full(mk2.shape[:2], 1.0 / s2)], dim=1)
    return kpts, sc, torch.cat([f1, f2], dim=1)


def detect_and_compute_dense(params: Dict[str, Any], images: torch.Tensor,
                             top_k: int = 4096, multiscale: bool = True,
                             compute_dtype: torch.dtype = torch.float32,
                             fused_stem: bool = False
                             ) -> Dict[str, torch.Tensor]:
    """Semi-dense coarse extraction: keypoints (B,K,2), descriptors
    (B,K,64) not normalized, scales (B,K) (all 1 for a single scale)."""
    if multiscale:
        kpts, sc, feats = extract_dualscale(params, images, top_k,
                                            compute_dtype=compute_dtype,
                                            fused_stem=fused_stem)
    else:
        kpts, feats = extract_dense(params, images, top_k, compute_dtype,
                                    fused_stem)
        sc = kpts.new_ones(kpts.shape[:2])
    return {"keypoints": kpts, "descriptors": feats, "scales": sc}
