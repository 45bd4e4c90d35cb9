"""Mesh-parallel extraction and matching: the counterpart of the JAX
package's `parallel/matching.py`.

* `sharded_detect_and_compute`: data parallelism over images. Each rank
  runs `ops.extraction.detect_and_compute` on its share of the batch
  (kernels A and B on the card) and the results are all-gathered, so
  every rank returns the whole batch's.
* `mnn_match_sp`: sequence parallelism over the target keypoints. d2 is
  split over 'model'; each rank computes its (K1, K2/n) slab of
  similarities with `torch.matmul` (the JAX package computes it outside
  any Pallas kernel too), its rows' max and argmax (offset by its shard)
  and its columns' argmax over all of d1. The row maxima are
  all-gathered and the first rank holding the maximum wins, which keeps
  the single-device first-index ties; the column argmaxes are
  all-gathered. Only O(K) values cross the interconnect, never the
  similarity matrix.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..ops.extraction import detect_and_compute
from ..ops.matching import NEG, similarity
from ..ops.precision import full_fp32_matmuls
from .mesh import Mesh, shard_on


def sharded_detect_and_compute(mesh: Mesh, params: Dict[str, Any],
                               images: torch.Tensor, top_k: int = 4096,
                               detection_threshold: float = 0.05,
                               compute_dtype: torch.dtype = torch.float32,
                               axis: str = "data") -> Dict[str, torch.Tensor]:
    """`detect_and_compute` of the global batch `images` (B,H,W,C), B
    divisible by the size of `axis`: this rank extracts its share and
    every rank gets every image's keypoints, scores, descriptors and
    valid flags."""
    local = shard_on(mesh, images, axis)
    out = detect_and_compute(params, local, top_k=top_k,
                             detection_threshold=detection_threshold,
                             compute_dtype=compute_dtype)
    return {k: mesh.all_gather(v, axis) for k, v in out.items()}


@full_fp32_matmuls()
def mnn_match_sp(mesh: Mesh, d1: torch.Tensor, d2: torch.Tensor,
                 valid1: Optional[torch.Tensor] = None,
                 valid2: Optional[torch.Tensor] = None,
                 min_cossim: float = -1.0, axis: str = "model"
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keypoint-set parallel MNN. d1 (K1, C) and d2 (K2, C) are whole on
    every rank (K2 divisible by the size of `axis`); each rank works on
    its shard of d2. Returns (idx1 (K1,) int64, mask (K1,) bool) on every
    rank, what `ops.matching.mnn_match` returns; note the default
    `min_cossim` -1.0 (no gate) against `mnn_match`'s 0.82."""
    k1, k2 = d1.shape[0], d2.shape[0]
    n, me = mesh.size(axis), mesh.index(axis)
    if k2 % n:
        raise ValueError(f"K2={k2} does not divide over {n} ranks")
    shard = k2 // n
    dev = d1.device
    if valid1 is None:
        valid1 = torch.ones((k1,), dtype=torch.bool, device=dev)
    if valid2 is None:
        valid2 = torch.ones((k2,), dtype=torch.bool, device=dev)
    d2_s, v2_s = shard_on(mesh, (d2, valid2), axis)

    sim = torch.where(v2_s[None, :], similarity(d1, d2_s), NEG)
    simT = torch.where(valid1[None, :], sim.T, NEG)
    # rows: this shard's best, then the first rank holding the maximum
    loc_max, loc_arg = sim.max(dim=1).values, sim.argmax(dim=1)
    all_max = mesh.all_gather(loc_max, axis, tiled=False)      # (n, K1)
    all_arg = mesh.all_gather(loc_arg + me * shard, axis, tiled=False)
    best = all_max.argmax(dim=0)[None]
    gmax = torch.gather(all_max, 0, best)[0]
    garg = torch.gather(all_arg, 0, best)[0]
    # columns: this shard's columns see every row
    m21 = mesh.all_gather(simT.argmax(dim=1), axis)            # (K2,)
    mask = (m21[garg] == torch.arange(k1, device=dev)) & valid1
    if min_cossim > 0:
        mask = mask & (gmax > min_cossim)
    return garg, mask


__all__ = ["sharded_detect_and_compute", "mnn_match_sp"]
