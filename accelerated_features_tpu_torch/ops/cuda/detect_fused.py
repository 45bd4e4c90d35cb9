"""Kernel A: fused detection scores and exact top-k selection
(`csrc/detect_fused.cu`).

Counterpart of the TPU kernel in
`accelerated_features_tpu/ops/pallas/detect_fused.py` and of the
`lax.top_k` that follows it there. Two wrappers, each launching on CUDA
tensors and running its plain version on CPU tensors, each counting its
launches in `<wrapper>.launches`:

- `topk_keypoints_fused`: heatmap and reliability -> keypoints and scores,
  the candidate kernel then the selection kernel (plain version:
  `ops.detect.score_map` + `ops.detect.topk_keypoints`);
- `topk_exact`: the selection kernel alone on any (B,N) float32 rows
  (plain version: `ops.detect._padded_top_k`); XFeat*'s semi-dense
  extraction selects its cells with it;
- `detect_candidates`: the candidate kernel alone (plain version:
  `ops.detect.tile_candidates` of `score_map`), on no path of the
  extractor: `tools/measure_select.py` times the candidates apart from
  the selection with it.

The selection's order is `lax.top_k`'s: value descending, ties by index
ascending, -0.0 below +0.0; for k > N the tail is (-1.0, index 0). The
kernels' results equal the plain versions' under `torch.equal`.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from ..detect import (_padded_top_k, score_map, tile_candidates,
                      topk_keypoints)
from . import _build

HIST_BINS = 2048        # csrc/detect_fused.cu: histogram of a key's top bits
SEL_SMEM_KEYS = 131072  # keys the selection sorts in shared memory


def sort_width(n: int, k: int) -> int:
    """The power of two >= min(k, n) that the selection sorts: at least
    1024, 128 keys for each of the 8 blocks of the image's cluster."""
    return max(1024, 1 << (min(k, n) - 1).bit_length())


def _sort_scratch(b: int, p2: int, device: torch.device
                  ) -> Optional[torch.Tensor]:
    """Global keys to sort when they do not fit in shared memory."""
    if p2 <= SEL_SMEM_KEYS:
        return None
    return torch.empty((b, p2), dtype=torch.int64, device=device)


def _check_detect(kheat: torch.Tensor, reliability: torch.Tensor) -> None:
    _build.check_cuda(kheat, "kheat", torch.float32, 3)
    _build.check_cuda(reliability, "reliability", torch.float32, 3)
    _, H, W = kheat.shape
    if H % 2 or W % 2 or reliability.shape[0] != kheat.shape[0]:
        raise ValueError(f"need even H, W and one reliability map per "
                         f"heatmap, got {tuple(kheat.shape)} and "
                         f"{tuple(reliability.shape)}")


def _scales(kheat: torch.Tensor, reliability: torch.Tensor):
    """The reliability lerp's src scales, as float32 launch arguments."""
    (_, H, W), (_, h, w) = kheat.shape, reliability.shape
    return (ctypes.c_float(np.float32(w / (W - 1))),
            ctypes.c_float(np.float32(h / (H - 1))))


def topk_keypoints_fused(kheat: torch.Tensor, reliability: torch.Tensor,
                         top_k: int, threshold: float = 0.05
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Replacement for `score_map` + `topk_keypoints`: ((B,K,2) int64 xy,
    (B,K) scores), sorted by descending score, score <= 0 invalid. On the
    card: one memset and two kernels (candidates with their histogram, then
    the selection), equal to the plain version under `torch.equal`."""
    if kheat.device.type == "cpu":
        return topk_keypoints(score_map(kheat, reliability, threshold), top_k)
    _check_detect(kheat, reliability)
    _build.refuse_grad("kernel A (detect_fused)", kheat, reliability)
    if top_k < 1:
        raise ValueError(f"top_k must be positive, got {top_k}")
    b, H, W = kheat.shape
    _, h, w = reliability.shape
    n = (H // 2) * (W // 2)
    p2 = sort_width(n, top_k)
    dev = kheat.device
    best = torch.empty((b, n), dtype=torch.float32, device=dev)
    sub = torch.empty((b, n), dtype=torch.uint8, device=dev)
    hist = torch.empty((b, HIST_BINS), dtype=torch.int32, device=dev)
    gsel = _sort_scratch(b, p2, dev)
    xy = torch.empty((b, top_k, 2), dtype=torch.int64, device=dev)
    scores = torch.empty((b, top_k), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _build.launch(_lib(), "detect_topk", _build.ptr(kheat),
                      _build.ptr(reliability), _build.ptr(best),
                      _build.ptr(sub), _build.ptr(hist),
                      None if gsel is None else _build.ptr(gsel),
                      _build.ptr(xy), _build.ptr(scores), b, H, W, h, w,
                      ctypes.c_float(threshold),
                      *_scales(kheat, reliability), top_k, p2,
                      _build.stream(kheat))
    topk_keypoints_fused.launches += 1
    return xy, scores


topk_keypoints_fused.launches = 0


def detect_candidates(kheat: torch.Tensor, reliability: torch.Tensor,
                      threshold: float = 0.05
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The candidate kernel of `topk_keypoints_fused` alone: the best score
    of each 2x2 tile (B,H/2,W/2) float32 and its position 2*dy+dx in it
    (B,H/2,W/2) uint8, equal to the plain version under `torch.equal`.
    One memset and one kernel on the card."""
    if kheat.device.type == "cpu":
        return tile_candidates(score_map(kheat, reliability, threshold))
    _check_detect(kheat, reliability)
    _build.refuse_grad("kernel A (detect_candidates)", kheat, reliability)
    b, H, W = kheat.shape
    _, h, w = reliability.shape
    dev = kheat.device
    best = torch.empty((b, H // 2, W // 2), dtype=torch.float32, device=dev)
    sub = torch.empty((b, H // 2, W // 2), dtype=torch.uint8, device=dev)
    hist = torch.empty((b, HIST_BINS), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _build.launch(_lib(), "detect_candidates", _build.ptr(kheat),
                      _build.ptr(reliability), _build.ptr(best),
                      _build.ptr(sub), _build.ptr(hist), b, H, W, h, w,
                      ctypes.c_float(threshold),
                      *_scales(kheat, reliability), _build.stream(kheat))
    detect_candidates.launches += 1
    return best, sub


detect_candidates.launches = 0


def topk_exact(values: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k of each row of (B,N) float32 values -> ((B,k) values,
    (B,k) int64 indices), in `lax.top_k`'s order; for k > N the tail is
    (-1.0, index 0). One kernel launch on the card."""
    if values.device.type == "cpu":
        return _padded_top_k(values, k)
    _build.check_cuda(values, "values", torch.float32, 2)
    _build.refuse_grad("kernel A (topk_exact)", values)
    b, n = values.shape
    if k < 1 or n < 1:
        raise ValueError(f"need k >= 1 and N >= 1, got k={k}, N={n}")
    p2 = sort_width(n, k)
    gsel = _sort_scratch(b, p2, values.device)
    idx = torch.empty((b, k), dtype=torch.int64, device=values.device)
    out = torch.empty((b, k), dtype=torch.float32, device=values.device)
    with torch.cuda.device(values.device):
        _build.launch(_lib(), "topk_exact", _build.ptr(values),
                      None if gsel is None else _build.ptr(gsel),
                      _build.ptr(idx), _build.ptr(out), b, n, k, p2,
                      _build.stream(values))
    topk_exact.launches += 1
    return out, idx


topk_exact.launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.library("detect_fused")
    fl, i, p = ctypes.c_float, ctypes.c_int, ctypes.c_void_p
    lib.detect_topk.argtypes = [p] * 8 + [i] * 5 + [fl] * 3 + [i] * 2 + [p]
    lib.topk_exact.argtypes = [p] * 4 + [i] * 4 + [p]
    lib.detect_candidates.argtypes = [p] * 5 + [i] * 5 + [fl] * 3 + [p]
    for fn in (lib.detect_topk, lib.topk_exact, lib.detect_candidates):
        fn.restype = ctypes.c_int
    return lib
