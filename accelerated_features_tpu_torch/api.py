"""User-facing `XFeat` for the PyTorch port (counterpart of the JAX
package's `api.py`): sparse extraction with mutual-nearest-neighbour
matching, the semi-dense XFeat* pipeline, and LighterGlue matching.

Entry points run on `cuda` unless the caller passes `device="cpu"`; with
no device given and no GPU present they raise. On `cuda` the detect,
descriptor-sampling, matching and attention steps run the port's CUDA
kernels; on the CPU they run the plain torch versions of the same
functions.
"""

from __future__ import annotations

import warnings
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from .models.backbone import XFeatModel
from .models.lighterglue import LighterGlue
from .models.params import flatten_tree, load_params, params_to_jax
from .ops.cuda.mnn import batch_mnn_match_fused
from .ops.extraction import detect_and_compute, detect_and_compute_dense
from .ops.matching import batch_mnn_match
from .ops.refine import refine_matches

ArrayLike = Union[np.ndarray, torch.Tensor]
Weights = Optional[Union[str, Mapping[str, Any]]]

# the repository's trained extractor
DEFAULT_WEIGHTS = str(Path(__file__).resolve().parents[1] / "artifacts"
                      / "run_md_ckpt13250.npz")


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """`device` as a torch.device; None means the GPU, and raises when
    there is none (the port never falls back to the CPU by itself)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain torch path on the CPU")
    return torch.device("cuda")


def parse_input_host(x: ArrayLike) -> ArrayLike:
    """parse_input's shape and range rules without a device transfer:
    numpy in, numpy out; a tensor keeps its device and dtype. Integer
    images keep their dtype (scaled by 1/255 inside the pipeline). 3-D
    inputs whose last dim is 1, 3 or 4 are single images, others gray
    batches. Gray integer numpy images are expanded to three equal
    channels, as the JAX package does. Numpy floats become float32 and,
    above 1.5, are taken as 0-255 and divided by 255; tensors are trusted
    to be in [0, 1]. Returns (B,H,W,C)."""
    is_np = not isinstance(x, torch.Tensor)
    if is_np:
        x = np.asarray(x)
    if x.ndim == 2:
        x = x[..., None]
    if x.ndim == 3:
        x = x[None] if x.shape[-1] in (1, 3, 4) else x[..., None]
    if is_np:
        if np.issubdtype(x.dtype, np.integer):
            if x.shape[-1] == 1:
                x = np.repeat(x, 3, axis=-1)
            if x.dtype not in (np.uint8, np.int16, np.int32, np.int64):
                x = x.astype(np.int32)  # uint16/uint32: torch-safe
        elif np.issubdtype(x.dtype, np.floating):
            x = np.asarray(x, np.float32)
            if x.size and float(np.max(x)) > 1.5:
                x = x / np.float32(255.0)
    return x


def save_params(params: Mapping[str, Any], path: str) -> None:
    """Write an extractor tree as the JAX package's flat `.npz` (`a/b/0/w`
    keys, conv weights HWIO, linear weights (in, out)), which both
    packages' `load_params` read. `params`: the port's tensor tree (e.g.
    `XFeat.model.params`, or `load_params(..., fold_bn=False)` to keep the
    BatchNorm stats), put into the JAX layout by `params_to_jax`, or a
    JAX-layout numpy tree, written as it is."""
    flat = flatten_tree(params)
    if any(isinstance(v, torch.Tensor) for v in flat.values()):
        flat = flatten_tree(params_to_jax(params))
    np.savez(path, **{k: np.asarray(v) for k, v in flat.items()})


class XFeat:
    """XFeat inference: `detectAndCompute`, `detectAndComputeDense`,
    `match`, `batch_match`, `match_xfeat`, `match_xfeat_star`,
    `refine_matches`, `set_lighterglue`, `match_lighterglue`.

    `weights`: any format of `models.params.load_params`: an extractor
    `.npz` path (the JAX package's format; a full train state works too),
    a training checkpoint directory, a `.pt`/`.pth` path or an in-memory
    state dict in the reference model's torch layout, a JAX-layout numpy
    parameter tree, or None for a random extractor
    (`models.params.init_xfeat_params`, seed 0; the JAX package's shapes
    and bounds, drawn by torch, so other values). The default is the
    repository's trained extractor.
    The positional parameters are the JAX package's (`weights`, `top_k`,
    `detection_threshold`, `compute_dtype`, `fused_matching`); `device`
    and `fused_stem` are keywords.
    `compute_dtype`: "float32" or "bfloat16", the backbone's dtype;
    selection, descriptors and matching stay float32.
    `fused_stem`: run the backbone's stem as the fused stem kernel (its
    plain version on the CPU).
    `fused_matching`: None runs the fused MNN kernel on `cuda` and the
    plain matcher on the CPU; False forces the plain matcher on either
    device; True on the CPU raises.
    """

    def __init__(self,
                 weights: Weights = DEFAULT_WEIGHTS,
                 top_k: int = 4096, detection_threshold: float = 0.05,
                 compute_dtype: str = "float32",
                 fused_matching: Optional[bool] = None, *,
                 device: Optional[Union[str, torch.device]] = None,
                 fused_stem: bool = False):
        self.device = resolve_device(device)
        self.top_k = top_k
        self.detection_threshold = detection_threshold
        if compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype must be 'float32' or "
                             f"'bfloat16', got {compute_dtype!r}")
        self.compute_dtype = getattr(torch, compute_dtype)
        self.fused_stem = bool(fused_stem)
        on_cuda = self.device.type == "cuda"
        if fused_matching and not on_cuda:
            raise ValueError("fused_matching=True needs a CUDA device: the "
                             "fused MNN kernel does not run on the CPU")
        self.fused_matching = on_cuda if fused_matching is None \
            else bool(fused_matching)
        self._lighterglue: Optional[LighterGlue] = None
        self.set_params(weights)

    def set_params(self, weights: Weights) -> None:
        """Swap the extractor weights in place (every format __init__
        takes)."""
        self.model = XFeatModel(load_params(weights)).to(self.device).eval()

    def _mnn(self, d1: torch.Tensor, d2: torch.Tensor,
             valid1: Optional[torch.Tensor] = None,
             valid2: Optional[torch.Tensor] = None,
             min_cossim: float = -1.0) -> Tuple[torch.Tensor, torch.Tensor]:
        """Batched MNN by the fused kernel or the plain matcher, as
        `fused_matching` says."""
        fn = batch_mnn_match_fused if self.fused_matching else batch_mnn_match
        return fn(d1, d2, valid1, valid2, min_cossim)

    # ---------------- input handling ----------------------------------------

    def parse_input(self, x: ArrayLike) -> torch.Tensor:
        """(H,W[,C]), (B,H,W) gray batch or (B,H,W,C), integer or float ->
        (B,H,W,C) float32 in [0,1] on the device."""
        x = self._parse_input_raw(x)
        if not torch.is_floating_point(x):
            x = x.float() / 255.0
        return x.float()

    def _parse_input_raw(self, x: ArrayLike) -> torch.Tensor:
        """`parse_input_host`, then onto the device."""
        x = parse_input_host(x)
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x.to(self.device)

    # ---------------- public API --------------------------------------------

    @torch.inference_mode()
    def detectAndCompute(self, x: ArrayLike, top_k: Optional[int] = None,
                         detection_threshold: Optional[float] = None
                         ) -> List[Dict[str, torch.Tensor]]:
        """Sparse extraction. Returns per-image dicts of compacted tensors on
        the device: keypoints (N,2), scores (N,), descriptors (N,64)."""
        top_k = top_k or self.top_k
        thr = detection_threshold if detection_threshold is not None \
            else self.detection_threshold
        out = detect_and_compute(self.model.params, self._parse_input_raw(x),
                                 top_k, thr, self.compute_dtype,
                                 self.fused_stem)
        return [{"keypoints": out["keypoints"][b][v],
                 "scores": out["scores"][b][v],
                 "descriptors": out["descriptors"][b][v]}
                for b, v in enumerate(out["valid"])]

    @torch.inference_mode()
    def match(self, feats1: ArrayLike, feats2: ArrayLike,
              min_cossim: float = 0.82) -> Tuple[torch.Tensor, torch.Tensor]:
        """MNN match of two descriptor sets. Returns (idx0, idx1) int64
        tensors of the matched rows. Both sets are padded to one
        power-of-two bucket (at least 64) with invalid rows."""
        d1 = torch.as_tensor(feats1, dtype=torch.float32, device=self.device)
        d2 = torch.as_tensor(feats2, dtype=torch.float32, device=self.device)
        n1, n2 = d1.shape[0], d2.shape[0]
        k = max(n1, n2, 64)
        k = 1 << (k - 1).bit_length()
        d1p = torch.zeros((1, k, d1.shape[1]), dtype=torch.float32,
                          device=self.device)
        d2p = torch.zeros_like(d1p)
        d1p[0, :n1] = d1
        d2p[0, :n2] = d2
        ar = torch.arange(k, device=self.device)[None]
        idx1, mask = self._mnn(d1p, d2p, ar < n1, ar < n2, min_cossim)
        idx0 = torch.nonzero(mask[0])[:, 0]
        return idx0, idx1[0][idx0]

    @torch.inference_mode()
    def batch_match(self, feats1: ArrayLike, feats2: ArrayLike,
                    min_cossim: float = -1.0
                    ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """Batched MNN of (B,K1,64) against (B,K2,64), every row real.
        Returns a list of (idx0, idx1) per batch item."""
        d1 = torch.as_tensor(feats1, dtype=torch.float32,
                             device=self.device).contiguous()
        d2 = torch.as_tensor(feats2, dtype=torch.float32,
                             device=self.device).contiguous()
        idx1, mask = self._mnn(d1, d2, None, None, min_cossim)
        out = []
        for b in range(idx1.shape[0]):
            idx0 = torch.nonzero(mask[b])[:, 0]
            out.append((idx0, idx1[b][idx0]))
        return out

    def match_xfeat(self, img1: ArrayLike, img2: ArrayLike,
                    top_k: Optional[int] = None, min_cossim: float = -1.0
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """Sparse pipeline: extract both images, MNN-match them. Returns the
        matched keypoints (N,2), (N,2) as numpy arrays."""
        top_k = top_k or self.top_k
        out1 = self.detectAndCompute(img1, top_k=top_k)[0]
        out2 = self.detectAndCompute(img2, top_k=top_k)[0]
        idx0, idx1 = self.match(out1["descriptors"], out2["descriptors"],
                                min_cossim=min_cossim)
        return (out1["keypoints"][idx0].cpu().numpy(),
                out2["keypoints"][idx1].cpu().numpy())

    @torch.inference_mode()
    def detectAndComputeDense(self, x: ArrayLike,
                              top_k: Optional[int] = None,
                              multiscale: bool = True
                              ) -> Dict[str, torch.Tensor]:
        """Semi-dense coarse extraction. Returns batched tensors on the
        device: keypoints (B,K,2), descriptors (B,K,64) not normalized,
        scales (B,K)."""
        return detect_and_compute_dense(self.model.params,
                                        self._parse_input_raw(x),
                                        top_k or self.top_k, multiscale,
                                        self.compute_dtype, self.fused_stem)

    @torch.inference_mode()
    def match_xfeat_star(self, im_set1: ArrayLike, im_set2: ArrayLike,
                         top_k: Optional[int] = None):
        """Semi-dense pipeline: dual-scale extraction, batched MNN, batched
        refinement. Returns numpy: (mkpts0, mkpts1) for a single pair, a
        list of (N,4) arrays for a batch."""
        top_k = top_k or self.top_k
        out1 = self.detectAndComputeDense(im_set1, top_k=top_k)
        out2 = self.detectAndComputeDense(im_set2, top_k=top_k)
        idx1, mmask = self._mnn(out1["descriptors"], out2["descriptors"])
        mk0, mk1, _, mask = refine_matches(
            self.model.params, out1["keypoints"], out2["keypoints"],
            out1["descriptors"], out2["descriptors"], out1["scales"], idx1,
            mmask, fine_conf=0.25)
        both = torch.cat([mk0, mk1], dim=-1).cpu().numpy()
        mask = mask.cpu().numpy()
        matches = [both[b][mask[b]] for b in range(both.shape[0])]
        if len(matches) == 1:
            return matches[0][:, :2], matches[0][:, 2:]
        return matches

    @torch.inference_mode()
    def refine_matches(self, d0: Mapping[str, ArrayLike],
                       d1: Mapping[str, ArrayLike],
                       matches: List[Tuple[ArrayLike, ArrayLike]],
                       batch_idx: int, fine_conf: float = 0.25
                       ) -> torch.Tensor:
        """Refine the matches of one batch item: `d0`/`d1` from
        `detectAndComputeDense`, `matches` from `batch_match`. Returns an
        (N,4) tensor on the device, refined xy of set 0 beside the matched
        xy of set 1. `match_xfeat_star` does this for a whole batch."""
        def item(d, key):
            return torch.as_tensor(d[key][batch_idx], dtype=torch.float32,
                                   device=self.device)[None]

        idx0, idx1 = (torch.as_tensor(i, dtype=torch.int64,
                                      device=self.device)
                      for i in matches[batch_idx])
        k = d0["keypoints"].shape[1]
        idx1_full = torch.zeros((1, k), dtype=torch.int64,
                                device=self.device)
        mmask = torch.zeros((1, k), dtype=torch.bool, device=self.device)
        idx1_full[0, idx0] = idx1
        mmask[0, idx0] = True
        mk0, mk1, _, mask = refine_matches(
            self.model.params, item(d0, "keypoints"), item(d1, "keypoints"),
            item(d0, "descriptors"), item(d1, "descriptors"),
            item(d0, "scales"), idx1_full, mmask, fine_conf=fine_conf)
        return torch.cat([mk0[0][mask[0]], mk1[0][mask[0]]], dim=-1)

    def set_lighterglue(self, weights: Optional[Union[str, Mapping[str, Any]]
                                                ] = None,
                        **kwargs) -> LighterGlue:
        """Load the LighterGlue matcher onto this extractor's device.
        `weights`: every format `models.lighterglue.LighterGlue` takes (a
        matcher `.npz` path, a checkpoint directory, a `.pt`/`.pth` path or
        an in-memory state dict in the kornia LightGlue layout, a
        JAX-layout numpy tree). None is an explicit opt-in to random
        weights (smoke tests only) and warns."""
        if weights is None:
            warnings.warn("LighterGlue initialized with RANDOM weights: "
                          "matches will be arbitrary. Pass weights=... for "
                          "real use.", stacklevel=2)
        self._lighterglue = LighterGlue(weights, self.device, **kwargs)
        return self._lighterglue

    def match_lighterglue(self, d0: Mapping[str, Any], d1: Mapping[str, Any],
                          min_conf: float = 0.1
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
        """Attention matching of two `detectAndCompute` outputs, each with
        an added 'image_size' (W,H). Matcher weights must be loaded first
        with `set_lighterglue(weights=...)`. Returns tensors on the device:
        matched keypoints (S,2), (S,2) and their index pairs (S,2)."""
        if self._lighterglue is None:
            raise RuntimeError(
                "LighterGlue weights are not loaded. Call "
                "xfeat.set_lighterglue(weights=<path-or-tree>) first (or "
                "set_lighterglue() explicitly to opt into random weights "
                "for smoke testing).")
        idx = self._lighterglue.match(d0, d1, min_conf=min_conf)
        k0 = torch.as_tensor(d0["keypoints"], device=self.device)
        k1 = torch.as_tensor(d1["keypoints"], device=self.device)
        return k0[idx[:, 0]], k1[idx[:, 1]], idx
