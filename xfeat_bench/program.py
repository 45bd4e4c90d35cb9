"""The system under test and the control that takes its place.

`Program` is the PyTorch/CUDA port (`accelerated_features_tpu_torch`),
loaded as a user loads it, and driven through the entries the port's
batched evaluation drives: `ops.extraction.detect_and_compute`,
`models.lighterglue.lighterglue_forward` and
`ops.cuda.mnn.batch_mnn_match_fused`. This is the only module of the
benchmark that imports the port; it reads the port's modules through their
attributes at every call, so a test can put a broken entry in their place.

`Control` answers the same calls with the plain reference run at the
precision below the configuration's (operands rounded to TF32): the
comparison that decides `correct` has to find it wrong.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Tuple

import torch

from .reference import lighterglue as ref_lg
from .reference import mnn as ref_mnn
from .reference import weights as ref_weights
from .reference import xfeat as ref_xfeat

Tensors = Dict[str, torch.Tensor]


def prune_width(conf: Dict[str, Any], valid0: torch.Tensor,
                valid1: torch.Tensor) -> float:
    """The width confidence a batched call runs with: on where the most
    valid points of any image exceed `pruning_min_kpts`, as the port's
    `LighterGlue.forward_padded` decides it on the real counts."""
    most = max(int(valid0.sum(1).max()), int(valid1.sum(1).max()))
    wc = conf["width_confidence"]
    return wc if wc > 0 and most > conf["pruning_min_kpts"] else -1.0


def _to(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


class Program:
    """The port, loaded from the configuration's committed weights. Its
    kernels build at their first call (in the warm-up), into the port's
    `_build/` inside the checkout."""

    def __init__(self, config: Dict[str, Any], root: Path, device):
        from accelerated_features_tpu_torch.models import params as P
        self.config, self.device = config, torch.device(device)
        w = config["weights"]
        self.params = _to(P.load_params(str(root / w["extractor"])),
                          self.device)
        self.lg = None
        if "matcher" in w:
            self.lg = _to(P.load_lighterglue_params(str(root / w["matcher"])),
                          self.device)

    def extract(self, images: torch.Tensor, top_k: int) -> Tensors:
        from accelerated_features_tpu_torch.ops import extraction
        ex = self.config["extractor"]
        return extraction.detect_and_compute(
            self.params, images, top_k, ex["detection_threshold"],
            torch.float32)

    def lighterglue(self, f0: Tensors, f1: Tensors,
                    size: torch.Tensor) -> Tensors:
        from accelerated_features_tpu_torch.models import lighterglue
        conf = self.config["lighterglue"]
        out = lighterglue.lighterglue_forward(
            self.lg, f0["keypoints"], f1["keypoints"], f0["descriptors"],
            f1["descriptors"], size, size, f0["valid"], f1["valid"],
            heads=conf["num_heads"],
            width_confidence=prune_width(conf, f0["valid"], f1["valid"]),
            pruning_min_kpts=0)
        return {k: out[k] for k in ("matches0", "mscores0", "keep0",
                                    "keep1")}

    def mnn(self, d1, d2, v1, v2) -> Tuple[torch.Tensor, torch.Tensor]:
        from accelerated_features_tpu_torch.ops.cuda import mnn
        return mnn.batch_mnn_match_fused(d1, d2, v1, v2,
                                         self.config["mnn"]["min_cossim"])


class Control:
    """The reference in the program's place, at TF32."""

    precision = "tf32"

    def __init__(self, config: Dict[str, Any], root: Path, device):
        self.config, self.device = config, torch.device(device)
        w = config["weights"]
        self.params = ref_weights.load_xfeat(str(root / w["extractor"]),
                                             self.device)
        self.lg = None
        if "matcher" in w:
            self.lg = ref_weights.load_lighterglue(str(root / w["matcher"]),
                                                   self.device)

    def extract(self, images: torch.Tensor, top_k: int) -> Tensors:
        ex = self.config["extractor"]
        return ref_xfeat.extract(self.params, images, top_k,
                                 ex["detection_threshold"], self.precision)

    def lighterglue(self, f0: Tensors, f1: Tensors,
                    size: torch.Tensor) -> Tensors:
        conf = self.config["lighterglue"]
        b, k = f0["valid"].shape
        out = {"matches0": torch.full((b, k), -1, dtype=torch.int64,
                                      device=self.device),
               "mscores0": torch.zeros((b, k), device=self.device),
               "keep0": torch.zeros((b, k), dtype=torch.bool,
                                    device=self.device),
               "keep1": torch.zeros((b, k), dtype=torch.bool,
                                    device=self.device)}
        for i in range(b):
            s0 = torch.nonzero(f0["valid"][i])[:, 0]
            s1 = torch.nonzero(f1["valid"][i])[:, 0]
            r = ref_lg.forward_pair(
                self.lg, conf, f0["keypoints"][i][s0], f1["keypoints"][i][s1],
                f0["descriptors"][i][s0], f1["descriptors"][i][s1],
                size[i], size[i], self.precision)
            m = r["matches0"]
            out["matches0"][i, s0] = torch.where(m >= 0, s1[m.clamp(min=0)],
                                                 -1)
            out["mscores0"][i, s0] = r["mscores0"]
            out["keep0"][i, s0[r["ind"][0]]] = True
            out["keep1"][i, s1[r["ind"][1]]] = True
        return out

    def mnn(self, d1, d2, v1, v2) -> Tuple[torch.Tensor, torch.Tensor]:
        return ref_mnn.match(d1, d2, v1, v2,
                             self.config["mnn"]["min_cossim"],
                             self.precision)
