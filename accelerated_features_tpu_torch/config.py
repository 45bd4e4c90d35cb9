"""Unified typed configuration tree of the PyTorch port: a copy of the JAX
package's `config.py` (same dataclasses, field names, defaults and
provenance comments), so a `Config` reads the same in both packages.

The reference scatters its behavior constants across call sites (SURVEY §5:
NMS kernel 5 at xfeat.py:74; dual-scale 0.6/1.3 and the 20/80 split at
xfeat.py:379-386; confidence gates 0.25/0.82/0.1 at xfeat.py:306,328 and
lighterglue.py:25; loss temperatures/weights at losses.py:10,199,204 and
train.py:241-244; argparse per entry point). Here every knob lives in one
frozen dataclass tree with its provenance, and each subsystem consumes its
sub-config.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    """Sparse extraction (reference xfeat.py:23-103)."""
    top_k: int = 4096                    # xfeat.py:23
    detection_threshold: float = 0.05    # xfeat.py:23
    nms_kernel_size: int = 5             # xfeat.py:74
    compute_dtype: str = "float32"       # or "bfloat16" (backbone only)


@dataclasses.dataclass(frozen=True)
class SemiDenseConfig:
    """Dual-scale coarse extraction + refinement (xfeat.py:105-128,292-394)."""
    top_k: int = 4096
    multiscale: bool = True
    scale1: float = 0.6                  # xfeat.py:379
    scale2: float = 1.3                  # xfeat.py:379
    scale1_budget: float = 0.20          # xfeat.py:385
    fine_conf: float = 0.25              # xfeat.py:306
    subpix_temp: float = 3.0             # xfeat.py:292,316


@dataclasses.dataclass(frozen=True)
class MatchingConfig:
    """MNN matching (xfeat.py:265-348)."""
    min_cossim: float = 0.82             # xfeat.py:328 (match)
    min_cossim_pipeline: float = -1.0    # xfeat.py:166 (match_xfeat)
    # the fused MNN kernel C; None = auto: C on cuda, the plain matcher on
    # the CPU (XFeat(fused_matching=None))
    fused_kernel: Optional[bool] = None


@dataclasses.dataclass(frozen=True)
class LighterGlueConfig:
    """Attention matcher (reference lighterglue.py:12-27)."""
    input_dim: int = 64
    descriptor_dim: int = 96
    n_layers: int = 6
    num_heads: int = 1
    filter_threshold: float = 0.1        # lighterglue.py:25


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Training losses (reference losses.py, train.py:241-244)."""
    dual_softmax_temp: float = 0.2       # losses.py:10
    coordinate_weight: float = 2.0       # losses.py:199
    reliability_weight: float = 3.0      # losses.py:204
    distill_weight: float = 2.0          # train.py:241
    distill_neg_ratio: int = 32          # losses.py:93


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    """Optimization schedule (reference train.py:86-125)."""
    lr: float = 3e-4
    lr_step: int = 30_000
    lr_gamma: float = 0.5
    n_steps: int = 160_000
    batch_size: int = 10
    synthetic_fraction: float = 0.4      # train.py:96
    grad_clip: float = 1.0               # train.py:266
    bn_momentum: float = 0.1
    save_ckpt_every: int = 500           # train.py:37
    training_res: Tuple[int, int] = (800, 608)  # train.py:32
    min_corrs: int = 30                  # train.py:207-214


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    """Pose benchmarks (reference megadepth1500.py / scannet1500.py)."""
    ransac_thr: float = 2.5              # megadepth1500.py:245-246
    ransac_success_prob: float = 0.99999
    scannet_thr_sweep: Tuple[float, ...] = tuple(
        0.5 * i for i in range(1, 13))   # scannet1500.py threshold sweep


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout (framework-native; no reference counterpart).
    Copied for the tree's shape; nothing in the port reads it until the
    multi-GPU modules are ported."""
    data_axis: int = -1                  # -1 = all devices
    model_axis: int = 1


@dataclasses.dataclass(frozen=True)
class Config:
    detector: DetectorConfig = DetectorConfig()
    semidense: SemiDenseConfig = SemiDenseConfig()
    matching: MatchingConfig = MatchingConfig()
    lighterglue: LighterGlueConfig = LighterGlueConfig()
    loss: LossConfig = LossConfig()
    trainer: TrainerConfig = TrainerConfig()
    eval: EvalConfig = EvalConfig()
    mesh: MeshConfig = MeshConfig()

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


DEFAULT = Config()


def make_xfeat(config: Config = DEFAULT, weights=None, device=None):
    """Build the inference engine from a Config. `weights=None` is a random
    extractor, as in the JAX package (unlike `XFeat()`, whose default is
    the trained one); `device=None` is the card (raises without one)."""
    from .api import XFeat
    return XFeat(weights=weights,
                 top_k=config.detector.top_k,
                 detection_threshold=config.detector.detection_threshold,
                 device=device,
                 compute_dtype=config.detector.compute_dtype,
                 fused_matching=config.matching.fused_kernel)
