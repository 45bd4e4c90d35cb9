"""The port's plain-torch ops (counterpart of the JAX package's `ops/`),
with its exported names. Each name is imported from its module on first
use: `ops.extraction` imports `models.backbone`, which imports `ops.cuda`,
so importing them all here would be circular."""

import importlib

_MODULES = {
    "detect": ["heatmap_decode", "local_max_mask", "score_map",
               "topk_keypoints", "dense_topk"],
    "extraction": ["detect_and_compute", "detect_and_compute_dense",
                   "extract_dense", "extract_dualscale"],
    "matching": ["mnn_match", "batch_mnn_match", "batch_mnn_match_dense"],
    "refine": ["refine_matches", "subpix_softmax2d"],
    "resize": ["preprocess_image", "preprocess_shape", "resize_bilinear",
               "resize_nearest_torch"],
    "sample": ["l2_normalize", "interpolate_sparse2d", "sample_bicubic",
               "sample_bicubic_matmul", "sample_bilinear", "sample_nearest"],
}
_HOME = {name: mod for mod, names in _MODULES.items() for name in names}

__all__ = list(_HOME)


def __getattr__(name):
    if name not in _HOME:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{_HOME[name]}", __name__), name)
