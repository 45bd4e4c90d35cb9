"""Relative-pose evaluation for the port (counterpart of the JAX package's
`eval/`): the metrics, and the ScanNet-1500 harness's functions (its
`run_benchmark` and `report` stay under `eval.scannet1500`, beside
`eval.megadepth1500`'s). Those are imported on first use, so that
`python -m accelerated_features_tpu_torch.eval.scannet1500` runs the
module once."""

import importlib

from .metrics import (error_auc, mean_accuracy, pose_errors_to_summary,
                      relative_pose_error)

_SCANNET = ["THRESHOLDS", "load_pair_list", "read_pose", "rel_pose_0to1",
            "extract_matches", "extract_matches_batched",
            "run_threshold_sweep", "best_result"]

__all__ = ["relative_pose_error", "error_auc", "mean_accuracy",
           "pose_errors_to_summary"] + _SCANNET


def __getattr__(name):
    if name not in _SCANNET:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(".scannet1500", __name__), name)
