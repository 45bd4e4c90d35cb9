"""Pose-error metrics shared by the relative-pose benchmarks (the port's
own copy of the JAX package's `eval/metrics.py`; numpy only).

Angular rotation and translation errors, pose error = max(R_err, t_err),
trapezoid AUC at {5, 10, 20} degrees, mean accuracy buckets: the protocol
of the original XFeat evaluation.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

# numpy < 2.0 ships only the deprecated spelling
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def relative_pose_error(T_0to1: np.ndarray, R_est: np.ndarray,
                        t_est: np.ndarray, ignore_gt_t_thr: float = 0.0
                        ) -> Dict[str, float]:
    """Angular errors vs a 3x4 or 4x4 ground-truth transform."""
    R_gt = T_0to1[:3, :3]
    t_gt = T_0to1[:3, 3]

    n = np.linalg.norm(t_est) * np.linalg.norm(t_gt)
    if n < 1e-12:
        t_err = 0.0 if np.linalg.norm(t_gt) < ignore_gt_t_thr else 180.0
    else:
        t_err = np.rad2deg(np.arccos(
            np.clip(np.dot(t_est, t_gt) / n, -1.0, 1.0)))
        t_err = min(t_err, 180.0 - t_err)  # direction ambiguity
        if np.linalg.norm(t_gt) < ignore_gt_t_thr:
            t_err = 0.0

    cos = (np.trace(R_est.T @ R_gt) - 1) / 2
    r_err = np.rad2deg(np.abs(np.arccos(np.clip(cos, -1.0, 1.0))))
    return {"R_err": float(r_err), "t_err": float(t_err)}


def error_auc(errors: Sequence[float], thresholds=(5, 10, 20)
              ) -> Dict[str, float]:
    """Trapezoid AUC of the recall curve at the given angular
    thresholds."""
    errors = np.sort(np.asarray([e if np.isfinite(e) else 180.0
                                 for e in errors], np.float64))
    recall = (np.arange(len(errors)) + 1) / len(errors)
    errors = np.concatenate([[0.0], errors])
    recall = np.concatenate([[0.0], recall])
    out = {}
    for thr in thresholds:
        last_index = np.searchsorted(errors, thr)
        y = np.concatenate([recall[:last_index], [recall[last_index - 1]]])
        x = np.concatenate([errors[:last_index], [thr]])
        out[f"auc@{thr}"] = float(_trapezoid(y, x) / thr)
    return out


def mean_accuracy(errors: Sequence[float], thresholds=(5, 10, 20)
                  ) -> Dict[str, float]:
    errors = np.asarray([e if np.isfinite(e) else 180.0 for e in errors])
    return {f"acc@{t}": float(np.mean(errors < t)) for t in thresholds}


def pose_errors_to_summary(errors: List[Dict[str, float]]) -> Dict[str, float]:
    pose_err = [max(e["R_err"], e["t_err"]) for e in errors]
    out = error_auc(pose_err)
    out.update(mean_accuracy(pose_err))
    out["n_pairs"] = len(errors)
    return out
