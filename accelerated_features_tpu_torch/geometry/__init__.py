"""Relative-pose estimation for the port (counterpart of the JAX package's
`geometry/`)."""

import functools
from typing import Optional, Union

import torch

from .ransac import (RansacResult, estimate_relative_pose_gpu,
                     ransac_essential, ransac_essential_batch)


def get_pose_estimator(backend: str = "gpu",
                       device: Optional[Union[str, torch.device]] = None):
    """Relative-pose estimator registry.

    "gpu": batched-hypothesis 8-point MSAC with Sampson Gauss-Newton
           refinement (`geometry/ransac.py`), on `device` (None: the GPU).
    "posekit": the native 5-point LO-RANSAC backend; not ported yet.
    The estimator maps pixel correspondences to (R, t, inlier_mask) or
    None."""
    if backend == "gpu":
        return functools.partial(estimate_relative_pose_gpu, device=device)
    if backend == "posekit":
        raise NotImplementedError(
            "the native 5-point 'posekit' backend is not ported yet; it "
            "comes in a later change of its own. Use pose_backend='gpu'.")
    raise ValueError(f"unknown pose backend {backend!r} (expected 'gpu'; "
                     "'posekit' is not ported yet)")


__all__ = ["RansacResult", "estimate_relative_pose_gpu", "ransac_essential",
           "ransac_essential_batch", "get_pose_estimator"]
