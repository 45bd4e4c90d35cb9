"""Relative-pose estimation for the port (counterpart of the JAX package's
`geometry/`)."""

import functools
from typing import Optional, Union

import torch

from .pose import (decompose_homography, estimate_homography,
                   estimate_relative_pose, five_point, posekit_available,
                   sampson_sq)
from .ransac import (RansacResult, estimate_relative_pose_gpu,
                     ransac_essential, ransac_essential_batch)


def get_pose_estimator(backend: str = "posekit",
                       device: Optional[Union[str, torch.device]] = None):
    """Relative-pose estimator registry.

    "posekit": the native 5-point LO-RANSAC (`geometry/pose.py`), host
               code in both packages; `device` does not apply to it.
    "gpu":     batched-hypothesis 8-point MSAC with Sampson Gauss-Newton
               refinement (`geometry/ransac.py`), on `device` (None: the
               GPU, and it raises without one).
    The estimator maps pixel correspondences to (R, t, inlier_mask) or
    None."""
    if backend == "posekit":
        return estimate_relative_pose
    if backend == "gpu":
        return functools.partial(estimate_relative_pose_gpu, device=device)
    raise ValueError(f"unknown pose backend {backend!r} "
                     "(expected 'posekit' or 'gpu')")


__all__ = ["RansacResult", "estimate_relative_pose_gpu", "ransac_essential",
           "ransac_essential_batch", "get_pose_estimator",
           "estimate_relative_pose", "estimate_homography",
           "decompose_homography", "five_point", "sampson_sq",
           "posekit_available"]
