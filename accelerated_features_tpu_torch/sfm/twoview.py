"""Two-view geometry: triangulation and map bootstrapping from matches
(counterpart of the JAX package's `sfm/twoview.py`).

Estimates a relative pose with the port's pose estimator (posekit by
default), triangulates the inlier matches and assembles a `BAProblem` on
the device.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from .ba import BAProblem
from .lie import se3_from_Rt


def triangulate_linear(P0: np.ndarray, P1: np.ndarray, x0: np.ndarray,
                       x1: np.ndarray) -> np.ndarray:
    """DLT triangulation. P0/P1: (3,4) projection matrices; x0/x1: (N,2)
    pixels -> (N,3) world points."""
    n = len(x0)
    X = np.zeros((n, 3))
    for i in range(n):
        A = np.stack([
            x0[i, 0] * P0[2] - P0[0],
            x0[i, 1] * P0[2] - P0[1],
            x1[i, 0] * P1[2] - P1[0],
            x1[i, 1] * P1[2] - P1[1],
        ])
        _, _, vt = np.linalg.svd(A)
        Xh = vt[-1]
        # near-zero homogeneous scale = point at infinity (low-parallax
        # ray pair): keep finite so the positive-depth filter can reject
        # it instead of letting inf/NaN into the BA problem
        h = Xh[3] if abs(Xh[3]) > 1e-10 else 1e-10
        X[i] = Xh[:3] / h
    return X


def two_view_reconstruction(mkpts0: np.ndarray, mkpts1: np.ndarray,
                            K: np.ndarray,
                            max_epipolar_error: float = 2.5,
                            pose_backend: str = "posekit",
                            device: Optional[Union[str, torch.device]] = None
                            ) -> Optional[Tuple[BAProblem, np.ndarray]]:
    """Pose + triangulated map from one image pair's matches.

    Returns (a BAProblem with 2 cameras, cam0 gauge-fixed, on `device`
    (None: the GPU, and it raises without one), the inlier mask), or None
    if the pose can't be estimated. `pose_backend`: "posekit" (native 5-pt
    LO-RANSAC on the host) or "gpu" (batched 8-pt MSAC on `device`)."""
    from ..api import resolve_device
    from ..geometry import get_pose_estimator  # geometry imports sfm.lie
    dev = resolve_device(device)
    res = get_pose_estimator(pose_backend, dev)(
        mkpts0, mkpts1, K, K, max_epipolar_error=max_epipolar_error)
    if res is None:
        return None
    R, t, mask = res
    x0 = mkpts0[mask]
    x1 = mkpts1[mask]
    P0 = K @ np.hstack([np.eye(3), np.zeros((3, 1))])
    P1 = K @ np.hstack([R, t[:, None]])
    X = triangulate_linear(P0, P1, x0, x1)

    # keep points with positive, finite, bounded depth in both views
    # (low-parallax rays triangulate to near-infinity)
    z0 = X[:, 2]
    z1 = (R @ X.T).T[:, 2] + t[2]
    keep = ((z0 > 1e-3) & (z1 > 1e-3) & np.isfinite(X).all(axis=1)
            & (np.linalg.norm(X, axis=1) < 1e4))
    X = X[keep]
    x0, x1 = x0[keep], x1[keep]
    npts = len(X)
    if npts < 8:
        return None

    cams = torch.zeros((2, 6))
    cams[1] = se3_from_Rt(torch.as_tensor(R, dtype=torch.float32),
                          torch.as_tensor(t, dtype=torch.float32))
    obs_cam = torch.cat([torch.zeros(npts, dtype=torch.int64),
                         torch.ones(npts, dtype=torch.int64)])
    obs_pt = torch.arange(npts).repeat(2)
    obs_uv = torch.from_numpy(np.concatenate([x0, x1]).astype(np.float32))
    problem = BAProblem(
        cams=cams,
        points=torch.as_tensor(X, dtype=torch.float32),
        K=torch.as_tensor(K, dtype=torch.float32),
        obs_cam=obs_cam, obs_pt=obs_pt, obs_uv=obs_uv,
        obs_mask=torch.ones(2 * npts, dtype=torch.bool),
        fixed_cams=torch.tensor([True, False]))
    return problem.to(dev), mask
