"""Keyframe pose graph and SE(3) pose-graph optimization (counterpart of
the JAX package's `sfm/posegraph.py`).

Nodes are keyframe poses (world->cam 6-vectors); edges are relative-pose
measurements from two-view geometry. The optimizer is Levenberg-Marquardt
on the SE(3) residual log(T_meas^-1 T_j T_i^-1) with dense normal
equations (keyframe counts are small; the landmark-scale work is BA's),
run eagerly on the device, whatever the graph's size.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch.func import jacfwd

from ..ops.precision import full_fp32_matmuls
from .lie import (outside_inference_mode, se3_compose, se3_inverse,
                  so3_exp)


@dataclasses.dataclass
class PoseGraph:
    """Mutable host-side container; optimization runs on the device."""
    poses: np.ndarray                       # (N, 6) world->cam
    edges: List[Tuple[int, int]]            # (i, j) pairs
    measurements: np.ndarray                # (E, 6) T_i_to_j measurements
    weights: np.ndarray                     # (E,) edge weights

    @classmethod
    def empty(cls):
        return cls(np.zeros((0, 6), np.float32), [],
                   np.zeros((0, 6), np.float32), np.zeros((0,), np.float32))

    def add_keyframe(self, pose6: np.ndarray) -> int:
        self.poses = np.concatenate([self.poses,
                                     np.asarray(pose6, np.float32)[None]])
        return len(self.poses) - 1

    def add_edge(self, i: int, j: int, T_i_to_j: np.ndarray,
                 weight: float = 1.0):
        self.edges.append((i, j))
        self.measurements = np.concatenate(
            [self.measurements, np.asarray(T_i_to_j, np.float32)[None]])
        self.weights = np.concatenate(
            [self.weights, np.asarray([weight], np.float32)])


def edge_residual(pose_i: torch.Tensor, pose_j: torch.Tensor,
                  meas_i_to_j: torch.Tensor) -> torch.Tensor:
    """r = log(T_meas^-1 * (T_j * T_i^-1)), (..., 6)."""
    rel = se3_compose(pose_j, se3_inverse(pose_i))
    return se3_compose(se3_inverse(meas_i_to_j), rel)


def pgo_cost(poses: torch.Tensor, edges_i: torch.Tensor,
             edges_j: torch.Tensor, meas: torch.Tensor,
             weights: torch.Tensor) -> torch.Tensor:
    r = edge_residual(poses[edges_i], poses[edges_j], meas)
    return 0.5 * (weights[:, None] * r ** 2).sum()


def optimize_pose_graph(graph: PoseGraph, iters: int = 20,
                        lam0: float = 1e-4, fix_first: bool = True,
                        robust_c: Optional[float] = 0.7,
                        device: Optional[Union[str, torch.device]] = None
                        ) -> Tuple[np.ndarray, Dict[str, float]]:
    """Dense LM on the pose graph with IRLS Cauchy weights, on `device`
    (None: the GPU, and it raises without one).

    `robust_c`: Cauchy scale on the per-edge residual norm (se3 log units).
    Each LM step reweights every edge by 1/(1 + ||r||^2/c^2) at the current
    poses, so a false loop edge (repeated texture can pass the inlier and
    scale gates with a ~1-rad error) loses its influence while
    near-consensus edges keep full weight. None disables it. Returns the
    optimized (N, 6) poses and the initial and final costs."""
    from ..api import resolve_device
    n = len(graph.poses)
    if n == 0 or not graph.edges:
        return graph.poses, {"initial_cost": 0.0, "final_cost": 0.0}
    dev = resolve_device(device)
    ei = torch.as_tensor([e[0] for e in graph.edges], device=dev)
    ej = torch.as_tensor([e[1] for e in graph.edges], device=dev)
    meas = torch.as_tensor(graph.measurements, dtype=torch.float32,
                           device=dev)
    wts = torch.as_tensor(graph.weights, dtype=torch.float32, device=dev)
    poses = torch.as_tensor(graph.poses, dtype=torch.float32, device=dev)

    def robust_w(poses):
        if robust_c is None:
            return torch.ones_like(wts)
        r = edge_residual(poses[ei], poses[ej], meas)
        return 1.0 / (1.0 + (r ** 2).sum(-1) / (robust_c ** 2))

    def residual_vec(flat, w_eff, ei, ej, meas):
        p = flat.reshape(n, 6)
        r = edge_residual(p[ei], p[ej], meas)
        return (w_eff.sqrt()[:, None] * r).reshape(-1)

    with full_fp32_matmuls():
        cost0 = pgo_cost(poses, ei, ej, meas, wts)
        cost = cost0
        lam = torch.full((), lam0, dtype=torch.float32, device=dev)
        eye = torch.eye(6 * n, device=dev)
        # gauge: pose 0 frozen by zeroing its rows and columns, unit diagonal
        frozen = (torch.arange(6 * n, device=dev) < 6) if fix_first else None
        for _ in range(iters):
            flat = poses.reshape(-1)
            w_eff = wts * robust_w(poses)   # IRLS: frozen for this step
            J = outside_inference_mode(jacfwd(residual_vec), flat, w_eff,
                                       ei, ej, meas)
            r = residual_vec(flat, w_eff, ei, ej, meas)
            H = J.T @ J + lam * eye
            g = J.T @ r
            if frozen is not None:
                H = torch.where(frozen[:, None] | frozen[None, :], 0.0, H)
                H = H + torch.diag(frozen.float())
                g = torch.where(frozen, 0.0, g)
            dx = torch.linalg.solve_ex(H, -g)[0]
            new = (flat + dx).reshape(n, 6)
            # the accept test under this step's IRLS weights, so that both
            # costs weigh the edges alike
            cost_prev_eff = 0.5 * (r ** 2).sum()
            cost_new = pgo_cost(new, ei, ej, meas, w_eff)
            accept = cost_new < cost_prev_eff
            poses = torch.where(accept, new, poses)
            lam = torch.where(accept, (lam * 0.5).clamp_min(1e-9),
                              (lam * 4.0).clamp_max(1e3))
            cost = torch.where(accept, cost_new, cost)
    return poses.cpu().numpy(), {"initial_cost": float(cost0),
                                 "final_cost": float(cost)}


def absolute_trajectory_error(poses_est: np.ndarray, poses_gt: np.ndarray
                              ) -> float:
    """ATE RMSE over camera centers after Umeyama (similarity) alignment,
    the standard SLAM trajectory metric."""
    def centers(poses):
        p = torch.as_tensor(np.asarray(poses, np.float32))
        R = so3_exp(p[:, :3]).numpy()
        t = p[:, 3:].numpy()
        return np.stack([-R[i].T @ t[i] for i in range(len(R))])

    A = centers(poses_est)
    B = centers(poses_gt)
    mu_a, mu_b = A.mean(0), B.mean(0)
    Ac, Bc = A - mu_a, B - mu_b
    U, S, Vt = np.linalg.svd(Ac.T @ Bc / len(A))
    d = np.sign(np.linalg.det(U @ Vt))
    D = np.diag([1.0, 1.0, d])
    R = U @ D @ Vt
    var_a = (Ac ** 2).sum() / len(A)
    s = np.trace(np.diag(S) @ D) / max(var_a, 1e-12)
    A_aligned = s * (R.T @ Ac.T).T + mu_b
    return float(np.sqrt(np.mean(np.sum((A_aligned - B) ** 2, axis=1))))
