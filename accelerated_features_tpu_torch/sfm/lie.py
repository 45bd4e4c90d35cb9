"""SO(3)/SE(3) utilities in the angle-axis parameterization (counterpart
of the JAX package's `sfm/lie.py`). Every function broadcasts over leading
dimensions."""

from __future__ import annotations

import torch


def hat(w: torch.Tensor) -> torch.Tensor:
    """(…,3) -> (…,3,3) skew-symmetric."""
    zeros = torch.zeros_like(w[..., 0])
    return torch.stack([
        torch.stack([zeros, -w[..., 2], w[..., 1]], -1),
        torch.stack([w[..., 2], zeros, -w[..., 0]], -1),
        torch.stack([-w[..., 1], w[..., 0], zeros], -1),
    ], -2)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (…,3) angle-axis -> (…,3,3) rotation."""
    theta = torch.linalg.norm(w, dim=-1, keepdim=True)[..., None]
    K = hat(w / theta[..., 0].clamp_min(1e-12))
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(K.shape)
    R = eye + torch.sin(theta) * K + (1 - torch.cos(theta)) * (K @ K)
    # small-angle fallback
    return torch.where(theta > 1e-7, R, eye + hat(w))


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """(…,3,3) -> (…,3) angle-axis."""
    trace = R.diagonal(dim1=-2, dim2=-1).sum(-1)
    theta = torch.arccos(((trace - 1) / 2).clamp(-1.0, 1.0))[..., None]
    w = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                     R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], -1)
    scale = torch.where(theta > 1e-7, theta / (2 * torch.sin(theta)),
                        torch.full_like(theta, 0.5))
    return w * scale


def rotate(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Rotate points x (…,3) by angle-axis w (…,3) without building R."""
    theta = torch.linalg.norm(w, dim=-1, keepdim=True)
    axis = w / theta.clamp_min(1e-12)
    axis_b, x_b = torch.broadcast_tensors(axis, x)
    cross = torch.linalg.cross(axis_b, x_b, dim=-1)
    dot = (axis * x).sum(-1, keepdim=True)
    rotated = (x * torch.cos(theta) + cross * torch.sin(theta)
               + axis * dot * (1 - torch.cos(theta)))
    w_b, _ = torch.broadcast_tensors(w, x)
    small = x + torch.linalg.cross(w_b, x_b, dim=-1)
    return torch.where(theta > 1e-7, rotated, small)


def se3_apply(pose6: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """pose6 = [w(3), t(3)] world->cam; x (…,3) -> R x + t."""
    return rotate(pose6[..., :3], x) + pose6[..., 3:]


def se3_matrix(pose6: torch.Tensor) -> torch.Tensor:
    """(…,6) -> (…,4,4) homogeneous transform."""
    T = pose6.new_zeros(pose6.shape[:-1] + (4, 4))
    T[..., :3, :3] = so3_exp(pose6[..., :3])
    T[..., :3, 3] = pose6[..., 3:]
    T[..., 3, 3] = 1.0
    return T


def se3_from_Rt(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return torch.cat([so3_log(R), t], -1)


def se3_inverse(pose6: torch.Tensor) -> torch.Tensor:
    w = pose6[..., :3]
    t = pose6[..., 3:]
    return torch.cat([-w, -rotate(-w, t)], -1)


def se3_compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """T_a * T_b as 6-vectors."""
    R = so3_exp(a[..., :3]) @ so3_exp(b[..., :3])
    t = rotate(a[..., :3], b[..., 3:]) + a[..., 3:]
    return torch.cat([so3_log(R), t], -1)
