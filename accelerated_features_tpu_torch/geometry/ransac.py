"""Batched essential-matrix RANSAC (counterpart of the JAX package's
`geometry/ransac_tpu.py`).

All hypotheses of all pairs are evaluated at once as batched linear
algebra: the 8-point solver per hypothesis (batched SVD), MSAC scoring
over every correspondence, cheirality-checked pose recovery of the best
hypothesis, and a Gauss-Newton refinement of (angle-axis, t) on the
Sampson error over its inliers. Pairs and hypotheses are leading batch
dimensions; every helper broadcasts over them. float32 throughout, and no
host synchronisation inside the estimator.

The 8-subsets are drawn without replacement by the Gumbel-top-k trick from
a `torch.Generator`; `_ransac_from_samples` is the estimator after the
draw, so two implementations can be compared on the same samples.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from ..sfm.lie import hat, outside_inference_mode, so3_exp, so3_log


class RansacResult(NamedTuple):
    R: torch.Tensor            # (..., 3, 3)
    t: torch.Tensor            # (..., 3), unit norm
    E: torch.Tensor            # (..., 3, 3)
    inliers: torch.Tensor      # (..., N) bool
    num_inliers: torch.Tensor  # (...)


def _normalize(pts: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Pixel points (...,N,2) and intrinsics (...,3,3) -> normalized
    image coordinates."""
    f = torch.stack([K[..., 0, 0], K[..., 1, 1]], -1)[..., None, :]
    c = torch.stack([K[..., 0, 2], K[..., 1, 2]], -1)[..., None, :]
    return (pts - c) / f


def _homogeneous(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, torch.ones_like(x[..., :1])], -1)


def _eight_point(x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
    """x0, x1 (...,8,2) normalized -> E (...,3,3): the smallest right
    singular vector of the 8x9 design matrix, projected onto the essential
    matrices. Its sign is arbitrary."""
    one = torch.ones_like(x0[..., 0])
    q = torch.stack([
        x1[..., 0] * x0[..., 0], x1[..., 0] * x0[..., 1], x1[..., 0],
        x1[..., 1] * x0[..., 0], x1[..., 1] * x0[..., 1], x1[..., 1],
        x0[..., 0], x0[..., 1], one], -1)                     # (...,8,9)
    _, _, vt = torch.linalg.svd(q, full_matrices=True)
    E = vt[..., -1, :].reshape(*q.shape[:-2], 3, 3)
    u, s, vh = torch.linalg.svd(E)
    sm = (s[..., 0] + s[..., 1]) / 2
    diag = torch.stack([sm, sm, torch.zeros_like(sm)], -1)
    return (u * diag[..., None, :]) @ vh


def _epipolar_terms(E, x0, x1) -> Tuple[torch.Tensor, torch.Tensor]:
    """x1h^T E x0h and the Sampson denominator, each (...,N)."""
    x0h, x1h = _homogeneous(x0), _homogeneous(x1)
    Ex0 = x0h @ E.transpose(-1, -2)
    Etx1 = x1h @ E
    num = (x1h * Ex0).sum(-1)
    den = (Ex0[..., 0] ** 2 + Ex0[..., 1] ** 2
           + Etx1[..., 0] ** 2 + Etx1[..., 1] ** 2)
    return num, den


def _sampson_sq(E: torch.Tensor, x0: torch.Tensor,
                x1: torch.Tensor) -> torch.Tensor:
    """E (...,3,3); x0, x1 (...,N,2) -> squared Sampson errors (...,N)."""
    num, den = _epipolar_terms(E, x0, x1)
    return num ** 2 / den.clamp_min(1e-18)


def _sampson_signed(E: torch.Tensor, x0: torch.Tensor,
                    x1: torch.Tensor) -> torch.Tensor:
    num, den = _epipolar_terms(E, x0, x1)
    return num * torch.rsqrt(den.clamp_min(1e-18))


def _pose_to_E(wvec: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return hat(t) @ so3_exp(wvec)


def _refine_pose_sampson(wvec: torch.Tensor, t: torch.Tensor,
                         x0: torch.Tensor, x1: torch.Tensor,
                         weights: torch.Tensor, iters: int = 8,
                         damping: float = 1e-6
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gauss-Newton on (angle-axis, t) minimizing the weighted Sampson
    error: local optimization on the essential manifold. wvec, t (P,3);
    x0, x1 (P,N,2); weights (P,N). A step is kept only where it lowers the
    cost, chosen by `torch.where`."""
    sqrt_w = torch.sqrt(weights)

    def residuals(p, a0, a1, sw):           # one pair: p (6,) -> (N,)
        return sw * _sampson_signed(_pose_to_E(p[:3], p[3:]), a0, a1)

    batched = torch.func.vmap(residuals)
    jacobian = torch.func.vmap(torch.func.jacfwd(residuals))
    p = torch.cat([wvec, t], -1)
    eye = damping * torch.eye(6, dtype=p.dtype, device=p.device)
    for _ in range(iters):
        J = outside_inference_mode(jacobian, p, x0, x1, sqrt_w)  # (P,N,6)
        r = batched(p, x0, x1, sqrt_w)      # (P,N)
        Jt = J.transpose(-1, -2)
        g = (Jt @ r[..., None])[..., 0]
        # solve_ex: a singular system gives non-finite numbers, not an
        # error; the comparison below then keeps p
        dp = torch.linalg.solve_ex(Jt @ J + eye, -g)[0]
        p_new = p + dp
        better = (batched(p_new, x0, x1, sqrt_w) ** 2).sum(-1) \
            < (r ** 2).sum(-1)
        p = torch.where(better[..., None], p_new, p)
    t_out = p[..., 3:] / torch.linalg.norm(p[..., 3:], dim=-1,
                                           keepdim=True).clamp_min(1e-12)
    return p[..., :3], t_out


def _recover_pose(E: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor,
                  w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cheirality-checked (R, t) from E (...,3,3) with weighted
    correspondences x0, x1 (...,N,2), w (...,N)."""
    u, _, vt = torch.linalg.svd(E)
    d = torch.linalg.det(u) * torch.linalg.det(vt)
    vt = vt * torch.sign(d)[..., None, None]  # make R proper
    W = torch.tensor([[0.0, -1, 0], [1, 0, 0], [0, 0, 1]], dtype=E.dtype,
                     device=E.device)
    Ra = u @ W @ vt
    Rb = u @ W.T @ vt
    t = u[..., :, 2]
    x0h, x1h = _homogeneous(x0), _homogeneous(x1)

    def count(R, tc):
        Rx0 = x0h @ R.transpose(-1, -2)
        a11 = (Rx0 * Rx0).sum(-1)
        a12 = -(Rx0 * x1h).sum(-1)
        a22 = (x1h * x1h).sum(-1)
        b1 = -(Rx0 @ tc[..., None])[..., 0]
        b2 = (x1h @ tc[..., None])[..., 0]
        det = a11 * a22 - a12 ** 2
        det = torch.where(det.abs() < 1e-18, torch.ones_like(det), det)
        d0 = (b1 * a22 - b2 * a12) / det
        d1 = (a11 * b2 - a12 * b1) / det
        return (w * ((d0 > 0) & (d1 > 0))).sum(-1)

    cands = [(Ra, t), (Ra, -t), (Rb, t), (Rb, -t)]
    counts = torch.stack([count(R, tc) for R, tc in cands], -1)
    best = torch.argmax(counts, dim=-1)
    Rs = torch.stack([c[0] for c in cands], -3)            # (...,4,3,3)
    ts = torch.stack([c[1] for c in cands], -2)            # (...,4,3)
    R = torch.gather(Rs, -3, best[..., None, None, None]
                     .expand(*best.shape, 1, 3, 3))[..., 0, :, :]
    tb = torch.gather(ts, -2, best[..., None, None]
                      .expand(*best.shape, 1, 3))[..., 0, :]
    return R, tb


def _draw_samples(valid: torch.Tensor, n_hypotheses: int,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
    """(P,N) bool -> (P,n_hypotheses,8) int64 indices: random 8-subsets
    without replacement by the Gumbel-top-k trick (sampling with
    replacement repeats rows within a minimal sample, a rank-deficient
    system whose null vector is an arbitrary E). Invalid rows are excluded
    by their logit. The uniforms are drawn on the generator's device and
    moved to the data's, so one CPU generator gives the same samples on
    any device."""
    if generator is None:
        generator = torch.Generator(device=valid.device).manual_seed(0)
    p, n = valid.shape
    u = torch.rand((p, n_hypotheses, n), generator=generator,
                   device=generator.device).to(valid.device)
    tiny = torch.finfo(u.dtype).tiny
    exponential = (-torch.log(u.clamp_min(tiny))).clamp_min(tiny)
    gumbel = -torch.log(exponential)
    logits = torch.where(valid, 0.0, -1e9)[:, None, :]
    return torch.topk(logits + gumbel, 8, dim=-1).indices


def _ransac_from_samples(x0: torch.Tensor, x1: torch.Tensor,
                         valid: torch.Tensor, samples: torch.Tensor,
                         thr_sq: torch.Tensor) -> RansacResult:
    """The estimator after the draw. x0, x1 (P,N,2) normalized; valid
    (P,N) bool; samples (P,Hyp,8) row indices; thr_sq (P,) squared
    inlier threshold in normalized units."""
    pairs = torch.arange(x0.shape[0], device=x0.device)
    rows = pairs[:, None, None]
    Es = _eight_point(x0[rows, samples], x1[rows, samples])  # (P,Hyp,3,3)

    thr = thr_sq[:, None, None]
    errs = _sampson_sq(Es, x0[:, None], x1[:, None])         # (P,Hyp,N)
    inl = (errs < thr) & valid[:, None]
    msac = torch.where(valid[:, None], torch.minimum(errs, thr),
                       torch.zeros_like(errs)).sum(-1)
    best = torch.argmin(msac, dim=1)

    # local optimization: cheirality-resolve the best E, Gauss-Newton on
    # (R, t) over its inliers, re-collect the inliers, refine once more
    w = inl[pairs, best].to(x0.dtype)
    R0, t0 = _recover_pose(Es[pairs, best], x0, x1, w)
    wvec, t = _refine_pose_sampson(so3_log(R0), t0, x0, x1, w)
    err = _sampson_sq(_pose_to_E(wvec, t), x0, x1)
    w = ((err < thr_sq[:, None]) & valid).to(x0.dtype)
    wvec, t = _refine_pose_sampson(wvec, t, x0, x1, w)

    E = _pose_to_E(wvec, t)
    inliers = (_sampson_sq(E, x0, x1) < thr_sq[:, None]) & valid
    return RansacResult(R=so3_exp(wvec), t=t, E=E, inliers=inliers,
                        num_inliers=inliers.sum(-1))


def ransac_essential_batch(p0: torch.Tensor, p1: torch.Tensor,
                           K0: torch.Tensor, K1: torch.Tensor,
                           valid: Optional[torch.Tensor] = None,
                           max_epipolar_error: float = 2.5,
                           n_hypotheses: int = 512,
                           generator: Optional[torch.Generator] = None
                           ) -> RansacResult:
    """Batched-hypothesis essential RANSAC over P pairs at once.

    p0, p1: (P,N,2) pixel correspondences (padded rows allowed via
    `valid` (P,N)); K0, K1 (P,3,3). Runs on the tensors' device. Returns a
    RansacResult with a leading P on every field; R, t in the world0 ->
    cam1 convention, |t| = 1."""
    if valid is None:
        valid = torch.ones(p0.shape[:2], dtype=torch.bool, device=p0.device)
    K0, K1 = K0.float(), K1.float()
    x0 = _normalize(p0.float(), K0)
    x1 = _normalize(p1.float(), K1)
    favg = (K0[:, 0, 0] + K0[:, 1, 1] + K1[:, 0, 0] + K1[:, 1, 1]) / 4.0
    thr_sq = (max_epipolar_error / favg) ** 2
    samples = _draw_samples(valid, n_hypotheses, generator)
    return _ransac_from_samples(x0, x1, valid, samples, thr_sq)


def ransac_essential(p0: torch.Tensor, p1: torch.Tensor, K0: torch.Tensor,
                     K1: torch.Tensor, valid: Optional[torch.Tensor] = None,
                     max_epipolar_error: float = 2.5,
                     n_hypotheses: int = 512,
                     generator: Optional[torch.Generator] = None
                     ) -> RansacResult:
    """One pair: p0, p1 (N,2), K (3,3), valid (N,)."""
    res = ransac_essential_batch(
        p0[None], p1[None], K0[None], K1[None],
        None if valid is None else valid[None], max_epipolar_error,
        n_hypotheses, generator)
    return RansacResult(*(f[0] for f in res))


def _pad_bucket(n: int) -> int:
    """Match counts rounded up to a power-of-two bucket, at least 256, as
    the JAX package pads them: a padded pair draws the samples of its
    bucket, whatever its own count."""
    b = 256
    while b < n:
        b *= 2
    return b


def estimate_relative_pose_gpu(pts0: np.ndarray, pts1: np.ndarray,
                               K0: np.ndarray, K1: np.ndarray,
                               max_epipolar_error: float = 2.5,
                               n_hypotheses: int = 512, seed: int = 0,
                               success_prob: float = 0.99999,
                               max_iters: int = 10_000,
                               device: Optional[Union[str, torch.device]]
                               = None):
    """Host contract of a relative-pose estimator: numpy pixel
    correspondences in, (R, t, inlier_mask) or None out. Runs the batched
    RANSAC on `device` (None: the GPU; raises when there is none).
    `success_prob` and `max_iters` are accepted for signature
    compatibility and unused: the hypothesis count is fixed."""
    from ..api import resolve_device
    dev = resolve_device(device)
    n = len(pts0)
    if n < 8:
        return None
    m = _pad_bucket(n)
    p0 = np.zeros((m, 2), np.float32)
    p1 = np.zeros((m, 2), np.float32)
    p0[:n] = np.asarray(pts0, np.float64)
    p1[:n] = np.asarray(pts1, np.float64)
    valid = np.zeros((m,), bool)
    valid[:n] = True
    res = ransac_essential(
        torch.from_numpy(p0).to(dev), torch.from_numpy(p1).to(dev),
        torch.from_numpy(np.asarray(K0, np.float32)).to(dev),
        torch.from_numpy(np.asarray(K1, np.float32)).to(dev),
        torch.from_numpy(valid).to(dev), max_epipolar_error,
        n_hypotheses, torch.Generator(device=dev).manual_seed(seed))
    if int(res.num_inliers) < 5:
        return None
    return (res.R.double().cpu().numpy(), res.t.double().cpu().numpy(),
            res.inliers.cpu().numpy()[:n])
