"""Bundle adjustment: Levenberg-Marquardt with the points eliminated by
the Schur complement and the reduced camera system solved matrix-free by
block-Jacobi preconditioned conjugate gradients (counterpart of the JAX
package's `sfm/ba.py`).

  * a fixed-shape observation table (obs_cam, obs_pt, obs_uv, obs_mask):
    ragged tracks become masked rows;
  * residuals and Jacobians by forward-mode differentiation of the
    projection, vectorized over the observations (`torch.func`);
  * S x = U x - W V^-1 W^T x evaluated observation by observation with
    segment sums, S never formed;
  * the segment sums are deterministic: each camera's and each point's
    observations are gathered through a padded table (`SegmentTables`,
    built once a solve) and summed in one fixed order, where `index_add_`
    on the card adds through float atomics in whatever order they land,
    and a solve's rounding, amplified by the LM loop, would differ from
    run to run. On the CPU a sum too large for one thread adds the
    table's columns in order, since torch would group its terms by the
    size of its thread pool;
  * every loop runs a fixed number of iterations with masked updates, so a
    solve on the card queues its work without waiting for the device: the
    only read-back before the caller reads the result is the two table
    widths, once a solve.

`reduce_cam` / `reduce_pt` are identity hooks through which a sharded
solver sums the partial camera- and point-space segment sums across
devices. Everything is float32; `bundle_adjust` keeps its matrix products
in full float32 on the card whatever the TF32 flag says
(`ops/precision.full_fp32_matmuls`).
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch.func import jacfwd, vmap

from ..ops.precision import full_fp32_matmuls
from .lie import outside_inference_mode, rotate

Reduce = Callable[[torch.Tensor], torch.Tensor]
# torch's at::internal::GRAIN_SIZE: a CPU reduction over fewer elements
# runs on one thread, whatever the pool's size
_CPU_PARALLEL_GRAIN = 32768


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


class BAProblem(NamedTuple):
    cams: torch.Tensor       # (C, 6) [angle-axis, t], world->cam
    points: torch.Tensor     # (P, 3)
    K: torch.Tensor          # (3, 3) shared intrinsics
    obs_cam: torch.Tensor    # (N,) int64
    obs_pt: torch.Tensor     # (N,) int64
    obs_uv: torch.Tensor     # (N, 2) pixel observations
    obs_mask: torch.Tensor   # (N,) bool
    fixed_cams: Optional[torch.Tensor] = None  # (C,) bool, gauge freeze

    def to(self, device) -> "BAProblem":
        """The same problem with every tensor on `device`."""
        return BAProblem(*(None if t is None else t.to(device)
                           for t in self))


def project(cam6: torch.Tensor, X: torch.Tensor,
            K: torch.Tensor) -> torch.Tensor:
    """World points (..., 3) -> pixels (..., 2) (pinhole, no distortion)."""
    Xc = rotate(cam6[..., :3], X) + cam6[..., 3:]
    z = Xc[..., 2].clamp_min(1e-6)
    u = K[0, 0] * Xc[..., 0] / z + K[0, 2]
    v = K[1, 1] * Xc[..., 1] / z + K[1, 2]
    return torch.stack([u, v], -1)


class SegmentTables(NamedTuple):
    """For each camera (point), the rows of its unmasked observations,
    padded with N (a zero row appended at gather time): (C, Wc), (P, Wp)."""
    cam: torch.Tensor
    pt: torch.Tensor


def _table(seg: torch.Tensor, n: int, width: int, order: torch.Tensor,
           starts: torch.Tensor) -> torch.Tensor:
    """(n, width): row s lists segment s's rows in index order, then N."""
    N = seg.shape[0]
    s = seg[order]
    rank = torch.arange(N, device=seg.device) - starts[s]
    # masked rows (segment n) all land in one dropped slot
    flat = torch.where(s < n, s * width + rank, n * width)
    table = torch.full((n * width + 1,), N, dtype=torch.int64,
                       device=seg.device)
    table[flat] = order
    return table[:n * width].view(n, width)


def segment_tables(p: "BAProblem") -> SegmentTables:
    """The gather tables of `p`'s camera and point segments. Masked
    observations are left out: their rows are zeros. Reads the two table
    widths back to the host (one sync)."""
    C, P = p.cams.shape[0], p.points.shape[0]
    parts = []
    for seg, n in ((p.obs_cam, C), (p.obs_pt, P)):
        seg = torch.where(p.obs_mask, seg, n)      # masked -> segment n
        counts = torch.zeros(n + 1, dtype=torch.int64, device=seg.device)
        counts.index_add_(0, seg, torch.ones_like(seg))  # exact in ints
        order = torch.argsort(seg, stable=True)
        parts.append((seg, n, order, torch.cumsum(counts, 0) - counts,
                      counts[:n].max() if n else counts[:1]))
    widths = torch.stack([w for *_, w in parts]).tolist()
    return SegmentTables(*(_table(seg, n, w, order, starts)
                           for (seg, n, order, starts, _), w
                           in zip(parts, widths)))


def _segment_sum(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Row sums of x over each table row. One `sum(1)` where its order is
    fixed: on the card, and on the CPU below torch's parallel grain, where
    a reduction runs on one thread. Above it the CPU would group the terms
    by the thread pool's size, and the LM loop grows that rounding into
    another solution, so the table's columns are added one at a time, in
    the table's order (the JAX package's `segment_sum` order): the same
    bits on any pool."""
    xe = torch.cat([x, x.new_zeros((1,) + x.shape[1:])])
    g = xe[table]
    if g.device.type != "cpu" or g.numel() < _CPU_PARALLEL_GRAIN:
        return g.sum(1)
    acc = torch.zeros_like(g[:, 0])
    for col in g.unbind(1):
        acc += col
    return acc


def _residuals(p: BAProblem) -> torch.Tensor:
    """Masked per-observation residuals (N, 2)."""
    r = project(p.cams[p.obs_cam], p.points[p.obs_pt], p.K) - p.obs_uv
    return torch.where(p.obs_mask[:, None], r, 0.0)


def _projection_jacobians(cams_g: torch.Tensor, pts_g: torch.Tensor,
                          K: torch.Tensor):
    return vmap(jacfwd(lambda c, x: project(c, x, K),
                       argnums=(0, 1)))(cams_g, pts_g)


def residuals_and_jacobians(p: BAProblem):
    """Per-observation residual (N,2), J_cam (N,2,6), J_pt (N,2,3); inside
    `torch.inference_mode()` too (`lie.outside_inference_mode`)."""
    Jc, Jp = outside_inference_mode(_projection_jacobians,
                                    p.cams[p.obs_cam], p.points[p.obs_pt],
                                    p.K)
    m = p.obs_mask[:, None, None]
    Jc = torch.where(m, Jc, 0.0)
    Jp = torch.where(m, Jp, 0.0)
    if p.fixed_cams is not None:
        Jc = torch.where(p.fixed_cams[p.obs_cam][:, None, None], 0.0, Jc)
    return _residuals(p), Jc, Jp


def _inv3(M: torch.Tensor) -> torch.Tensor:
    """Batched closed-form 3x3 inverse."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    det = torch.where(det.abs() < 1e-12, 1e-12, det)
    adj = torch.stack([
        torch.stack([A, -(b * i - c * h), (b * f - c * e)], -1),
        torch.stack([B, (a * i - c * g), -(a * f - c * d)], -1),
        torch.stack([C, -(a * h - b * g), (a * e - b * d)], -1),
    ], -2)
    return adj / det[..., None, None]


def build_normal_blocks(p: BAProblem, lam, reduce_cam: Reduce = _identity,
                        reduce_pt: Reduce = _identity,
                        tables: Optional[SegmentTables] = None):
    """Per-camera U (C,6,6), per-point V^-1 (P,3,3), the gradients b_c,
    b_p, the per-observation coupling blocks W_i = J_c^T J_p (N,6,3) and
    the cost. `tables`: `segment_tables(p)`, built here when not given."""
    tc, tp = tables or segment_tables(p)
    r, Jc, Jp = residuals_and_jacobians(p)
    U = reduce_cam(_segment_sum(torch.einsum("nri,nrj->nij", Jc, Jc), tc))
    V = reduce_pt(_segment_sum(torch.einsum("nri,nrj->nij", Jp, Jp), tp))
    b_c = -reduce_cam(_segment_sum(torch.einsum("nri,nr->ni", Jc, r), tc))
    b_p = -reduce_pt(_segment_sum(torch.einsum("nri,nr->ni", Jp, r), tp))
    U = U + lam * torch.eye(6, device=U.device)
    V = V + lam * torch.eye(3, device=V.device)
    W = torch.einsum("nri,nrj->nij", Jc, Jp)
    cost = reduce_cam(0.5 * (r ** 2).sum())
    return U, _inv3(V), W, b_c, b_p, cost


def schur_matvec(x: torch.Tensor, U, Vinv, W, obs_cam, obs_pt,
                 tables: SegmentTables, reduce_cam: Reduce = _identity,
                 reduce_pt: Reduce = _identity) -> torch.Tensor:
    """S x = U x - W V^-1 W^T x, observation by observation.
    x: (C, 6) camera-space vector -> (C, 6)."""
    Ux = torch.einsum("cij,cj->ci", U, x)
    wtx = torch.einsum("nji,nj->ni", W, x[obs_cam])
    z = reduce_pt(_segment_sum(wtx, tables.pt))
    z = torch.einsum("pij,pj->pi", Vinv, z)
    wz = torch.einsum("nij,nj->ni", W, z[obs_pt])
    return Ux - reduce_cam(_segment_sum(wz, tables.cam))


def _vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum()


def cg_solve(matvec, b: torch.Tensor, iters: int = 50,
             precond_mv=None) -> torch.Tensor:
    """(Preconditioned) conjugate gradients on a PSD operator, a fixed
    number of iterations with masked updates.

    An iteration stops changing x once ||r|| is down to 1e-5 of its start:
    past that, iterations only walk the near-null gauge directions where
    the cost is flat, and a strong preconditioner strides along them,
    drifting the solution at equal cost and amplifying reduction-order
    noise. `precond_mv`: z = M^-1 r, or None for plain CG."""
    ident = _identity if precond_mv is None else precond_mv
    x = torch.zeros_like(b)
    r = b
    z = ident(r)
    pv = z
    rz = _vdot(r, z)
    rr0 = _vdot(r, r)
    for _ in range(iters):
        live = _vdot(r, r) > (1e-5 ** 2) * rr0
        Ap = matvec(pv)
        denom = _vdot(pv, Ap)
        alpha = torch.where(live & (denom.abs() > 1e-20), rz / denom, 0.0)
        x = x + alpha * pv
        r = r - alpha * Ap
        z = ident(r)
        rz_new = _vdot(r, z)
        beta = torch.where(live & (rz.abs() > 1e-20), rz_new / rz, 0.0)
        pv = torch.where(live, z + beta * pv, pv)
        rz = torch.where(live, rz_new, rz)
    return x


def ba_step(p: BAProblem, lam, cg_iters: int = 50,
            reduce_cam: Reduce = _identity, reduce_pt: Reduce = _identity,
            precond: bool = True, tables: Optional[SegmentTables] = None
            ) -> Tuple[BAProblem, torch.Tensor]:
    """One LM step: Schur-eliminate the points, block-Jacobi preconditioned
    CG on the camera system, back-substitute the points."""
    tables = tables or segment_tables(p)
    U, Vinv, W, b_c, b_p, cost = build_normal_blocks(p, lam, reduce_cam,
                                                     reduce_pt, tables)
    # rhs = b_c - W V^-1 b_p
    vb = torch.einsum("pij,pj->pi", Vinv, b_p)
    wvb = torch.einsum("nij,nj->ni", W, vb[p.obs_pt])
    rhs = b_c - reduce_cam(_segment_sum(wvb, tables.cam))

    mv = functools.partial(schur_matvec, U=U, Vinv=Vinv, W=W,
                           obs_cam=p.obs_cam, obs_pt=p.obs_pt,
                           tables=tables, reduce_cam=reduce_cam,
                           reduce_pt=reduce_pt)
    pc_mv = None
    if precond:
        # block-Jacobi with the true diagonal blocks of S: with at most
        # one observation per (camera, point) pair, S_cc = U_c - sum over
        # the camera's observations of W_i V^-1 W_i^T. Fixed cameras
        # reduce to lam*I, invertible; their dc is zeroed below.
        wvw = torch.einsum("nij,njk,nlk->nil", W, Vinv[p.obs_pt], W)
        S_diag = U - reduce_cam(_segment_sum(wvw, tables.cam))
        Minv = torch.linalg.inv_ex(S_diag)[0]  # no error check: no sync

        def pc_mv(r):
            return torch.einsum("cij,cj->ci", Minv, r)
    dc = cg_solve(mv, rhs, cg_iters, precond_mv=pc_mv)

    # dp = V^-1 (b_p - W^T dc)
    wtdc = reduce_pt(_segment_sum(
        torch.einsum("nji,nj->ni", W, dc[p.obs_cam]), tables.pt))
    dp = torch.einsum("pij,pj->pi", Vinv, b_p - wtdc)
    if p.fixed_cams is not None:
        dc = torch.where(p.fixed_cams[:, None], 0.0, dc)
    return p._replace(cams=p.cams + dc, points=p.points + dp), cost


def ba_cost(p: BAProblem, reduce_cam: Reduce = _identity) -> torch.Tensor:
    return reduce_cam(0.5 * (_residuals(p) ** 2).sum())


def bundle_adjust(p: BAProblem, iters: int = 20, lam0: float = 1e-3,
                  cg_iters: int = 50, reduce_fn: Optional[Reduce] = None,
                  reduce_cam: Optional[Reduce] = None,
                  reduce_pt: Optional[Reduce] = None, precond: bool = True
                  ) -> Tuple[BAProblem, Dict[str, torch.Tensor]]:
    """LM with multiplicative damping (a step is kept when it lowers the
    cost), on the device of `p`'s tensors. Returns the solved problem and
    0-d tensors initial_cost, final_cost, final_lambda.

    `reduce_fn` applies one reduction to both camera- and point-space
    accumulators; `reduce_cam` / `reduce_pt` set them independently."""
    reduce_cam = reduce_cam or reduce_fn or _identity
    reduce_pt = reduce_pt or reduce_fn or _identity
    tables = segment_tables(p)
    with full_fp32_matmuls():
        cost0 = ba_cost(p, reduce_cam)
        cost = cost0
        lam = torch.full((), lam0, dtype=torch.float32, device=p.cams.device)
        for _ in range(iters):
            p_new, _ = ba_step(p, lam, cg_iters, reduce_cam, reduce_pt,
                               precond, tables)
            cost_new = ba_cost(p_new, reduce_cam)
            accept = cost_new < cost
            p = p._replace(cams=torch.where(accept, p_new.cams, p.cams),
                           points=torch.where(accept, p_new.points,
                                              p.points))
            lam = torch.where(accept, (lam * 0.5).clamp_min(1e-8),
                              (lam * 4.0).clamp_max(1e3))
            cost = torch.where(accept, cost_new, cost)
    return p, {"initial_cost": cost0, "final_cost": cost,
               "final_lambda": lam}


def reprojection_rmse(p: BAProblem) -> torch.Tensor:
    r = _residuals(p)
    n = p.obs_mask.sum().clamp_min(1)
    return torch.sqrt((r ** 2).sum() / (2 * n))
